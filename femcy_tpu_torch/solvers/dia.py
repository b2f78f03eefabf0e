"""DIA (diagonal-offset) sparse format: pattern, SpMV, Dirichlet, PCG.

Torch counterpart of ``femcy_tpu.solvers.dia``.  A matrix whose dof graph
has a bounded set of distinct (col - row) offsets is stored by offset:

    A[r, r + off_k] = values[r, k]        k = 0..K-1, offsets static

and y = A x is K statically shifted slices of x.  ``dia_spmv`` here is the
plain torch version of that SpMV; the CG on a CUDA device runs the
hand-written kernel instead (kernels/dia_spmv.py), passed in as ``spmv``.
Two patterns exist: the analytic one of a structured box
(``build_structured_dia_pattern``) and the general one derived from a
mesh's ELL pattern (``build_dia_pattern``), whose assembly scatters into
the DIA slots through kernels/ell_scatter.py (``dia_scatter`` here is
femcy_tpu's plain form of that scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from femcy_tpu_torch.linalg import det_small, inv_small
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.topology import ELLPattern, build_pattern
from femcy_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class DIAPattern:
    n_dof: int
    #: static, sorted distinct column offsets (K,)
    offsets: Tuple[int, ...]
    #: index of offset 0 (the diagonal) in ``offsets``
    diag_idx: int
    #: scatter map: contribution (Ke layout order) -> flat (row * K + k)
    #: slot; None until requested (:meth:`ensure_scatter_targets`), and
    #: always None for the analytic structured pattern (its assembly writes
    #: by offset and never scatters)
    scatter_targets: Optional[np.ndarray] = None
    #: the ELL pattern a general pattern was derived from
    ell: Optional[ELLPattern] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    def ensure_scatter_targets(self) -> np.ndarray:
        """The dof-level scatter map into the DIA slots, derived from the
        ELL pattern's on first use.  Only the plain ``dia_scatter`` reads
        it; the device assembly goes through kernels/ell_scatter's
        row-band plan."""
        if self.scatter_targets is None:
            if self.ell is None:
                raise ValueError("pattern has no scatter map (structured)")
            targets = ell_to_dia_slots(self.ell, self.offsets)[
                self.ell.ensure_scatter_targets()]
            dtype = np.int32 if self.n_dof * self.n_offsets < 2**31 else np.int64
            object.__setattr__(self, "scatter_targets", targets.astype(dtype))
        return self.scatter_targets

    @property
    def pad_lo(self) -> int:
        return max(0, -min(self.offsets))

    @property
    def pad_hi(self) -> int:
        return max(0, max(self.offsets))

    def to_scipy(self, values: np.ndarray):
        """DIA values -> scipy CSR, via scipy's native dia_matrix.

        scipy stores diagonal k by COLUMN (data[k, c] = A[c - off_k, c]);
        ours is by row (values[r, k] = A[r, r + off_k]), so each diagonal is
        one shifted copy.
        """
        import scipy.sparse as sp

        vals = np.asarray(values)
        n = self.n_dof
        data = np.zeros((self.n_offsets, n), dtype=vals.dtype)
        for k, off in enumerate(self.offsets):
            if off >= 0:
                data[k, off:] = vals[: n - off, k]
            else:
                data[k, : n + off] = vals[-off:, k]
        return sp.csr_matrix(
            sp.dia_matrix((data, np.asarray(self.offsets)), shape=(n, n))
        )


def build_structured_dia_pattern(mesh: FEMesh) -> DIAPattern:
    """Analytic DIA pattern for a structured box_tets mesh, straight from
    the repeating Kuhn stencil (O(1) work; no element pass).

    The offset set equals the general ELL-derived pattern's because every
    node-coordinate delta the Kuhn subdivision produces occurs at some
    interior node (grids >= 2 cells per axis).
    """
    info = mesh.structure
    if info is None or info.get("kind") != "box_tets":
        raise ValueError("build_structured_dia_pattern needs a box_tets mesh")
    ny, nz = info["ny"], info["nz"]
    dm = mesh.dm
    sx, sy = (ny + 1) * (nz + 1), nz + 1

    corner = np.asarray(info["corner_delta"])  # (8, 3)
    deltas = []
    for corners in info["kuhn"]:
        d = corner[list(corners)]  # (4, 3)
        deltas.append((d[None, :, :] - d[:, None, :]).reshape(-1, 3))
    node_deltas = np.unique(np.concatenate(deltas), axis=0)

    node_off = node_deltas[:, 0] * sx + node_deltas[:, 1] * sy + node_deltas[:, 2]
    comp = np.arange(dm)
    offsets = np.unique(
        (node_off[:, None, None] * dm + (comp[None, None, :] - comp[None, :, None]))
    )
    diag_idx = int(np.searchsorted(offsets, 0))
    return DIAPattern(
        n_dof=mesh.n_dof,
        offsets=tuple(int(o) for o in offsets),
        diag_idx=diag_idx,
    )


def ell_to_dia_columns(ell: ELLPattern, offsets, dtype=np.int64) -> np.ndarray:
    """(n_dof * width,) ``dtype``: the DIA column k (the index of its
    (col - row) in ``offsets``) of each flat ELL slot, -1 on padding
    slots.  ``offsets`` must hold every (col - row) of the ELL pattern."""
    offsets = np.asarray(offsets, dtype=np.int64)
    rows = np.repeat(np.arange(ell.n_dof, dtype=np.int64), ell.row_counts)
    cols = np.full(ell.n_dof * ell.width, -1, dtype=dtype)
    cols[ell.csr_slots] = np.searchsorted(
        offsets, ell.csr_indices.astype(np.int64) - rows)
    return cols


def ell_to_dia_slots(ell: ELLPattern, offsets) -> np.ndarray:
    """(n_dof * width,) int64: the flat DIA slot (row * K + k) of each flat
    ELL slot, -1 on padding slots.  ``offsets`` must hold every (col - row)
    of the ELL pattern."""
    ell2dia = ell_to_dia_columns(ell, offsets)
    slots = ell.csr_slots.astype(np.int64)
    ell2dia[slots] += (slots // ell.width) * len(offsets)
    return ell2dia


def build_dia_pattern(
    mesh: FEMesh, max_offsets: int = 1024, ell: Optional[ELLPattern] = None
) -> Optional[DIAPattern]:
    """DIA pattern of a mesh from its ELL pattern, or None when the offset
    set is larger than ``max_offsets``.  Its scatter map is left to
    ``DIAPattern.ensure_scatter_targets``."""
    ell = ell if ell is not None else build_pattern(mesh)
    n_dof = ell.n_dof
    rows = np.repeat(np.arange(n_dof), ell.row_counts)
    offsets = np.unique(ell.csr_indices.astype(np.int64) - rows)
    if offsets.shape[0] > max_offsets:
        return None
    diag_idx = int(np.searchsorted(offsets, 0))
    if offsets[diag_idx] != 0:
        return None  # a dof without a diagonal entry; shouldn't happen
    return DIAPattern(
        n_dof=n_dof,
        offsets=tuple(int(o) for o in offsets),
        diag_idx=diag_idx,
        ell=ell,
    )


# --------------------------------------------------------------------------- #
def dia_scatter(Ke, scatter_targets, n_dof: int, n_offsets: int):
    """Element stiffness (E, edof, edof) -> DIA values (n_dof, K) by one
    indexed add in contribution order over
    ``DIAPattern.ensure_scatter_targets()`` (femcy_tpu's dia_scatter)."""
    flat = Ke.new_zeros(n_dof * n_offsets)
    flat.index_add_(0, scatter_targets, Ke.reshape(-1))
    return flat.reshape(n_dof, n_offsets)


def _shifted_columns(v, offsets: Tuple[int, ...]):
    """(n,) -> (n, K) with column k = v[r + off_k] (0 / False outside)."""
    n = v.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    vpad = torch.cat([v.new_zeros(pad_lo), v, v.new_zeros(pad_hi)])
    return torch.stack(
        [vpad[pad_lo + off : pad_lo + off + n] for off in offsets], dim=1
    )


def dia_spmv(values, offsets: Tuple[int, ...], x):
    """y = A @ x with statically shifted slices: the plain version of the
    DIA SpMV kernel (kernels/dia_spmv.py), summing the K diagonals in
    offset order."""
    n = x.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    xpad = torch.cat([x.new_zeros(pad_lo), x, x.new_zeros(pad_hi)])
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + values[:, k] * xpad[pad_lo + off : pad_lo + off + n]
    return y


def dia_spmv_window(values, offsets: Tuple[int, ...], x_ext, base: int):
    """y = A @ x over a window of a longer vector: ``y[r] = sum_k
    values[r, k] * x_ext[base + r + off_k]`` for the (n, K) rows of
    ``values``, summed in offset order from zero -- the slab's halo SpMV
    (femcy_tpu.parallel.structured._spmv_local) and the plain version of
    the windowed DIA SpMV kernel (kernels/dia_spmv.spmv_window).  Every
    column must lie in ``x_ext``."""
    n = values.shape[0]
    if base + min(offsets) < 0 or base + max(offsets) + n > x_ext.shape[0]:
        raise ValueError(
            f"window base {base} with offsets [{min(offsets)}, "
            f"{max(offsets)}] over {n} rows leaves x_ext "
            f"({x_ext.shape[0]},)")
    y = x_ext.new_zeros(n)
    for k, off in enumerate(offsets):
        y = y + values[:, k] * x_ext[base + off : base + off + n]
    return y


def dia_dirichlet_linear(values, offsets: Tuple[int, ...], diag_idx: int,
                         rhs, fixed, sval):
    """Symmetric zero-one elimination on the DIA layout: prescribed-value
    couplings move to the rhs, fixed rows and columns are zeroed and their
    diagonal set to 1 (same math as femcy_tpu.bc.apply_dirichlet_linear,
    with ``fixed[col]``/``sval[col]`` realised as static shifts).

    Returns new (values, rhs); the inputs are not modified.
    """
    col_fixed = _shifted_columns(fixed, offsets)
    col_sval = _shifted_columns(sval, offsets)
    zero = values.new_zeros(())
    rhs = rhs - torch.where(col_fixed, values * col_sval, zero).sum(dim=1)
    rhs = torch.where(fixed, sval, rhs)
    values = torch.where(col_fixed | fixed[:, None], zero, values)
    values[:, diag_idx] = torch.where(
        fixed, values.new_ones(()), values[:, diag_idx]
    )
    return values, rhs


def dia_dirichlet_newton(values, offsets: Tuple[int, ...], diag_idx: int,
                         residual, fixed):
    """Newton-path Dirichlet treatment on the DIA layout (same math as
    bc.apply_dirichlet_newton: residual rows zeroed, fixed rows and columns
    zeroed, unit diagonal).  Returns new (values, residual)."""
    col_fixed = _shifted_columns(fixed, offsets)
    zero = values.new_zeros(())
    residual = torch.where(fixed, zero, residual)
    values = torch.where(col_fixed | fixed[:, None], zero, values)
    values[:, diag_idx] = torch.where(
        fixed, values.new_ones(()), values[:, diag_idx]
    )
    return values, residual


def block_jacobi_inverse(values, offsets: Tuple[int, ...], dm: int):
    """Inverse of the per-node dm x dm diagonal blocks -> (n_nodes, dm, dm).

    In the DIA layout the (dm*n+i, dm*n+j) block entry sits at column offset
    (j - i), so the block diagonal is dm^2 column picks.  Singular blocks
    (from Dirichlet-eliminated rows mixing with free ones) fall back to their
    scalar diagonal.
    """
    n = values.shape[0]
    off_to_k = {off: k for k, off in enumerate(offsets)}
    rows = values.reshape(n // dm, dm, values.shape[1])
    block = torch.stack(
        [
            torch.stack([rows[:, i, off_to_k[j - i]] for j in range(dm)], dim=-1)
            for i in range(dm)
        ],
        dim=-2,
    )  # (n_nodes, dm, dm)
    det = det_small(block)
    safe = det.abs() > 1e-30
    eye = torch.eye(dm, dtype=values.dtype, device=values.device)
    block_safe = torch.where(safe[:, None, None], block, eye)
    inv = inv_small(block_safe)
    # fallback: scalar Jacobi on the diagonal
    diag = block.diagonal(dim1=-2, dim2=-1)
    scalar = torch.where(diag != 0.0, 1.0 / diag, torch.zeros_like(diag))
    return torch.where(safe[:, None, None], inv, scalar[:, :, None] * eye)


def dia_pcg_solve(values, offsets: Tuple[int, ...], diag_idx: int, b,
                  eps: float = 1.0e-3, max_iters: int = 0,
                  block_dm: int = 0, spmv=None):
    """Preconditioned CG on the DIA operator.

    The same iteration and stopping rule as femcy_tpu.solvers.dia
    .dia_pcg_solve (``pcg`` below); ``max_iters <= 0`` means n.

    block_dm > 0 uses the block-Jacobi preconditioner with dm x dm node
    blocks; 0 keeps the reference's scalar Jacobi
    (conjugateGradientSolver.py:48-51).

    spmv: optional (prep, apply) pair (kernels.dia_spmv.make_spmv) replacing
    the plain shifted-slice SpMV; ``prep(values)`` runs once per solve.

    Returns (x, iterations, max|r|).
    """
    n = b.shape[0]
    if max_iters <= 0:
        max_iters = n
    if spmv is not None:
        prep, apply_fn = spmv
        operand = prep(values)

        def apply_a(d):
            return apply_fn(operand, d)

    else:
        def apply_a(d):
            return dia_spmv(values, offsets, d)

    if block_dm > 0:
        binv = block_jacobi_inverse(values, offsets, block_dm)

        def apply_m(r):
            return torch.einsum(
                "nij,nj->ni", binv, r.reshape(-1, block_dm)
            ).reshape(-1)

    else:
        diag = values[:, diag_idx]
        minv = torch.where(diag != 0.0, 1.0 / diag, torch.zeros_like(diag))

        def apply_m(r):
            return minv * r

    return pcg(apply_a, apply_m, b, eps, max_iters)


def pcg(apply_a, apply_m, b, eps: float, max_iters: int):
    """Preconditioned CG from x0 = 0 with operator ``apply_a`` and
    preconditioner ``apply_m``: iterate while ``k < max_iters`` and
    ``max|r| >= eps * max|b|``, not at all when b = 0 (femcy_tpu's
    stopping rule).  The loop runs on the host; each iteration reads one
    scalar back for the stopping test.  Returns (x, iterations, max|r|).

    Under a profile the solve is the span "femcy.pcg", each iteration with
    the stopping test that follows it "femcy.pcg.iter", and each
    ``apply_m`` "femcy.pcg.precond"; the two inner ranges are made once a
    solve and entered again each iteration.
    """
    it, pre = span("femcy.pcg.iter"), span("femcy.pcg.precond")
    with span("femcy.pcg"):
        x = torch.zeros_like(b)
        r = b
        with pre:
            d = apply_m(r)
        rmr = torch.dot(r, d)
        rmax0 = r.abs().max()
        thresh = eps * rmax0
        k = 0
        go = (bool(rmax0 > 0.0) and k < max_iters
              and bool(r.abs().max() >= thresh))
        while go:
            with it:
                Ad = apply_a(d)
                alpha = rmr / torch.dot(d, Ad)
                x = x + alpha * d
                r = r - alpha * Ad
                with pre:
                    z = apply_m(r)
                rmr_new = torch.dot(r, z)
                d = z + (rmr_new / rmr) * d
                rmr = rmr_new
                k += 1
                go = k < max_iters and bool(r.abs().max() >= thresh)
        return x, k, r.abs().max()
