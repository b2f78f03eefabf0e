"""General-mesh sharding: RCM + block-tridiagonal row slabs.

Torch counterpart of ``femcy_tpu.parallel.banded``:

- **Host setup.**  Reverse-Cuthill-McKee on the dof graph bounds the
  bandwidth ``bw``; rows are cut into blocks of ``B >= bw`` dofs, so every
  matrix entry lands in the block diagonal, the first block subdiagonal or
  the first block superdiagonal: three dense (nb, B, B) arrays hold the
  operator.  ``rcm_permutation``, ``build_banded_operands`` and
  ``build_coarse_basis`` are femcy_tpu's, in numpy, array for array.
- **Sharding.**  Each shard owns ``nbl`` consecutive row blocks.  Elements
  go to the shard of their smallest row block; one block-row halo-add
  after assembly and one x-block copy per neighbour per SpMV are the only
  exchanges between shards.
- **Assembly.**  Each shard's element entries go into its local
  (nbl + 1, 3, B, B) buffer, halo row block included, and its forces into
  (nbl + 1) * B rows, by M8 (kernels/btd_scatter.py), a plan per shard
  and per kind; then the halo-add.
- **CG.**  The SpMV is three batched products a shard (``torch.matmul``);
  the preconditioners are femcy_tpu's: ``twolevel`` (the default: the
  shard-local block-Thomas solve plus a global rigid-body-mode coarse
  correction), ``tridiag`` (the local solve alone), ``block`` (block
  Jacobi) and ``jacobi``.  The Thomas factor and sweeps are loops over
  the blocks, batched over the shards of a device; the factor and the
  coarse ``Ac^-1`` are made once per increment (``new_increment``).
- **Element work** (gradients, stress, Ke, forces) runs once a device,
  on its shards' elements concatenated in shard order; each shard's part
  then goes through its own scatter.

One process drives every shard (``parallel/shards.py``): a psum is the sum
of the shards' parts in shard order on the first shard's device, a
ppermute a copy between the shards' tensors.  femcy_tpu's zero-weighted
padded elements are left out of the device work: their Ke and forces are
exactly 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly
from femcy_tpu_torch.kernels import btd_scatter
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.parallel.shards import (
    Blocks,
    gather,
    pmax,
    psum,
    shard_devices,
    to,
)
from femcy_tpu_torch.topology import build_pattern

PRECONDITIONERS = ("twolevel", "tridiag", "block", "jacobi")


@dataclasses.dataclass
class BandedOperands:
    """Host-built static data for a block-tridiagonal sharded solve."""

    n_devices: int
    n_dof: int
    B: int  # block size (>= RCM bandwidth)
    nb: int  # row blocks covering n_dof
    nbl: int  # row blocks per device (nb padded to D * nbl)
    perm: np.ndarray  # (n_dof,) original dof of permuted slot i
    iperm: np.ndarray  # (n_dof,) permuted slot of original dof j
    # stacked per-device arrays (leading axis = device)
    elements: np.ndarray  # (D, E_s, n) padded element shards
    ele_weight: np.ndarray  # (D, E_s)
    scatter_targets: np.ndarray  # (D, E_s*edof^2) into (nbl+1)*3*B*B
    force_targets: np.ndarray  # (D, E_s*edof) into (nbl+1)*B local rows
    nodes: np.ndarray
    dshape_gp: np.ndarray
    weights_gp: np.ndarray
    C: np.ndarray

    @property
    def rows_local(self) -> int:
        return self.nbl * self.B


def rcm_permutation(pattern) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of the dof graph (host, scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = sp.csr_matrix(
        (
            np.ones_like(pattern.csr_indices, dtype=np.float32),
            pattern.csr_indices,
            pattern.csr_indptr,
        ),
        shape=(pattern.n_dof, pattern.n_dof),
    )
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def build_banded_operands(
    mesh: FEMesh,
    material: Material,
    n_devices: int,
    block: Optional[int] = None,
    pattern=None,
) -> BandedOperands:
    """femcy_tpu's operands; ``pattern`` reuses a built ELL pattern."""
    if pattern is None:
        pattern = build_pattern(mesh)
    n_dof = pattern.n_dof
    D = n_devices
    perm = rcm_permutation(pattern)
    iperm = np.empty(n_dof, dtype=np.int64)
    iperm[perm] = np.arange(n_dof)

    # permuted bandwidth from the ELL structure
    rows = np.repeat(np.arange(n_dof), pattern.row_counts)
    prow = iperm[rows]
    pcol = iperm[pattern.csr_indices.astype(np.int64)]
    bw = int(np.abs(pcol - prow).max())
    if block is None:
        block = max(8, -(-(bw) // 8) * 8)  # round up to a multiple of 8
    if block < bw:
        raise ValueError(f"block {block} smaller than the RCM bandwidth {bw}")
    B = block
    nb = -(-n_dof // B)
    nbl = -(-nb // D)

    # --- element shards by smallest permuted row --------------------------
    dm = mesh.dm
    edof = mesh.element.edof
    E = mesh.n_elements
    ele_dofs = (
        mesh.elements.astype(np.int64)[:, :, None] * dm + np.arange(dm)
    ).reshape(E, edof)
    ele_prows = iperm[ele_dofs]  # (E, edof)
    min_block = ele_prows.min(axis=1) // B
    dev_of_ele = np.minimum(min_block // nbl, D - 1).astype(np.int64)

    counts = np.bincount(dev_of_ele, minlength=D)
    E_s = int(counts.max())
    order = np.argsort(dev_of_ele, kind="stable")

    elements_sh = np.zeros((D, E_s, mesh.element.n_nodes), dtype=np.int32)
    weight_sh = np.zeros((D, E_s))
    targets_sh = np.zeros((D, E_s * edof * edof), dtype=np.int64)
    ftargets_sh = np.zeros((D, E_s * edof), dtype=np.int64)

    # per-entry block-tridiagonal slots: entry (prow r, pcol c) of an element
    # owned by device d lands in local row block Il = r//B - d*nbl in
    # [0, nbl] (min-row assignment + B >= bw guarantee the +1 halo row block
    # suffices), band position J - I + 1 in {0, 1, 2}
    for d in range(D):
        sel = order[counts[:d].sum() : counts[: d + 1].sum()]
        ne = sel.shape[0]
        elements_sh[d, :ne] = mesh.elements[sel]
        # padding uses element 0's (valid) geometry with zero weight: its Ke
        # is exactly zero, and its zeroed targets add 0 to local slot 0
        elements_sh[d, ne:] = mesh.elements[0]
        weight_sh[d, :ne] = 1.0
        pr = ele_prows[sel]  # (ne, edof)
        r = pr[:, :, None]
        c = pr[:, None, :]
        I = r // B  # noqa: E741
        J = c // B
        Il = I - d * nbl
        band = J - I + 1
        assert (Il >= 0).all() and (Il <= nbl).all()
        assert (band >= 0).all() and (band <= 2).all()
        flat = ((Il * 3 + band) * B + r % B) * B + (c - J * B)
        targets_sh[d, : ne * edof * edof] = flat.reshape(-1)
        # force rows: same local row block + in-block offset, vector layout
        ftargets_sh[d, : ne * edof] = (
            (pr // B - d * nbl) * B + pr % B
        ).reshape(-1)

    return BandedOperands(
        n_devices=D,
        n_dof=n_dof,
        B=B,
        nb=nb,
        nbl=nbl,
        perm=perm,
        iperm=iperm,
        elements=elements_sh,
        ele_weight=weight_sh,
        scatter_targets=targets_sh,
        force_targets=ftargets_sh,
        nodes=mesh.nodes,
        dshape_gp=mesh.element.dshape_at_gp,
        weights_gp=mesh.element.gauss_weights,
        C=material.C,
    )


def build_coarse_basis(ops, nodes, dm: int) -> np.ndarray:
    """Host prep: per-block rigid-body modes in banded dof order ->
    (D, nbl, B, nc) with nc = 6 (3D: tx ty tz rx ry rz) or 3 (2D: tx ty
    rz).  Rotations are centered at each block's node centroid for
    conditioning.  Rows of padded positions stay zero; fixed-dof rows are
    masked later on device (the mask is a per-solve input)."""
    D, nbl, B = ops.n_devices, ops.nbl, ops.B
    nc = 6 if dm == 3 else 3
    Z = np.zeros((D * nbl * B, nc))
    p = np.arange(ops.n_dof)
    od = ops.perm  # banded position i <-> original dof ops.perm[i]
    node = od // dm
    comp = od % dm
    xyz = nodes[node].astype(np.float64)  # (n_dof, dm)
    blk = p // B
    # per-block centroid over live positions
    cent = np.zeros((D * nbl, dm))
    cnt = np.bincount(blk, minlength=D * nbl).astype(np.float64)
    for d in range(dm):
        cent[:, d] = np.bincount(blk, weights=xyz[:, d], minlength=D * nbl)
    cent /= np.maximum(cnt, 1.0)[:, None]
    rel = xyz - cent[blk]
    Z[p, comp] = 1.0  # translations
    if dm == 3:
        x, y, z = rel[:, 0], rel[:, 1], rel[:, 2]
        # r_x = (0, -z, y), r_y = (z, 0, -x), r_z = (-y, x, 0)
        rot = np.stack(
            [
                np.stack([np.zeros_like(x), -z, y], axis=1),
                np.stack([z, np.zeros_like(x), -x], axis=1),
                np.stack([-y, x, np.zeros_like(x)], axis=1),
            ],
            axis=1,
        )  # (n_dof, 3 rot modes, 3 comps)
        for rr in range(3):
            Z[p, 3 + rr] = rot[np.arange(len(p)), rr, comp]
    else:
        x, y = rel[:, 0], rel[:, 1]
        rz = np.stack([-y, x], axis=1)  # r_z = (-y, x)
        Z[p, 2] = rz[np.arange(len(p)), comp]
    return Z.reshape(D, nbl, B, nc)


# --------------------------------------------------------------------------- #
# shard-local pieces: each takes the list of the shards' tensors
# --------------------------------------------------------------------------- #
def _neighbor_blocks(xbs):
    """Every shard's (nbl, B, ...) blocks -> (x_{I-1}, x_{I+1}), with the
    one boundary block from each neighbour (edge shards get zeros): the
    two ppermutes of femcy_tpu's ``_neighbor_blocks``."""
    D = len(xbs)
    out = []
    for d, xb in enumerate(xbs):
        left = (to(xbs[d - 1][-1], xb.device) if d > 0
                else torch.zeros_like(xb[-1]))
        right = (to(xbs[d + 1][0], xb.device) if d < D - 1
                 else torch.zeros_like(xb[0]))
        out.append((torch.cat([left[None], xb[:-1]]),
                    torch.cat([xb[1:], right[None]])))
    return out


def _bmv(A, x):
    """Batched matrix-vector products (nbl, B, B) x (nbl, B) -> (nbl, B)."""
    return torch.matmul(A, x[..., None])[..., 0]


def _btd_spmv(Vs, xs):
    """y = A x on every shard's local row blocks: three batched products
    and the neighbours' boundary blocks.  V: (nbl, 3, B, B) [lower, diag,
    upper]."""
    xbs = [x.reshape(V.shape[0], V.shape[2]) for V, x in zip(Vs, xs)]
    out = []
    for V, xb, (x_lo, x_hi) in zip(Vs, xbs, _neighbor_blocks(xbs)):
        y = _bmv(V[:, 1], xb) + _bmv(V[:, 0], x_lo) + _bmv(V[:, 2], x_hi)
        out.append(y.reshape(-1))
    return out


def _halo_add(bufs, n_rows: int):
    """The halo: each shard's last (extra) row block belongs to its right
    neighbour's block 0.  ``bufs``: (nbl + 1, ...) per shard; returns the
    (nbl, ...) local views, block 0 added to in place."""
    locs = [b[:n_rows] for b in bufs]
    for d in range(1, len(bufs)):
        locs[d][0] += to(bufs[d - 1][n_rows], locs[d].device)
    return locs


def _col_masks(fbs):
    """Every shard's (nbl, B) fixed mask (as values) -> the (nbl, 3, B)
    column masks of its [lower, diag, upper] blocks."""
    return [torch.stack([lo, fb, hi], dim=1)
            for fb, (lo, hi) in zip(fbs, _neighbor_blocks(fbs))]


def _btd_dirichlet(Vs, fixed_s, rhs_s=None, sval_s=None):
    """Symmetric zero-one elimination on every shard's local block rows,
    in place on V (femcy_tpu's ``_btd_dirichlet_linear``; with
    ``rhs_s=None`` its ``_btd_dirichlet_newton``, where the caller zeroes
    the residual).  Returns the treated right-hand sides (linear path)."""
    nbl, B = Vs[0].shape[0], Vs[0].shape[2]
    fbs = [f.reshape(nbl, B).to(V.dtype) for f, V in zip(fixed_s, Vs)]
    cfs = _col_masks(fbs)
    out = []
    if rhs_s is not None:
        sbs = [s.reshape(nbl, B) for s in sval_s]
        css = _col_masks(sbs)
        for V, cf, cs, rhs, f, s in zip(Vs, cfs, css, rhs_s, fixed_s, sval_s):
            # move prescribed-column loads to the rhs
            m = cf * cs
            corr = (_bmv(V[:, 0], m[:, 0]) + _bmv(V[:, 1], m[:, 1])
                    + _bmv(V[:, 2], m[:, 2]))
            out.append(torch.where(f, s, rhs - corr.reshape(-1)))
    for V, cf, fb in zip(Vs, cfs, fbs):
        V.mul_((1.0 - cf)[:, :, None, :])
        V.mul_((1.0 - fb)[:, None, :, None])
        dg = V[:, 1].diagonal(dim1=-2, dim2=-1)  # unit diagonal, fixed rows
        dg.copy_(torch.where(fb != 0, torch.ones_like(dg), dg))
    return out


def _patched_diag(Dg):
    """A diagonal block with a unit diagonal where its diagonal is 0 (the
    all-zero padded rows), so that it inverts; a new tensor."""
    diag = Dg.diagonal(dim1=-2, dim2=-1)
    Dg = Dg.clone()
    Dg.diagonal(dim1=-2, dim2=-1).add_(torch.where(
        diag == 0.0, torch.ones_like(diag), torch.zeros_like(diag)))
    return Dg


def _thomas_operands(Vs):
    """The local blocks (nbl, 3, B, B) of the shards of one device ->
    their block-Thomas apply operands (Sinv, LS, SU), each (shards, nbl,
    B, B) (femcy_tpu's ``_thomas_operands``, the shards batched): the
    Schur recursion S_1 = D_1, S_i = D_i - L_i S_{i-1}^-1 U_{i-1},
    sequential over the blocks, with L of the first block and U of the
    last (the couplings to the neighbours) left out."""
    nbl, B = Vs[0].shape[0], Vs[0].shape[2]
    Sinv = Vs[0].new_empty((len(Vs), nbl, B, B))
    for i in range(nbl):
        S = _patched_diag(torch.stack([V[i, 1] for V in Vs]))
        if i > 0:
            L = torch.stack([V[i, 0] for V in Vs])
            U = torch.stack([V[i - 1, 2] for V in Vs])
            S = S - L @ Sinv[:, i - 1] @ U
            del L, U
        Sinv[:, i] = torch.linalg.inv(S)
        del S
    LS = torch.zeros_like(Sinv)
    SU = torch.zeros_like(Sinv)
    if nbl > 1:
        for g, V in enumerate(Vs):
            torch.matmul(V[1:, 0], Sinv[g, :-1], out=LS[g, 1:])
            torch.matmul(Sinv[g, :-1], V[:-1, 2], out=SU[g, :-1])
    return Sinv, LS, SU


def _thomas_apply(Sinv, LS, SU, rs):
    """Apply the block-Thomas factorization to the residuals of the
    shards of one device: the forward sweep (LS matvecs), the batched Sinv
    product, the backward sweep (SU matvecs), each batched over the
    shards."""
    G, nbl, B = Sinv.shape[0], Sinv.shape[1], Sinv.shape[2]
    rb = torch.stack([r.reshape(nbl, B) for r in rs])
    ys = torch.empty_like(rb)
    ys[:, 0] = rb[:, 0]
    for i in range(1, nbl):
        ys[:, i] = rb[:, i] - _bmv(LS[:, i], ys[:, i - 1])
    sy = _bmv(Sinv, ys)
    zs = torch.empty_like(rb)
    zs[:, -1] = sy[:, -1]
    for i in range(nbl - 2, -1, -1):
        zs[:, i] = sy[:, i] - _bmv(SU[:, i], zs[:, i + 1])
    return list(zs.reshape(G, -1))


def _block_inv(V):
    """(nbl, 3, B, B) local blocks -> D_I^-1 (nbl, B, B): block Jacobi
    (femcy_tpu's ``_btd_block_inv``; LU, a unit diagonal on all-zero
    padded rows)."""
    return torch.linalg.inv(_patched_diag(V[:, 1]))


def _local_solve(thomas, groups, rs):
    """The block-Thomas solve of every shard's residual, batched over the
    shards of each device (``groups``: their shard ids, ``thomas``: their
    operands)."""
    out = [None] * len(rs)
    for ids, t in zip(groups, thomas):
        for d, z in zip(ids, _thomas_apply(*t, [rs[d] for d in ids])):
            out[d] = z
    return out


def _twolevel_factor(Vs, Zs, fixed_s, groups):
    """Two-level Schwarz setup (femcy_tpu's ``_btd_twolevel_factor``):
    the Thomas operands of every device's shards and every shard's masked
    coarse basis Zm, and the global coarse operator Ac = Z^T A Z,
    block-tridiagonal with the couplings between shards, Tikhonov-shifted
    by 1e-8 * sum(diag) / width and inverted once, on the first shard's
    device."""
    nbl, B = Vs[0].shape[0], Vs[0].shape[2]
    nc = Zs[0].shape[-1]
    D = len(Vs)
    thomas = [_thomas_operands([Vs[d] for d in ids]) for ids in groups]
    Zms = [Z * (1.0 - f.reshape(nbl, B).to(Z.dtype))[:, :, None]
           for Z, f in zip(Zs, fixed_s)]
    width = nc * nbl * D
    dev0 = Vs[0].device
    Ac = torch.zeros((width, width + 2 * nc), dtype=Vs[0].dtype, device=dev0)
    for d, (V, Zm, (Z_lo, Z_hi)) in enumerate(zip(Vs, Zms,
                                                  _neighbor_blocks(Zms))):
        Zt = Zm.transpose(1, 2)
        Cd = Zt @ (V[:, 1] @ Zm)
        Cs = Zt @ (V[:, 0] @ Z_lo)
        Cu = Zt @ (V[:, 2] @ Z_hi)
        tile = to(torch.cat([Cs, Cd, Cu], dim=2), dev0)  # (nbl, nc, 3nc)
        for i in range(nbl):
            g = nc * (d * nbl + i)
            Ac[g : g + nc, g : g + 3 * nc] = tile[i]
    Ac = Ac[:, nc:-nc]
    dg = Ac.diagonal()
    shift = 1.0e-8 * dg.sum() / width
    Ac = Ac + torch.diag(torch.where(dg == 0.0, torch.ones_like(dg),
                                     torch.zeros_like(dg)))
    Ac = Ac + shift * torch.eye(width, dtype=Ac.dtype, device=dev0)
    return thomas, torch.linalg.inv(Ac), Zms


def _btd_pcg(Vs, bs, eps: float, max_iters: int, kind: str, minv=None,
             groups=None):
    """PCG on the block-tridiagonal shards (femcy_tpu's ``_btd_pcg``):
    ``kind`` picks the preconditioner, ``minv`` its setup (None for
    "jacobi"), ``groups`` the shard ids of each device (the Thomas sweeps
    are batched over them).  Dots are summed in shard order; the stop
    test's pmax is read once an iteration.  Returns (x parts, iterations,
    max|r|)."""
    nbl, B = Vs[0].shape[0], Vs[0].shape[2]
    if kind == "tridiag":
        def apply_m(rs):
            return _local_solve(minv, groups, rs)
    elif kind == "twolevel":
        thomas, Acinv, Zms = minv
        nc = Zms[0].shape[-1]
        dev0 = Acinv.device

        def apply_m(rs):
            z1 = _local_solve(thomas, groups, rs)
            rc = [_bmv(Zm.transpose(1, 2), r.reshape(nbl, B)).reshape(-1)
                  for Zm, r in zip(Zms, rs)]
            yc = Acinv @ torch.cat([to(c, dev0) for c in rc])
            out = []
            for d, (Zm, z) in enumerate(zip(Zms, z1)):
                yl = to(yc[d * nc * nbl : (d + 1) * nc * nbl], z.device)
                out.append(z + _bmv(Zm, yl.reshape(nbl, nc)).reshape(-1))
            return out
    elif kind == "block":
        def apply_m(rs):
            return [_bmv(m, r.reshape(nbl, B)).reshape(-1)
                    for m, r in zip(minv, rs)]
    else:
        mv = []
        for V in Vs:
            diag = V[:, 1].diagonal(dim1=-2, dim2=-1).reshape(-1)
            mv.append(torch.where(diag != 0.0, 1.0 / diag,
                                  torch.zeros_like(diag)))

        def apply_m(rs):
            return [m * r for m, r in zip(mv, rs)]

    def pdot(a, b):
        return psum([torch.dot(x, y) for x, y in zip(a, b)])

    def rmax_of(rs):
        return pmax([r.abs().max() for r in rs])

    rs = list(bs)
    xs = [torch.zeros_like(b) for b in bs]
    ds = apply_m(rs)
    rmax0 = rmax_of(rs)
    rmax = rmax0
    thresh = eps * rmax0
    rmr = pdot(rs, ds)
    k = 0
    if bool(rmax0 > 0.0):
        while k < max_iters and bool(rmax >= thresh):
            Ad = _btd_spmv(Vs, ds)
            alpha = rmr / pdot(ds, Ad)
            xs = [x + to(alpha, x.device) * d for x, d in zip(xs, ds)]
            rs = [r - to(alpha, r.device) * a for r, a in zip(rs, Ad)]
            zs = apply_m(rs)
            rmr_new = pdot(rs, zs)
            beta = rmr_new / rmr
            ds = [z + to(beta, z.device) * d for z, d in zip(zs, ds)]
            rmr = rmr_new
            k += 1
            rmax = rmax_of(rs)
    return xs, k, rmax


class _Walls:
    """Stage walls: each call records the seconds since the last one,
    after synchronising the CUDA devices."""

    def __init__(self, devices):
        self._cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str):
        for d in self._cuda:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t


@dataclasses.dataclass
class _Shard:
    """One shard's scatter plans and coarse basis on its device."""

    device: torch.device
    plan_k: btd_scatter.BtdScatterPlan  # M8: Ke -> (nbl+1)*3*B*B
    plan_f: btd_scatter.BtdScatterPlan  # M8: f_e -> (nbl+1)*B
    Z: Optional[torch.Tensor] = None  # (nbl, B, nc) coarse basis


@dataclasses.dataclass
class _Group:
    """The shards of one device: their elements, concatenated in shard
    order (the element work runs once a device, then each shard's part
    goes through its own scatter), and the replicated operands."""

    device: torch.device
    ids: List[int]  # shard ids, ascending
    elements: torch.Tensor  # (sum ne, npe) int64
    sizes: List[int]  # elements of each shard
    nodes: torch.Tensor
    dN: torch.Tensor
    w: torch.Tensor
    C: torch.Tensor
    iperm: torch.Tensor
    dsdX0: Optional[torch.Tensor] = None  # Newton: initial gradients


class BandedShardedSolver:
    """K(dof) x = rhs on an arbitrary mesh, RCM-banded and block-row-
    sharded over ``devices`` (one shard each; torch devices or names, a
    device may repeat; by default one shard per CUDA card); and the Newton
    path's evaluation and CG on stacked permuted blocks (``Blocks``).
    The dtype defaults to ``system.default_dtype()``.

    ``preconditioner``: "twolevel" (default), "tridiag", "block" or
    "jacobi"; its setup is made once per increment (``new_increment``)
    and reused by the Newton solves within it.  ``tangent``: "secant"
    (plus the geometric stiffness unless ``geometric_stiffness=False``) or
    "consistent".
    """

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-3,
        cg_iters: int = 0,
        block: Optional[int] = None,
        geometric_stiffness: bool = True,
        pattern=None,
        preconditioner: str = "twolevel",
        tangent: str = "secant",
        dtype: Optional[torch.dtype] = None,
    ):
        from femcy_tpu_torch.system import default_dtype

        if tangent not in ("secant", "consistent"):
            raise ValueError(
                f"banded tangent must be 'secant' or 'consistent', got "
                f"{tangent!r}"
            )
        if preconditioner not in PRECONDITIONERS:
            raise ValueError(
                f"banded preconditioner must be 'twolevel', 'tridiag', "
                f"'block' or 'jacobi', got {preconditioner!r}"
            )
        self.devices = shard_devices(devices)
        self.dtype = dtype if dtype is not None else default_dtype()
        D = len(self.devices)
        ops = build_banded_operands(fe_mesh, material, D, block=block,
                                    pattern=pattern)
        self.ops = ops
        self._material = material
        self._geometric_stiffness = bool(geometric_stiffness)
        self._tangent = tangent
        if cg_iters <= 0:
            cg_iters = ops.n_dof
        self._cg_cfg = (cg_eps, cg_iters)
        self._precond_kind = preconditioner
        self._minv_cache = None
        self._last_fixed_s = None
        self._dm = fe_mesh.dm
        #: the stage walls of the last ``solve`` (seconds)
        self.last_seconds: Dict[str, float] = {}

        dt = self.dtype
        nbl, B = ops.nbl, ops.B
        edof = fe_mesh.element.edof
        Z = (build_coarse_basis(ops, fe_mesh.nodes, fe_mesh.dm)
             if preconditioner == "twolevel" else None)
        sizes = [int(ops.ele_weight[d].sum()) for d in range(D)]
        self.shards: List[_Shard] = []
        for d, dev in enumerate(self.devices):
            ne = sizes[d]
            self.shards.append(_Shard(
                device=dev,
                plan_k=btd_scatter.build_plan(
                    ops.scatter_targets[d, : ne * edof * edof],
                    (nbl + 1) * 3 * B * B, dev),
                plan_f=btd_scatter.build_plan(
                    ops.force_targets[d, : ne * edof], (nbl + 1) * B, dev),
                Z=(None if Z is None
                   else torch.as_tensor(Z[d], dtype=dt, device=dev)),
            ))
        self._groups: List[_Group] = []
        for dev in dict.fromkeys(self.devices):
            ids = [d for d in range(D) if self.devices[d] == dev]
            elements = np.concatenate(
                [ops.elements[d, : sizes[d]] for d in ids]).astype(np.int64)

            def tensor(a):
                return torch.as_tensor(a, dtype=dt, device=dev)

            self._groups.append(_Group(
                device=dev, ids=ids,
                elements=torch.as_tensor(elements, device=dev),
                sizes=[sizes[d] for d in ids],
                nodes=tensor(ops.nodes), dN=tensor(ops.dshape_gp),
                w=tensor(ops.weights_gp), C=tensor(ops.C),
                iperm=torch.as_tensor(ops.iperm, device=dev),
            ))

    # ------------------------------------------------------------------ #
    def _group_ids(self):
        return [g.ids for g in self._groups]

    def _per_shard(self, group: _Group, t: torch.Tensor, out: list):
        """Split a device's element-batched tensor into its shards' parts
        (contiguous), into ``out`` at the shards' places."""
        for d, part in zip(group.ids, torch.split(t, group.sizes)):
            out[d] = part.contiguous()

    def _scatter_k(self, Kes) -> List[torch.Tensor]:
        """Every shard's Ke -> its (nbl + 1, 3, B, B) buffer (M8) -> the
        (nbl, 3, B, B) local blocks after the halo-add."""
        ops = self.ops
        bufs = []
        for d, s in enumerate(self.shards):
            bufs.append(btd_scatter.scatter(Kes[d], s.plan_k).view(
                ops.nbl + 1, 3, ops.B, ops.B))
            Kes[d] = None  # free each shard's Ke once it is scattered
        return _halo_add(bufs, ops.nbl)

    def assemble(self, dof=None) -> List[torch.Tensor]:
        """K(dof)'s local blocks, before the boundary conditions."""
        dm = self._dm
        Kes = [None] * len(self.shards)
        for g in self._groups:
            coords = g.nodes
            if dof is not None:
                coords = coords + torch.as_tensor(
                    np.asarray(dof), dtype=self.dtype,
                    device=g.device).reshape(-1, dm)
            dsdx, vol = assembly.gradients_and_volume(coords, g.elements,
                                                      g.dN, g.w)
            self._per_shard(g, assembly.element_stiffness(dsdx, vol, g.C),
                            Kes)
            del dsdx, vol
        return self._scatter_k(Kes)

    def _stack(self, v, fill=0.0) -> Blocks:
        """Original-dof host vector -> permuted, padded (nbl*B,) blocks,
        one on each shard's device; a bool vector stays bool, any other
        takes the solver's dtype."""
        ops = self.ops
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        v = np.asarray(v)
        n_pad = ops.n_devices * ops.nbl * ops.B
        out = np.full(n_pad, fill, dtype=v.dtype)
        out[: ops.n_dof] = v[ops.perm]
        dt = torch.bool if v.dtype == bool else self.dtype
        return Blocks(torch.as_tensor(b, dtype=dt, device=s.device)
                      for b, s in zip(out.reshape(ops.n_devices, -1),
                                      self.shards))

    def solve(self, rhs: np.ndarray, fixed: np.ndarray, sval: np.ndarray,
              dof=None):
        """Assemble K(dof), eliminate Dirichlet dofs, solve K x = rhs.
        Returns (x (n_dof,) numpy, iterations).  ``last_seconds`` holds
        the walls of its stages ("assemble" with the elimination,
        "factor", "cg"), synchronised on CUDA."""
        wall = _Walls(self.devices)
        # padded rows are marked fixed: identity rows pinned to zero
        rhs_s = self._stack(np.asarray(rhs, dtype=float))
        fixed_s = self._stack(np.asarray(fixed, dtype=bool), fill=True)
        sval_s = self._stack(np.asarray(sval, dtype=float))
        V = self.assemble(dof)
        b = _btd_dirichlet(V, list(fixed_s), list(rhs_s), list(sval_s))
        wall("assemble")
        self._last_fixed_s = fixed_s
        self._minv_cache = None  # free the old setup first
        self._minv_cache = self.factor(V, fixed_s)
        wall("factor")
        x_s, iters, _ = self._run_cg(V, b)
        wall("cg")
        self.last_seconds = wall.seconds
        return self.unstack(x_s), iters

    def factor(self, V, fixed_s=None):
        """The preconditioner's setup from the treated blocks V (None for
        "jacobi"); ``fixed_s`` masks the two-level coarse basis."""
        kind = self._precond_kind
        if kind == "twolevel":
            return _twolevel_factor(V, [s.Z for s in self.shards],
                                    list(fixed_s), self._group_ids())
        if kind == "tridiag":
            return [_thomas_operands([V[d] for d in ids])
                    for ids in self._group_ids()]
        if kind == "block":
            return [_block_inv(v) for v in V]
        return None

    def _run_cg(self, V, b, fixed_s=None):
        """The CG with the per-increment cached preconditioner setup, made
        from this V when there is none.  ``fixed_s`` feeds the coarse
        basis's row mask (remembered across calls)."""
        eps, iters = self._cg_cfg
        kind = self._precond_kind
        if fixed_s is not None:
            self._last_fixed_s = fixed_s
        if kind != "jacobi" and self._minv_cache is None:
            if kind == "twolevel" and self._last_fixed_s is None:
                raise ValueError(
                    "twolevel preconditioner needs the Dirichlet mask; "
                    "pass fixed_s to cg()/solve()"
                )
            self._minv_cache = self.factor(V, self._last_fixed_s)
        return _btd_pcg(V, list(b), eps, iters, kind, self._minv_cache,
                        self._group_ids())

    def new_increment(self):
        """Invalidate the cached preconditioner setup (called by the host
        state machine at the start of every load increment)."""
        self._minv_cache = None

    # ------------------------------------------------------------------ #
    # Newton path (FEMSystem under sharding="banded"): the working dof and
    # du live in the permuted (nbl*B,) block space, shard by shard
    # ------------------------------------------------------------------ #
    def stack(self, v) -> Blocks:
        """Global (n_dof,) vector -> permuted blocks (femcy_tpu's
        ``stack``: padding 0, or False)."""
        return self._stack(v)

    def unstack(self, blocks) -> np.ndarray:
        """Blocks -> global (n_dof,) numpy, original ordering."""
        ops = self.ops
        xp = np.concatenate([b.cpu().numpy() for b in blocks])[: ops.n_dof]
        x = np.empty(ops.n_dof, dtype=xp.dtype)
        x[ops.perm] = xp
        return x

    def newton_eval(self, dof_s, rhs_s, fixed_s, sval_s, stab_s=None):
        """One Newton evaluation on every shard (femcy_tpu's
        ``_btd_newton_eval``): pin the prescribed dofs, gather and
        unpermute the dof once, the deformation gradient from the initial
        gradients (computed once), the Cauchy stress, the internal
        force (M8, its force plan) and the tangent (M8; the secant +
        geometric or the consistent one), each with its halo-add, the
        stabilization / Newmark hook when ``stab_s`` = (diagonal blocks,
        reference blocks, 0-d scale) is given, the Newton Dirichlet
        treatment and the rms.  Returns (pinned dof, treated tangent,
        treated residual, rms as a 0-d tensor)."""
        ops = self.ops
        nbl, B, dm = ops.nbl, ops.B, self._dm
        dofs = [torch.where(f, s, x) for x, f, s in zip(dof_s, fixed_s,
                                                        sval_s)]
        cache: Dict[torch.device, torch.Tensor] = {}
        f_elems, Kes = [None] * len(dofs), [None] * len(dofs)
        for g in self._groups:
            u = gather(dofs, g.device, cache)[g.iperm].reshape(-1, dm)
            if g.dsdX0 is None:
                g.dsdX0, _ = assembly.gradients_and_volume(
                    g.nodes, g.elements, g.dN, g.w)
            u_e = u[g.elements]
            F = assembly.deformation_gradient_u(u_e, g.dsdX0)
            sigma = assembly.gp_stress(F, self._material, large=True)
            dsdx, vol = assembly.gradients_and_volume(g.nodes + u, g.elements,
                                                      g.dN, g.w)
            self._per_shard(
                g, assembly.element_internal_force(dsdx, sigma, vol), f_elems)
            if self._tangent == "consistent":
                Ke = assembly.consistent_tangent_elems(
                    u_e, g.nodes[g.elements], g.dN, g.w, self._material)
            else:
                Ke = assembly.element_stiffness(dsdx, vol, g.C)
                if self._geometric_stiffness:
                    Ke += assembly.geometric_stiffness(dsdx, sigma, vol)
            self._per_shard(g, Ke, Kes)
            del Ke, dsdx, vol, sigma, F
        f_bufs = [btd_scatter.scatter(f, s.plan_f)
                  for f, s in zip(f_elems, self.shards)]
        f_int = [f.view(nbl + 1, B) for f in f_bufs]
        f_int = [f.reshape(-1) for f in _halo_add(f_int, nbl)]
        V = self._scatter_k(Kes)
        del Kes
        if stab_s is not None:
            # the stabilization / Newmark hook in the permuted block-row
            # space (padded rows carry diagonal 0, so they stay inert)
            diag_s, ref_s, scale = stab_s
            for d, v in enumerate(V):
                sd = to(scale, diag_s[d].device) * diag_s[d]
                f_int[d] = f_int[d] + sd * (dofs[d] - ref_s[d])
                v[:, 1].diagonal(dim1=-2, dim2=-1).add_(sd.reshape(nbl, B))
        residuals = [torch.where(f, r.new_zeros(()), r - b)
                     for r, b, f in zip(f_int, rhs_s, fixed_s)]
        _btd_dirichlet(V, list(fixed_s))
        rms = torch.sqrt(psum([(r * r).sum() for r in residuals]) / ops.n_dof)
        return Blocks(dofs), Blocks(V), Blocks(residuals), rms

    def cg(self, values_s, b_s, fixed=None, fixed_s=None):
        """The CG on treated blocks (the Newton linear solve); ``fixed_s``
        masks the two-level coarse basis.  Returns (x blocks, iterations,
        max|r|)."""
        x, k, rmax = self._run_cg(list(values_s), b_s, fixed_s=fixed_s)
        return Blocks(x), k, rmax
