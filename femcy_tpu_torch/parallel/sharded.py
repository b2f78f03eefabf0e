"""Sharded general-mesh solve: element-sharded assembly and row-parallel CG.

Torch counterpart of ``femcy_tpu.parallel.sharded``:

- **Assembly, data-parallel over elements.**  The elements are cut into D
  equal shards.  Each shard computes its elements' Ke and scatters them
  into a full-height partial ELL buffer (n_dof, W); the ``psum_scatter``
  is the sum of the partials in shard order, each shard keeping its own
  row block.  The scatter is M7: the stiffness scatter M1 and the
  internal-force scatter M4 (kernels/ell_scatter.py,
  kernels/internal_force.py) on a plan per element shard
  (``build_scatter_plan(..., elements=...)``): the shard's elements, with
  targets in the single-device pattern's flat slots, which is what
  femcy_tpu slices from ``pattern.ensure_scatter_targets()``.  Each slot
  of a partial is the sum of the shard's contributions in element order,
  the bits of femcy_tpu's per-shard ``segment_sum`` and of the plain
  ``index_add_`` in entry order.  The zero-weighted padded elements of
  femcy_tpu's shards are left out of the plans: their Ke is exactly 0.

- **CG, row-parallel.**  Each shard holds its ``rows_per_dev`` rows; the
  search direction is all-gathered once an iteration, and the local SpMV
  is M2 (kernels/ell_spmv.py) on the shard's rows with the whole gathered
  direction (``rows_plan``).  Dots are local sums added in shard order;
  the stop test's pmax is read once an iteration.

One process drives every shard (``parallel/shards.py``).  ``ShardedOperands``
and ``build_sharded_operands`` are femcy_tpu's, in numpy, array for array:
padded rows point their first slot at themselves, padded elements reuse
element 0 with zero weight.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly
from femcy_tpu_torch.kernels import ell_spmv
from femcy_tpu_torch.kernels.ell_scatter import (
    ScatterPlan,
    build_scatter_plan,
    scatter,
)
from femcy_tpu_torch.kernels.internal_force import scatter_force
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.parallel.shards import (
    gather,
    pmax,
    psum,
    shard_devices,
    to,
)
from femcy_tpu_torch.topology import build_pattern


@dataclasses.dataclass
class ShardedOperands:
    """Host-built static data for a sharded solve on D devices."""

    n_devices: int
    n_dof: int  # true dof count
    n_dof_pad: int  # padded to a multiple of D
    width: int
    rows_per_dev: int
    # stacked per-device arrays (leading axis = device)
    elements: np.ndarray  # (D, E_s, n) padded element shards
    ele_weight: np.ndarray  # (D, E_s) 1 for real elements, 0 for padding
    scatter_targets: np.ndarray  # (D, E_s*edof*edof) into n_dof_pad*width
    force_targets: np.ndarray  # (D, E_s*edof) global dof per force entry
    colidx: np.ndarray  # (n_dof_pad, W) global columns (row-sharded at run)
    diag_local: np.ndarray  # (n_dof_pad,) flat local slot of each row's diagonal
    nodes: np.ndarray  # (N, dm) replicated
    dshape_gp: np.ndarray
    weights_gp: np.ndarray
    C: np.ndarray


def build_sharded_operands(
    mesh: FEMesh, material: Material, n_devices: int, pattern=None
) -> ShardedOperands:
    """femcy_tpu's operands (``pattern``: the mesh's ELL pattern, built
    here when not given)."""
    if pattern is None:
        pattern = build_pattern(mesh)
    D = n_devices
    n_dof = pattern.n_dof
    n_dof_pad = -(-n_dof // D) * D
    rows_per_dev = n_dof_pad // D
    width = pattern.width

    # pad colidx rows; padded rows point their first slot at THEMSELVES so
    # the Dirichlet diag write makes them true identity rows
    colidx = np.zeros((n_dof_pad, width), dtype=np.int32)
    colidx[:n_dof] = pattern.colidx
    colidx[n_dof:, 0] = np.arange(n_dof, n_dof_pad)

    # local flat slot of each row's diagonal within its device block
    diag_local = np.zeros(n_dof_pad, dtype=np.int64)
    diag_local[:n_dof] = pattern.diag_slot - (
        (np.arange(n_dof) // rows_per_dev) * rows_per_dev * width
    )
    # padded rows: point their "diagonal" at their local slot 0
    for r in range(n_dof, n_dof_pad):
        diag_local[r] = (r % rows_per_dev) * width

    # --- element shards -------------------------------------------------
    E = mesh.n_elements
    E_s = -(-E // D)
    edof = mesh.element.edof
    dm = mesh.dm
    elements_pad = np.zeros((D * E_s, mesh.element.n_nodes), dtype=np.int32)
    elements_pad[:E] = mesh.elements
    elements_pad[E:] = mesh.elements[0]  # valid geometry, zero-weighted
    weight = np.zeros(D * E_s)
    weight[:E] = 1.0
    elements_sh = elements_pad.reshape(D, E_s, -1)
    weight_sh = weight.reshape(D, E_s)

    # per-shard scatter maps: the single-device pattern's element-ordered
    # slot map sliced per element shard; padded elements reuse element 0's
    # targets (their Ke is zero)
    tgt = pattern.ensure_scatter_targets().reshape(E, edof * edof).astype(np.int64)
    pad_e = D * E_s - E
    if pad_e:
        tgt = np.concatenate(
            [tgt, np.broadcast_to(tgt[0], (pad_e, edof * edof))], axis=0
        )
    targets_sh = np.ascontiguousarray(tgt.reshape(D, E_s * edof * edof))
    edofs_pad = (
        elements_pad.astype(np.int64)[:, :, None] * dm + np.arange(dm)
    ).reshape(D * E_s, edof)
    force_sh = edofs_pad.reshape(D, E_s * edof).astype(np.int32)

    return ShardedOperands(
        n_devices=D,
        n_dof=n_dof,
        n_dof_pad=n_dof_pad,
        width=width,
        rows_per_dev=rows_per_dev,
        elements=elements_sh,
        ele_weight=weight_sh,
        scatter_targets=targets_sh,
        force_targets=force_sh,
        colidx=colidx,
        diag_local=diag_local,
        nodes=mesh.nodes,
        dshape_gp=mesh.element.dshape_at_gp,
        weights_gp=mesh.element.gauss_weights,
        C=material.C,
    )


def shard_element_ids(ops: ShardedOperands, d: int) -> np.ndarray:
    """The real (weight 1) elements of shard d, as global ids."""
    E_s = ops.elements.shape[1]
    n_real = int(ops.ele_weight[d].sum())
    return np.arange(d * E_s, d * E_s + n_real)


def psum_scatter(ops: ShardedOperands, partials) -> List[torch.Tensor]:
    """Full-height partials (n_dof, ...) of every shard -> each shard's
    row block (rows_per_dev, ...), the partials' sum in shard order on
    that shard's device; padded rows are 0."""
    rpd, n = ops.rows_per_dev, ops.n_dof
    out = []
    for d, part in enumerate(partials):
        lo, hi = d * rpd, min((d + 1) * rpd, n)
        total = partials[0][lo:hi]
        for p in partials[1:]:
            total = total + to(p[lo:hi], total.device)
        total = to(total, part.device)
        if hi - lo < rpd:
            pad = total.new_zeros((rpd - (hi - lo),) + tuple(total.shape[1:]))
            total = torch.cat([total, pad])
        out.append(total)
    return out


@dataclasses.dataclass
class _Shard:
    """One shard's operands on its device."""

    device: torch.device
    elements: torch.Tensor  # (ne, npe) int64, the shard's real elements
    plan: ScatterPlan  # M1/M4's plan restricted to those elements
    spmv: ell_spmv.EllSpmvPlan  # M2 on the shard's rows, x of n_dof_pad
    colidx: torch.Tensor  # (rows_per_dev, W) int64 global columns
    diag_local: torch.Tensor  # (rows_per_dev,) int64
    rows: torch.Tensor  # (rows_per_dev,) int64 global row ids
    nodes: torch.Tensor
    dN: torch.Tensor
    w: torch.Tensor
    C: torch.Tensor
    dsdX0: Optional[torch.Tensor] = None


class _ShardedBase:
    """What the linear solver and the Newton step share: the operands, the
    per-shard plans and tensors, the M7 assembly and the row-parallel CG."""

    def __init__(self, fe_mesh: FEMesh, material: Material, devices,
                 cg_eps: float, cg_iters: int, dtype, pattern):
        from femcy_tpu_torch.system import default_dtype

        self.devices = shard_devices(devices)
        self.dtype = dtype if dtype is not None else default_dtype()
        D = len(self.devices)
        if pattern is None:
            pattern = build_pattern(fe_mesh)
        ops = build_sharded_operands(fe_mesh, material, D, pattern=pattern)
        self.ops = ops
        self.material = material
        if cg_iters <= 0:
            cg_iters = ops.n_dof
        self._cg = (cg_eps, cg_iters)
        dt = self.dtype
        rpd = ops.rows_per_dev
        row_counts = np.ones(ops.n_dof_pad, dtype=np.int32)
        row_counts[: ops.n_dof] = pattern.row_counts
        self.shards: List[_Shard] = []
        for d, dev in enumerate(self.devices):
            ids = shard_element_ids(ops, d)
            rows = slice(d * rpd, (d + 1) * rpd)
            self.shards.append(_Shard(
                device=dev,
                elements=torch.as_tensor(
                    fe_mesh.elements[ids].astype(np.int64), device=dev),
                plan=build_scatter_plan(pattern, dev, elements=ids),
                spmv=ell_spmv.rows_plan(ops.colidx[rows], row_counts[rows],
                                        ops.n_dof_pad, dev),
                colidx=torch.as_tensor(ops.colidx[rows].astype(np.int64),
                                       device=dev),
                diag_local=torch.as_tensor(ops.diag_local[rows], device=dev),
                rows=torch.arange(d * rpd, (d + 1) * rpd, device=dev),
                nodes=torch.as_tensor(ops.nodes, dtype=dt, device=dev),
                dN=torch.as_tensor(ops.dshape_gp, dtype=dt, device=dev),
                w=torch.as_tensor(ops.weights_gp, dtype=dt, device=dev),
                C=torch.as_tensor(ops.C, dtype=dt, device=dev),
            ))

    # ------------------------------------------------------------------ #
    def _padded(self, v, fill=0.0) -> torch.Tensor:
        """A global (n_dof,) vector padded to n_dof_pad, on the first
        shard's device; a bool vector stays bool, any other takes the
        solver's dtype."""
        ops = self.ops
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        v = np.asarray(v)
        dtype = torch.bool if v.dtype == bool else self.dtype
        out = np.full(ops.n_dof_pad, fill, dtype=v.dtype)
        out[: ops.n_dof] = v
        return torch.as_tensor(out, dtype=dtype, device=self.devices[0])

    def _rows_of(self, full: torch.Tensor) -> List[torch.Tensor]:
        """A padded global vector -> each shard's row block on its device."""
        rpd = self.ops.rows_per_dev
        return [to(full[d * rpd:(d + 1) * rpd], s.device)
                for d, s in enumerate(self.shards)]

    def _stiffness_rows(self, Kes) -> List[torch.Tensor]:
        """Every shard's Ke -> its partial (M1 on its plan) -> the row
        blocks (the shard-order sum)."""
        partials = [scatter(Ke, s.plan) for Ke, s in zip(Kes, self.shards)]
        return psum_scatter(self.ops, partials)

    def _pcg(self, values, b_local):
        """femcy_tpu's ``_row_parallel_pcg``: row-parallel Jacobi-PCG on
        the shards' row blocks, the direction all-gathered once an
        iteration; returns (x blocks, iterations, max|r|)."""
        eps, max_iters = self._cg
        shards = self.shards
        minv, ops_t = [], []
        for v, s in zip(values, shards):
            diag = v.reshape(-1)[s.diag_local]
            minv.append(torch.where(diag != 0.0, 1.0 / diag,
                                    torch.zeros_like(diag)))
            ops_t.append(ell_spmv.prep_values(s.spmv, v))

        def spmv_local(ds):
            cache: Dict[torch.device, torch.Tensor] = {}
            return [ell_spmv.spmv(s.spmv, vt, gather(ds, s.device, cache))
                    for s, vt in zip(shards, ops_t)]

        def pdot(a, b):
            return psum([torch.dot(x, y) for x, y in zip(a, b)])

        def rmax_of(rs):
            return pmax([r.abs().max() for r in rs])

        rs = list(b_local)
        ds = [m * r for m, r in zip(minv, rs)]
        xs = [torch.zeros_like(r) for r in rs]
        rmax0 = rmax_of(rs)
        rmax = rmax0
        thresh = eps * rmax0
        k = 0
        if bool(rmax0 > 0.0):
            while k < max_iters and bool(rmax >= thresh):
                Ad = spmv_local(ds)
                rmr = pdot(rs, [m * r for m, r in zip(minv, rs)])
                dAd = pdot(ds, Ad)
                alpha = rmr / dAd
                xs = [x + to(alpha, x.device) * d for x, d in zip(xs, ds)]
                rs = [r - to(alpha, r.device) * a for r, a in zip(rs, Ad)]
                rmr_new = pdot(rs, [m * r for m, r in zip(minv, rs)])
                beta = rmr_new / rmr
                ds = [m * r + to(beta, r.device) * d
                      for m, r, d in zip(minv, rs, ds)]
                k += 1
                rmax = rmax_of(rs)
        return xs, k, rmax

    def _zero_one_local(self, values, s: _Shard, fixed_local, fixed_full):
        """Zero the fixed rows and columns of a shard's row block, unit
        diagonal (femcy_tpu's ``_zero_one_local``)."""
        col_fixed = fixed_full[s.colidx]
        values = torch.where(col_fixed | fixed_local[:, None],
                             values.new_zeros(()), values)
        flat = values.reshape(-1)
        flat[s.diag_local] = torch.where(fixed_local, values.new_ones(()),
                                         flat[s.diag_local])
        return values

    def _gathered(self, full: torch.Tensor) -> List[torch.Tensor]:
        """A replicated vector, once on every distinct shard device."""
        cache = {}
        out = []
        for s in self.shards:
            if s.device not in cache:
                cache[s.device] = to(full, s.device)
            out.append(cache[s.device])
        return out


class ShardedLinearSolver(_ShardedBase):
    """K(dof) x = rhs with Dirichlet elimination, sharded over ``devices``
    (one shard each; torch devices or names, a device may repeat; by
    default one shard per CUDA card): M7's element-sharded assembly, the
    shard-order reduce-scatter, the zero-one elimination on each row block
    and the row-parallel Jacobi-PCG with M2.  The dtype defaults to
    ``system.default_dtype()``; ``pattern`` reuses a built ELL pattern."""

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-6,
        cg_iters: int = 0,
        dtype: Optional[torch.dtype] = None,
        pattern=None,
    ):
        super().__init__(fe_mesh, material, devices, cg_eps, cg_iters, dtype,
                         pattern)

    def assemble(self, dof=None) -> List[torch.Tensor]:
        """K(dof)'s row blocks before the boundary conditions."""
        ops = self.ops
        dof_p = (torch.zeros(ops.n_dof_pad, dtype=self.dtype,
                             device=self.devices[0])
                 if dof is None else self._padded(dof))
        Kes = []
        for s, full in zip(self.shards, self._gathered(dof_p)):
            coords = s.nodes + full[: ops.n_dof].reshape(s.nodes.shape)
            dsdx, vol = assembly.gradients_and_volume(coords, s.elements,
                                                      s.dN, s.w)
            Kes.append(assembly.element_stiffness(dsdx, vol, s.C))
        return self._stiffness_rows(Kes)

    def solve(self, rhs: np.ndarray, fixed: np.ndarray, sval: np.ndarray,
              dof=None):
        """Assemble K(dof), apply Dirichlet BCs and solve K x = rhs.
        Returns (x (n_dof,) numpy, iterations)."""
        ops = self.ops
        # padded rows behave as pinned-to-zero identity rows
        fixed_p = self._padded(np.asarray(fixed, bool), fill=True)
        sval_p = self._padded(sval)
        rhs_rows = self._rows_of(self._padded(rhs))
        fixed_rows = self._rows_of(fixed_p)
        values = self.assemble(dof)
        bs = []
        for d, (s, sv, fx) in enumerate(zip(
                self.shards, self._gathered(sval_p),
                self._gathered(fixed_p))):
            v = values[d]
            col_fixed = fx[s.colidx]
            zero = v.new_zeros(())
            b = rhs_rows[d] - torch.where(col_fixed, v * sv[s.colidx],
                                          zero).sum(dim=1)
            b = torch.where(fixed_rows[d], sv[s.rows], b)
            values[d] = self._zero_one_local(v, s, fixed_rows[d], fx)
            bs.append(b)
        xs, k, _ = self._pcg(values, bs)
        x = torch.cat([to(x, self.devices[0]) for x in xs])[: ops.n_dof]
        return x.cpu().numpy(), k


class ShardedNewtonStep(_ShardedBase):
    """The full geometric-nonlinear Newton step, element-data-parallel and
    row-parallel (femcy_tpu's ``ShardedNewtonStep``): pin the Dirichlet
    dofs, deformation gradients from each shard's initial-configuration
    gradients (computed once), Cauchy stress, the internal force (M4 on
    the shard's plan) and the secant + geometric tangent (M1), both
    reduce-scattered in shard order, the Newton Dirichlet treatment, the
    row-parallel CG and ``dof - du``."""

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-3,
        cg_iters: int = 0,
        dtype: Optional[torch.dtype] = None,
        pattern=None,
    ):
        super().__init__(fe_mesh, material, devices, cg_eps, cg_iters, dtype,
                         pattern)
        for s in self.shards:
            s.dsdX0, _ = assembly.gradients_and_volume(s.nodes, s.elements,
                                                       s.dN, s.w)

    def step(self, dof, rhs, fixed, sval):
        """dof -> (dof - K^-1 r (n_dof,) tensor on the first shard's
        device, rms residual (0-d tensor), CG iterations)."""
        ops = self.ops
        fixed_p = self._padded(np.asarray(fixed, bool), fill=True)
        sval_p = self._padded(sval)
        dof_p = torch.where(fixed_p, sval_p, self._padded(dof))
        rhs_rows = self._rows_of(self._padded(rhs))
        fixed_rows = self._rows_of(fixed_p)
        f_parts, Kes = [], []
        for s, full in zip(self.shards, self._gathered(dof_p)):
            u = full[: ops.n_dof].reshape(s.nodes.shape)
            u_e = u[s.elements]
            F = assembly.deformation_gradient_u(u_e, s.dsdX0)
            sigma = assembly.gp_stress(F, self.material, large=True)
            dsdx, vol = assembly.gradients_and_volume(s.nodes + u, s.elements,
                                                      s.dN, s.w)
            f_elem = assembly.element_internal_force(dsdx, sigma, vol)
            f_parts.append(scatter_force(f_elem.contiguous(), s.plan))
            Ke = assembly.element_stiffness(dsdx, vol, s.C)
            Kes.append(Ke + assembly.geometric_stiffness(dsdx, sigma, vol))
        f_rows = psum_scatter(ops, [f[:, None] for f in f_parts])
        values = self._stiffness_rows(Kes)
        residuals, sq = [], []
        for d, (s, fx) in enumerate(zip(self.shards,
                                        self._gathered(fixed_p))):
            res = torch.where(fixed_rows[d], f_rows[d].new_zeros(()),
                              f_rows[d][:, 0] - rhs_rows[d])
            values[d] = self._zero_one_local(values[d], s, fixed_rows[d], fx)
            residuals.append(res)
            sq.append((res * res).sum())
        rms = torch.sqrt(psum(sq) / ops.n_dof)
        du, k, _ = self._pcg(values, residuals)
        du_full = torch.cat([to(x, self.devices[0]) for x in du])
        return (dof_p - du_full)[: ops.n_dof], rms, k
