"""Slab-sharded structured solve: slab assembly, plane halo-add, halo-window
DIA CG, on every shard of one process.

Torch counterpart of ``femcy_tpu.parallel.structured``.  The box's cells
are split into D equal x-slabs; shard d owns the node planes
[d*nxl, (d+1)*nxl) (the last shard also owns the final plane) and also
CARRIES the shared boundary plane of its right neighbour, kept bitwise
equal on both owners, so every shard's arrays have the same shape
(``StructuredShardPlan``, ``stack_rows``, ``unstack_rows``).

One process drives every shard, as femcy_tpu's single controller drives
its ``shard_map`` (the public API stays the single-process one; the rules
are in ``parallel/shards.py``); the halo planes move by copies between the
shards' tensors, a peer copy when two shards' devices differ
(``_fetch_halos``, ``_halo_add``).

The kernels: the local SpMV of the CG, of the smoother and of the residual
is the DIA SpMV kernel over a halo window (P1's windowed entry point,
``kernels.dia_spmv.spmv_window``: y has the slab's ``local_rows`` rows, x
is the halo-extended slab read from base ``HALO_PLANES * ps``); the linear
assembly broadcasts one cell's host-computed element stiffness over the
slab's cells and sums the planes with the accumulate kernel (P2); the
Newton evaluation sums its element forces with the box force kernel (M5)
and its tangent with P2 (``structured_dia_scatter``), each followed by the
plane halo-add.  The multigrid V-cycle restricts each slab's residual,
sums the coarse residual (n/8) over the shards and runs the single-device
``StructuredMultigrid`` (P1 on its levels), built once per distinct
device, on it.  On CPU tensors every kernel wrapper runs its plain
version.

One difference from femcy_tpu: its ``devs[:n]`` quietly gives fewer shards
than asked when n exceeds the device count; here the caller's device list
is the shard list, and ``FEMSystem`` places ``sharding_devices`` shards
round robin on the cards (or all on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly
from femcy_tpu_torch.kernels import dia_spmv as k_spmv
from femcy_tpu_torch.kernels.structured_accumulate import accumulate
from femcy_tpu_torch.kernels.structured_force import force_scatter
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.meshgen import box_tets
from femcy_tpu_torch.parallel.shards import (
    Blocks,
    pmax,
    psum,
    shard_devices,
    to,
)
from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
from femcy_tpu_torch.solvers.multigrid import (
    StructuredMultigrid,
    _interp_axis,
    _restrict_axis,
)
from femcy_tpu_torch.structured import (
    build_structured_plan,
    cell_gradients,
    structured_dia_scatter,
    structured_element_nodes,
)

#: halo depth in node planes; pad_lo = 3*(sx+sy+1)+2 < 2*3*sx = 2 planes
#: for every grid with ny >= nz (checked in the plan)
HALO_PLANES = 2


@dataclasses.dataclass(frozen=True)
class StructuredShardPlan:
    n_devices: int
    nx: int
    ny: int
    nz: int
    nxl: int  # cell planes per shard
    ps: int  # dof rows per node plane = 3*(ny+1)*(nz+1)
    local_rows: int  # (nxl + 1) * ps, incl. the shared right plane
    offsets: tuple
    diag_idx: int
    n_dof: int


def build_structured_shard_plan(mesh: FEMesh, n_devices: int) -> StructuredShardPlan:
    info = mesh.structure
    if info is None or info.get("kind") != "box_tets":
        raise ValueError("slab sharding needs a structured box_tets mesh")
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    D = n_devices
    if D < 1 or nx % D != 0 or nx // D < HALO_PLANES:
        raise ValueError(
            f"slab sharding needs nx divisible by n_devices with at least "
            f"{HALO_PLANES} cell planes per device (nx={nx}, D={D})"
        )
    dia = build_structured_dia_pattern(mesh)
    ps = 3 * (ny + 1) * (nz + 1)
    if dia.pad_lo > HALO_PLANES * ps or dia.pad_hi > HALO_PLANES * ps:
        raise ValueError(
            f"the stencil reaches past {HALO_PLANES} node planes "
            f"(ny={ny} < nz={nz}?)")
    nxl = nx // D
    return StructuredShardPlan(
        n_devices=D, nx=nx, ny=ny, nz=nz, nxl=nxl, ps=ps,
        local_rows=(nxl + 1) * ps, offsets=dia.offsets,
        diag_idx=dia.diag_idx, n_dof=mesh.n_dof,
    )


def stack_rows(plan: StructuredShardPlan, v: np.ndarray) -> np.ndarray:
    """Global (n_dof, ...) row vector -> (D, local_rows, ...) overlapping
    stacked blocks (the shared plane is duplicated)."""
    blocks = [
        v[d * plan.nxl * plan.ps : (d * plan.nxl + plan.nxl + 1) * plan.ps]
        for d in range(plan.n_devices)
    ]
    return np.stack(blocks)


def unstack_rows(plan: StructuredShardPlan, blocks: np.ndarray) -> np.ndarray:
    """(D, local_rows, ...) stacked blocks -> global (n_dof, ...) (owned
    rows only)."""
    own = [blocks[d, : plan.nxl * plan.ps] for d in range(plan.n_devices)]
    own.append(blocks[-1, plan.nxl * plan.ps :])
    return np.concatenate(own)


def _fetch_halos(plan: StructuredShardPlan, xs) -> List[torch.Tensor]:
    """x_ext = [2 planes from the left | x_local | 2 planes from the right]
    for every shard.

    Shard d's left halo lives on shard d-1 at local planes [nxl-2, nxl)
    and its right halo on shard d+1 at local planes [1, 3) (plane 0
    duplicates shard d's own last plane).  Edge shards get zeros there:
    boundary rows have no stencil entries beyond the domain.
    """
    D, ps, nxl = plan.n_devices, plan.ps, plan.nxl
    H = HALO_PLANES * ps
    L = plan.local_rows
    out = []
    for d, x in enumerate(xs):
        ext = x.new_empty(L + 2 * H)
        if d > 0:
            ext[:H].copy_(xs[d - 1][(nxl - HALO_PLANES) * ps : nxl * ps])
        else:
            ext[:H].zero_()
        ext[H : H + L].copy_(x)
        if d < D - 1:
            ext[H + L :].copy_(xs[d + 1][ps : ps + H])
        else:
            ext[H + L :].zero_()
        out.append(ext)
    return out


def _halo_add(plan: StructuredShardPlan, vs) -> List[torch.Tensor]:
    """Add the neighbours' partial sums of the shared node planes, in
    place, on any per-shard (local_rows, ...) arrays (DIA values, force
    vectors): shard d's last plane also belongs to shard d+1's first plane
    and vice versa.  Both owners add the same two partials (a + b there,
    b + a here), so the shared plane stays bitwise equal."""
    D, ps = plan.n_devices, plan.ps
    firsts = [v[:ps].clone() for v in vs]
    lasts = [v[-ps:].clone() for v in vs]
    for d, v in enumerate(vs):
        if d < D - 1:
            v[-ps:] += to(firsts[d + 1], v.device)
        if d > 0:
            v[:ps] += to(lasts[d - 1], v.device)
    return vs


def _window_columns(plan: StructuredShardPlan, v_ext):
    """(local_rows, K): column k is the halo-extended ``v_ext`` shifted by
    offset k, the same windows the SpMV reads."""
    H = HALO_PLANES * plan.ps
    L = plan.local_rows
    return torch.stack([v_ext[H + off : H + off + L] for off in plan.offsets],
                       dim=1)


def _dirichlet_local(plan: StructuredShardPlan, values, rhs, fixed, fixed_ext,
                     sval_ext, sval):
    """Symmetric zero-one elimination on one shard's rows; the column masks
    come from the halo-extended fixed/sval vectors."""
    col_fixed = _window_columns(plan, fixed_ext)
    col_sval = _window_columns(plan, sval_ext)
    zero = values.new_zeros(())
    rhs = rhs - torch.where(col_fixed, values * col_sval, zero).sum(dim=1)
    rhs = torch.where(fixed, sval, rhs)
    values = torch.where(col_fixed | fixed[:, None], zero, values)
    values[:, plan.diag_idx] = torch.where(fixed, values.new_ones(()),
                                           values[:, plan.diag_idx])
    return values, rhs


def _dirichlet_newton_local(plan: StructuredShardPlan, values, residual,
                            fixed, fixed_ext):
    """Newton-path Dirichlet treatment on one shard's rows (the math of
    solvers.dia.dia_dirichlet_newton, halo windows instead of pads)."""
    col_fixed = _window_columns(plan, fixed_ext)
    zero = values.new_zeros(())
    residual = torch.where(fixed, zero, residual)
    values = torch.where(col_fixed | fixed[:, None], zero, values)
    values[:, plan.diag_idx] = torch.where(fixed, values.new_ones(()),
                                           values[:, plan.diag_idx])
    return values, residual


def _restrict_x_local(plan: StructuredShardPlan, r_ext):
    """A shard's halo-extended fine residual -> its coarse x-planes
    [0 .. nxl/2], (nxl/2 + 1, ps): full weighting along x only (y/z
    restriction is slab-local); edge shards' zero halos are the zero
    padding of solvers.multigrid._restrict_axis."""
    F = r_ext.reshape(plan.nxl + 5, plan.ps)
    even = F[2 : plan.nxl + 3 : 2]
    odd_lo = F[1 : plan.nxl + 2 : 2]
    odd_hi = F[3 : plan.nxl + 4 : 2]
    return even + 0.5 * (odd_lo + odd_hi)


def _prolong_x_local(plan: StructuredShardPlan, c_slab):
    """A shard's coarse x-planes (nxl/2 + 1, ps) -> its fine planes
    (nxl + 1, ps) by linear interpolation (the transpose of
    _restrict_x_local on the owned range)."""
    nxl = plan.nxl
    out = c_slab.new_zeros((nxl + 1, c_slab.shape[1]))
    out[0 : nxl + 1 : 2] = c_slab
    out[1 : nxl + 1 : 2] = 0.5 * (c_slab[:-1] + c_slab[1:])
    return out


@dataclasses.dataclass
class _DeviceOperands:
    """What every shard on one device reads: the material tangent, the
    cell's element stiffness, the Newton path's initial element
    coordinates, quadrature tables and broadcast initial gradients, and
    P1's window plan."""

    C: torch.Tensor
    ke_cell: torch.Tensor  # (6, 144): one cell's Ke per orientation
    x0_e: torch.Tensor  # (E_loc, 4, 3)
    dN: torch.Tensor
    w: torch.Tensor
    dsdX0: torch.Tensor  # (E_loc, G, 4, 3)
    spmv_plan: k_spmv.SpmvPlan


class ShardedStructuredSolver:
    """K x = rhs on a structured box, slab by slab over ``devices`` (one
    shard each; torch devices or names, a device may repeat), and the
    Newton path's evaluation and CG on stacked slab blocks (``Blocks``).

    ``devices`` defaults to one shard per CUDA card; the dtype to
    ``system.default_dtype()``.
    """

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-6,
        cg_iters: int = 0,
        preconditioner: str = "jacobi",
        mg_omega: float = 0.7,
        mg_smooth_steps: int = 2,
        geometric_stiffness: bool = True,
        tangent: str = "secant",
        dtype: Optional[torch.dtype] = None,
    ):
        from femcy_tpu_torch.system import default_dtype

        if tangent not in ("secant", "consistent"):
            raise ValueError(
                f"slab tangent must be 'secant' or 'consistent', got "
                f"{tangent!r}"
            )
        self._tangent = tangent
        self.devices = shard_devices(devices)
        self.dtype = dtype if dtype is not None else default_dtype()
        plan = build_structured_shard_plan(fe_mesh, len(self.devices))
        self.plan = plan
        if cg_iters <= 0:
            cg_iters = plan.n_dof

        lx = fe_mesh.nodes[:, 0].max()
        ly = fe_mesh.nodes[:, 1].max()
        lz = fe_mesh.nodes[:, 2].max()
        slab = box_tets(plan.nxl, plan.ny, plan.nz,
                        lx * plan.nxl / plan.nx, ly, lz)
        slab_dia = build_structured_dia_pattern(slab)
        if slab_dia.offsets != plan.offsets:
            raise ValueError("slab offsets must equal the global ones "
                             "(needs >= 2 cell planes per shard)")
        self._slab = slab
        self._slab_plan = build_structured_plan(slab, slab_dia)
        self._material = material
        self._geometric_stiffness = bool(geometric_stiffness)

        # ownership: each shard owns its first nxl planes; the last shard
        # also owns the final (shared-representation) plane
        own = np.ones((len(self.devices), plan.local_rows))
        own[:-1, plan.nxl * plan.ps :] = 0.0
        self._own = [torch.as_tensor(o, dtype=self.dtype, device=dev)
                     for o, dev in zip(own, self.devices)]
        self._dsdx_cell, self._vol_cell = cell_gradients(slab)
        self._ops: Dict[torch.device, _DeviceOperands] = {}

        # slab-sharded multigrid: the fine level is sharded here; from the
        # first coarsening down it is the single-device hierarchy (n/8
        # dofs, mostly halo if sharded), built lazily for the fixed mask
        if preconditioner == "multigrid":
            if any(d % 2 for d in (plan.nx, plan.ny, plan.nz)) or plan.nxl % 2:
                raise ValueError(
                    "sharded multigrid needs even grid dims and an even "
                    f"slab width (got grid {plan.nx}x{plan.ny}x{plan.nz}, "
                    f"slab {plan.nxl})"
                )
            self._coarse = box_tets(plan.nx // 2, plan.ny // 2, plan.nz // 2,
                                    lx, ly, lz)
        self._preconditioner = preconditioner
        self._omega, self._smooth_steps = mg_omega, mg_smooth_steps
        self._cg = (cg_eps, cg_iters)
        self._mg_mask = None
        #: per distinct device: (inner multigrid, fixed coarse mask, coarse
        #: level-0 operator, its (prep, apply) SpMV pair)
        self._mg: Optional[dict] = None

    # ------------------------------------------------------------------ #
    def _operands(self, device: torch.device) -> _DeviceOperands:
        """The per-device operands, made at first use on ``device``."""
        ops = self._ops.get(device)
        if ops is not None:
            return ops
        dt = self.dtype

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        slab, plan = self._slab, self.plan
        C = tensor(self._material.C)
        dsdx_cell = tensor(self._dsdx_cell)  # (6, G, 4, 3)
        ke_cell = assembly.element_stiffness(
            dsdx_cell, tensor(self._vol_cell), C).reshape(6, 144)
        nc = plan.nxl * plan.ny * plan.nz
        n_gp = dsdx_cell.shape[1]
        dsdX0 = dsdx_cell[None].expand(nc, 6, n_gp, 4, 3).reshape(
            6 * nc, n_gp, 4, 3)
        ops = _DeviceOperands(
            C=C, ke_cell=ke_cell,
            x0_e=structured_element_nodes(tensor(slab.nodes), slab),
            dN=tensor(slab.element.dshape_at_gp),
            w=tensor(slab.element.gauss_weights),
            dsdX0=dsdX0,
            spmv_plan=k_spmv.spmv_plan(plan.local_rows, plan.offsets, device),
        )
        self._ops[device] = ops
        return ops

    def _apply_a(self, values_t, xs) -> List[torch.Tensor]:
        """y = A x on every shard: P1 over each shard's halo window."""
        H = HALO_PLANES * self.plan.ps
        return [k_spmv.spmv_window(self._operands(x.device).spmv_plan, vt,
                                   xe, H)
                for vt, x, xe in zip(values_t, xs,
                                     _fetch_halos(self.plan, xs))]

    def _assemble(self) -> List[torch.Tensor]:
        """Every shard's slab operator: one cell's element stiffness
        broadcast over the slab's cells as P2's planes, accumulated, then
        the plane halo-add."""
        nc = self.plan.nxl * self.plan.ny * self.plan.nz
        table = self._slab_plan.accumulate_table
        values = []
        for dev in self.devices:
            ke = self._operands(dev).ke_cell
            planes = ke[:, :, None].expand(6, 144, nc).contiguous()
            values.append(accumulate(planes, table))
        return _halo_add(self.plan, values)

    # ------------------------------------------------------------------ #
    # the CG and its preconditioners
    # ------------------------------------------------------------------ #
    def _pcg_solve(self, values, bs, fixed_s):
        """The PCG on treated slab operators: the slab-sharded V-cycle
        under "multigrid", Jacobi otherwise."""
        plan = self.plan
        values_t = [k_spmv.prep_values(self._operands(v.device).spmv_plan, v)
                    for v in values]
        minv = [_inv_diag(v, plan.diag_idx) for v in values]
        if self._preconditioner == "multigrid":
            def apply_m(rs):
                return self._vcycle(values_t, minv, fixed_s, rs)
        else:
            def apply_m(rs):
                return [m * r for m, r in zip(minv, rs)]
        return self._pcg(values_t, bs, apply_m)

    def _pcg(self, values_t, bs, apply_m):
        """Row-parallel PCG from x0 = 0, ownership-weighted dots summed
        over shards, femcy_tpu's stopping rule (its ``_pcg_local``):
        iterate while k < max_iters and max|own r| >= eps max|own b|, not
        at all when b = 0.  Returns (x blocks, iterations, max|own r|)."""
        eps, max_iters = self._cg
        own = self._own

        def pdot(a, b):
            return psum([torch.dot(o * x, y) for o, x, y in zip(own, a, b)])

        def rmax_of(rs):
            return pmax([(o * r).abs().max() for o, r in zip(own, rs)])

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
                Ad = self._apply_a(values_t, ds)
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

    def _vcycle(self, values_t, minv, fixed_s, rs):
        """One V-cycle M^-1 r with the fine level sharded: smoothing and
        residuals are halo-window SpMVs; each shard restricts its slab,
        the coarse residual is summed over the shards (disjoint coarse
        planes, the shared one from its right owner) on every distinct
        device, which runs the single-device inner V-cycle on it; each
        shard prolongs its coarse x-range of the correction."""
        plan = self.plan
        omega, steps = self._omega, self._smooth_steps
        nxl, ps = plan.nxl, plan.ps
        half = nxl // 2
        nyc, nzc, nxc = plan.ny // 2, plan.nz // 2, plan.nx // 2

        def smooth(xs, bs):
            for _ in range(steps):
                ax = self._apply_a(values_t, xs)
                xs = [x + omega * m * (b - a)
                      for x, m, b, a in zip(xs, minv, bs, ax)]
            return xs

        xs = smooth([torch.zeros_like(r) for r in rs], rs)
        ax = self._apply_a(values_t, xs)
        r1 = [torch.where(f, r.new_zeros(()), r - a)
              for f, r, a in zip(fixed_s, rs, ax)]
        coarse = []
        for r_ext in _fetch_halos(plan, r1):
            c = _restrict_x_local(plan, r_ext).reshape(
                half + 1, plan.ny + 1, plan.nz + 1, 3)
            coarse.append(_restrict_axis(_restrict_axis(c, 1), 2))

        corrections = {}
        for dev, (inner, fixed_c, values_c, spmv) in self._mg.items():
            full = torch.zeros((nxc + 1, nyc + 1, nzc + 1, 3),
                               dtype=self.dtype, device=dev)
            last = len(coarse) - 1
            for d, c in enumerate(coarse):
                n = half + 1 if d == last else half
                full[d * half : d * half + n] += to(c[:n], dev)
            rc = full.reshape(-1).masked_fill(fixed_c, 0.0)
            ec = inner.precondition(values_c, rc, spmv=spmv)
            corrections[dev] = ec.masked_fill(fixed_c, 0.0).reshape(
                nxc + 1, nyc + 1, nzc + 1, 3)

        out = []
        for d, (x, f) in enumerate(zip(xs, fixed_s)):
            c_slab = corrections[x.device][d * half : d * half + half + 1]
            e = _interp_axis(_interp_axis(c_slab, 1), 2)
            e = _prolong_x_local(plan, e.reshape(half + 1, ps)).reshape(-1)
            out.append(x + e.masked_fill(f, 0.0))
        return smooth(out, rs)

    def _ensure_mg_operands(self, fixed: np.ndarray):
        """Build (or rebuild on a mask change) the coarse hierarchy of the
        multigrid for this fixed mask, once per distinct device."""
        if self._preconditioner != "multigrid":
            return
        fixed = np.asarray(fixed, bool)
        if self._mg is not None and np.array_equal(self._mg_mask, fixed):
            return
        self._mg_mask = fixed.copy()
        plan = self.plan
        m = fixed.reshape(plan.nx + 1, plan.ny + 1, plan.nz + 1, 3)
        fixed_c = np.ascontiguousarray(m[::2, ::2, ::2, :]).reshape(-1)
        self._mg = None  # release the old hierarchies first
        mg, vc = {}, None
        for dev in dict.fromkeys(self.devices):
            inner = StructuredMultigrid(
                self._coarse, self._material, fixed_c, omega=self._omega,
                smooth_steps=self._smooth_steps, device=dev, dtype=self.dtype)
            dia_c = inner.levels[0].dia
            if vc is None:
                vc = inner._assemble_level_host(self._coarse, dia_c, fixed_c)
            values_c = torch.as_tensor(vc, dtype=self.dtype, device=dev)
            sp = k_spmv.spmv_plan(dia_c.n_dof, dia_c.offsets, dev)
            values_ct = k_spmv.prep_values(sp, values_c)
            spmv = (lambda _v, vt=values_ct: vt,
                    lambda vt, x, sp=sp: k_spmv.spmv(sp, vt, x))
            mg[dev] = (inner, torch.as_tensor(fixed_c, device=dev), values_c,
                       spmv)
        self._mg = mg

    # ------------------------------------------------------------------ #
    # public
    # ------------------------------------------------------------------ #
    def solve(self, rhs: np.ndarray, fixed: np.ndarray, sval: np.ndarray):
        """K x = rhs with the Dirichlet elimination, slab by slab: the
        assembly, the elimination and the PCG.  Returns (x (n_dof,) numpy,
        iterations)."""
        plan = self.plan
        self._ensure_mg_operands(fixed)
        rhs_s, fixed_s, sval_s = (self.stack(rhs), self.stack(fixed),
                                  self.stack(sval))
        values = self._assemble()
        fixed_ext = _fetch_halos(plan, fixed_s)
        sval_ext = _fetch_halos(plan, sval_s)
        bs = []
        for d in range(plan.n_devices):
            values[d], b = _dirichlet_local(plan, values[d], rhs_s[d],
                                            fixed_s[d], fixed_ext[d],
                                            sval_ext[d], sval_s[d])
            bs.append(b)
        xs, iters, _ = self._pcg_solve(values, bs, fixed_s)
        return self.unstack(Blocks(xs)), iters

    def stack(self, v) -> Blocks:
        """Global (n_dof,) vector (numpy or tensor) -> its slab blocks, one
        on each shard's device (the shared plane on both owners); a bool
        vector stays bool, any other takes the solver's dtype."""
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        v = np.asarray(v)
        dt = torch.bool if v.dtype == bool else self.dtype
        return Blocks(torch.as_tensor(b, dtype=dt, device=dev)
                      for b, dev in zip(stack_rows(self.plan, v),
                                        self.devices))

    def unstack(self, blocks) -> np.ndarray:
        """Slab blocks -> global (n_dof, ...) numpy of the owned rows."""
        return unstack_rows(self.plan, np.stack(
            [b.cpu().numpy() for b in blocks]))

    def newton_eval(self, dof_s, rhs_s, fixed_s, sval_s, stab_s=None):
        """One Newton evaluation on every slab (femcy_tpu's
        ``_shard_newton_eval``): pin the prescribed dofs, the deformation
        gradient from the broadcast initial gradients, the Cauchy stress,
        the internal force (M5) and the tangent (P2; the secant + geometric
        or the consistent one), each with its plane halo-add, the
        stabilization / Newmark hook when ``stab_s`` = (diagonal blocks,
        reference blocks, 0-d scale) is given, the Newton Dirichlet
        treatment and the rms over owned rows.  Returns (pinned dof,
        treated tangent, treated residual, rms as a 0-d tensor)."""
        plan, slab, slab_plan = self.plan, self._slab, self._slab_plan
        dofs, f_int, values = [], [], []
        for dof, fixed, sval in zip(dof_s, fixed_s, sval_s):
            ops = self._operands(dof.device)
            dof = torch.where(fixed, sval, dof)
            u_e = structured_element_nodes(dof.reshape(-1, 3), slab)
            F = assembly.deformation_gradient_u(u_e, ops.dsdX0)
            sigma = assembly.gp_stress(F, self._material, large=True)
            dsdx, vol = assembly.gradients_and_volume_x(ops.x0_e + u_e,
                                                        ops.dN, ops.w)
            f_elem = assembly.element_internal_force(dsdx, sigma, vol)
            f_int.append(force_scatter(f_elem.contiguous(), slab_plan, slab))
            if self._tangent == "consistent":
                Ke = assembly.consistent_tangent_elems(
                    u_e, ops.x0_e, ops.dN, ops.w, self._material)
            else:
                Ke = assembly.element_stiffness(dsdx, vol, ops.C)
                if self._geometric_stiffness:
                    Ke += assembly.geometric_stiffness(dsdx, sigma, vol)
            values.append(structured_dia_scatter(Ke, slab_plan))
            dofs.append(dof)
        f_int = _halo_add(plan, f_int)
        values = _halo_add(plan, values)
        if stab_s is not None:
            # the stabilization / Newmark inertia hook, before the
            # Dirichlet treatment; elementwise on local rows, so the
            # shared plane stays equal on both owners
            diag_s, ref_s, scale = stab_s
            for d in range(plan.n_devices):
                dd = to(scale, diag_s[d].device) * diag_s[d]
                f_int[d] = f_int[d] + dd * (dofs[d] - ref_s[d])
                values[d][:, plan.diag_idx] += dd
        fixed_ext = _fetch_halos(plan, fixed_s)
        residuals, sq = [], []
        for d in range(plan.n_devices):
            values[d], res = _dirichlet_newton_local(
                plan, values[d], f_int[d] - rhs_s[d], fixed_s[d], fixed_ext[d])
            residuals.append(res)
            sq.append((self._own[d] * res * res).sum())
        rms = torch.sqrt(psum(sq) / plan.n_dof)
        return Blocks(dofs), Blocks(values), Blocks(residuals), rms

    def cg(self, values_s, b_s, fixed: np.ndarray, fixed_s):
        """The PCG on treated slab blocks (the Newton linear solve).
        ``fixed`` (global, host) keys the multigrid's hierarchy;
        ``fixed_s`` (its blocks) feeds the V-cycle's transfer masks.
        Returns (x blocks, iterations, max|own r|)."""
        self._ensure_mg_operands(fixed)
        xs, iters, rmax = self._pcg_solve(list(values_s), list(b_s), fixed_s)
        return Blocks(xs), iters, rmax


def _inv_diag(values, diag_idx: int):
    diag = values[:, diag_idx]
    return torch.where(diag != 0.0, 1.0 / diag, torch.zeros_like(diag))
