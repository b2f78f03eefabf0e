"""Multi-element-type / multi-material models: per-block assembly.

Torch counterpart of ``femcy_tpu.multiblock``.  Every ``ElementBlock``
carries its own connectivity, element type and material (Abaqus
``*Element, type=..., elset=...`` blocks mapped to materials through
``*Solid Section``); the global sparsity is the union of the blocks' graphs,
one padded-ELL pattern shared by all of them.

- ``build_union_pattern`` builds that union on the host at node level
  (E * npe^2 node-pair keys, not femcy_tpu's E * edof^2 dof keys) and
  expands it to the same dof-level arrays; each block keeps its node-block
  map into it, from which ``kernels.ell_scatter.build_scatter_plan`` makes
  the block's scatter plan.
- Assembly runs the stiffness scatter (M1) once per block over the union
  pattern and sums the blocks' outputs in block order, as femcy_tpu sums
  its per-block segment sums; nodes a block does not touch come out of its
  scatter as zero rows.  The Newton evaluation sums each block's internal
  force through M4 the same way.
- The Dirichlet elimination and the linear solve are the single-block
  ones: host direct below ``direct_solve_max_dof``, else the AMG-PCG
  (``preconditioner="amg"``, its hierarchy built from the f64 host twin as
  femcy_tpu builds it, its applies through M3) or the Jacobi ELL-PCG (M2).
- Geometric-nonlinear analyses run ``system.run_newton`` under femcy_tpu's
  adaptive load stepping, per-block kinematics and stress with each
  block's own material.
- ``dynamic_rescue`` runs the Newmark traversal shared with FEMSystem
  (``system.dynamic_traverse``) over this class's twins of its hooks: the
  inertia force and diagonal added before the Dirichlet treatment
  (``_stab_diag``, ``_stab_ref``, ``_stab_scale``), the lumped volume
  diagonal summed block by block and the tangent's diagonal.

Every tensor lives on the ``device`` given to ``MultiBlockSystem`` (the
card unless "cpu").
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time as _time
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from femcy_tpu_torch import assembly, bc as bc_mod
from femcy_tpu_torch.assembly_host import (
    dirichlet_csr_host,
    element_stiffness_block_host,
)
from femcy_tpu_torch.config import SolverConfig
from femcy_tpu_torch.elements import ElementType
from femcy_tpu_torch.kernels import bell_spmv as k_bell
from femcy_tpu_torch.kernels import ell_spmv
from femcy_tpu_torch.kernels.ell_scatter import (
    ScatterPlan,
    build_scatter_plan,
    scatter,
)
from femcy_tpu_torch.kernels.internal_force import scatter_force
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.solvers.amg import AlgebraicMultigrid
from femcy_tpu_torch.solvers.bell import build_bell_plan
from femcy_tpu_torch.solvers.cg import (
    dense_pcg_solve,
    ell_to_dense,
    gather_spmv,
    pcg_solve,
)
from femcy_tpu_torch.solvers.direct import direct_solve
from femcy_tpu_torch.system import (
    SolveReport,
    _rms,
    cg_done,
    default_dtype,
    dynamic_traverse,
    mises_stress,
    run_increments,
    run_newton,
)
from femcy_tpu_torch.topology import ELLPattern, colidx_valid_mask
from femcy_tpu_torch.utils.device import resolve_device
from femcy_tpu_torch.utils.timing import seconds_since

logger = logging.getLogger("femcy_tpu_torch")


@dataclasses.dataclass
class ElementBlock:
    """One homogeneous group of elements sharing a type and a material."""

    elements: np.ndarray  # (E, n) int32, 0-based into the shared nodes
    element: ElementType
    material: Material
    name: str = ""


def _element_dofs(elements: np.ndarray, dm: int) -> np.ndarray:
    """(E, npe * dm) int32 global dof of each element dof."""
    el = np.asarray(elements, dtype=np.int64)
    return (el[:, :, None] * dm + np.arange(dm)).reshape(
        el.shape[0], -1).astype(np.int32)


def build_union_pattern(
    n_dof: int, dm: int, blocks: List[ElementBlock]
) -> Tuple[ELLPattern, List[np.ndarray]]:
    """Shared ELL pattern over all blocks + each block's node-block map.

    Returns (pattern, block_targets): the pattern's dof-level arrays
    (``colidx``, ``row_counts``, ``valid``, ``diag_slot``, the CSR mirror)
    equal femcy_tpu's ``build_union_pattern``'s; ``pattern.node_width`` is
    its width / dm; ``block_targets[b]`` (E_b * npe_b^2,) is the node-ELL
    slot n * node_width + pos of every (element, a, b) node pair of block b,
    element order.  Every element couples all dm dofs of its nodes, so the
    union is built over node-pair keys and each dof row's sorted columns are
    the node row's, dm at a time.
    """
    n_nodes = n_dof // dm
    keys_per_block = []
    for blk in blocks:
        el = np.asarray(blk.elements, dtype=np.int64)
        npe = el.shape[1]
        rows = np.broadcast_to(el[:, :, None], (el.shape[0], npe, npe))
        cols = np.broadcast_to(el[:, None, :], (el.shape[0], npe, npe))
        keys_per_block.append((rows * np.int64(n_nodes) + cols).reshape(-1))
    uniq, inv = np.unique(np.concatenate(keys_per_block), return_inverse=True)
    row_of = uniq // n_nodes
    node_counts = np.bincount(row_of, minlength=n_nodes)
    node_width = int(node_counts.max())
    node_start = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(node_counts, out=node_start[1:])
    pos = np.arange(uniq.shape[0], dtype=np.int64) - node_start[row_of]

    diag_keys = np.arange(n_nodes, dtype=np.int64) * (n_nodes + 1)
    # clipped: a diagonal key past the last one is missing too
    diag_idx = np.minimum(np.searchsorted(uniq, diag_keys), uniq.shape[0] - 1)
    if not np.array_equal(uniq[diag_idx], diag_keys):
        raise RuntimeError(
            "model has dofs carried by no element (missing diagonal)"
        )

    # node level -> dof level: dof row n*dm + i holds columns
    # ncol[n, k]*dm + j at position k*dm + j
    node_col = np.zeros((n_nodes, node_width), dtype=np.int64)
    node_col[row_of, pos] = uniq % n_nodes
    node_valid = colidx_valid_mask(node_col, node_counts)
    width = dm * node_width
    sub = np.arange(dm, dtype=np.int64)
    colidx = np.where(
        node_valid[:, None, :, None],
        node_col[:, None, :, None] * dm + sub[None, None, None, :],
        0,
    )
    colidx = np.broadcast_to(colidx, (n_nodes, dm, node_width, dm)).reshape(
        n_dof, width).astype(np.int32)
    row_counts = np.repeat(dm * node_counts, dm)
    valid = colidx_valid_mask(colidx, row_counts)
    csr_indptr = np.zeros(n_dof + 1, dtype=np.int64)
    np.cumsum(row_counts, out=csr_indptr[1:])
    diag_slot = ((np.arange(n_dof, dtype=np.int64) * width)
                 + np.repeat(pos[diag_idx] * dm, dm) + np.tile(sub, n_nodes))

    node_slot = row_of * node_width + pos
    bt_dtype = np.int32 if n_nodes * node_width < 2**31 else np.int64
    block_targets = []
    start = 0
    for k in keys_per_block:
        block_targets.append(node_slot[inv[start:start + k.shape[0]]]
                             .astype(bt_dtype))
        start += k.shape[0]
    dofs0 = _element_dofs(blocks[0].elements, dm)
    pattern = ELLPattern(
        n_dof=n_dof,
        width=width,
        colidx=colidx,
        row_counts=row_counts.astype(np.int32),
        valid=valid,
        diag_slot=diag_slot,
        force_targets=np.concatenate(
            [_element_dofs(b.elements, dm).reshape(-1) for b in blocks]),
        element_dofs=dofs0,
        csr_indptr=csr_indptr,
        csr_indices=colidx[valid],
        csr_slots=np.flatnonzero(valid),
        node_width=node_width,
    )
    return pattern, block_targets


def block_pattern(pattern: ELLPattern, blk: ElementBlock,
                  block_targets: np.ndarray) -> ELLPattern:
    """The union pattern seen by one block: its element dofs and its
    node-block map (what ``build_scatter_plan`` reads)."""
    dofs = _element_dofs(blk.elements, pattern.width // pattern.node_width)
    return dataclasses.replace(pattern, element_dofs=dofs,
                               force_targets=dofs.reshape(-1),
                               block_targets=block_targets)


def union_values_host(nodes: np.ndarray, blocks: List[ElementBlock],
                      block_targets: List[np.ndarray],
                      pattern: ELLPattern) -> np.ndarray:
    """The raw (no-BC) f64 union operator's ELL values (n_dof, W) from the
    blocks' host element stiffnesses (``assembly_host``).

    Bit for bit femcy_tpu's ``np.add.at`` of every block's Ke over its dof
    targets, block after block: each of the dm^2 (i, j) dof offsets is one
    ``np.bincount`` of the blocks' Ke[:, a, i, b, j] over their node-block
    maps, concatenated in block order, so every slot sums the same values
    from 0 in the same order, without the E * edof^2 dof-level targets."""
    dm = pattern.width // pattern.node_width
    nw = pattern.node_width
    n_nodes = pattern.n_dof // dm
    Kes = []
    for blk in blocks:
        Ke = element_stiffness_block_host(nodes, blk.elements, blk.element,
                                          np.asarray(blk.material.C))
        npe = blk.element.n_nodes
        Kes.append(Ke.reshape(Ke.shape[0], npe, dm, npe, dm))
    idx = np.concatenate([np.asarray(bt, dtype=np.int64)
                          for bt in block_targets])
    out = np.empty((n_nodes, dm, nw, dm))
    for i in range(dm):
        for j in range(dm):
            w = np.concatenate([Ke[:, :, i, :, j].reshape(-1) for Ke in Kes])
            out[:, i, :, j] = np.bincount(
                idx, weights=w, minlength=n_nodes * nw).reshape(n_nodes, nw)
    return out.reshape(pattern.n_dof, pattern.width)


class MultiBlockSystem:
    """Static analysis over heterogeneous element blocks.

    API of femcy_tpu.MultiBlockSystem (nodes, blocks, config) plus the torch
    ``device`` of every tensor (the card unless "cpu"; CUDA without a card
    raises); the dtype is ``system.default_dtype()``.
    """

    def __init__(
        self,
        nodes: np.ndarray,
        blocks: List[ElementBlock],
        config: SolverConfig = SolverConfig(),
        device="cuda",
    ):
        if not blocks:
            raise ValueError("need at least one element block")
        self.nodes = np.asarray(nodes, dtype=np.float64)
        self.dm = self.nodes.shape[1]
        dms = {blk.element.dm for blk in blocks}
        if dms != {self.dm}:
            raise ValueError(f"mixed element dimensionalities: {dms}")
        device = resolve_device(device)
        dtype = default_dtype()
        self.blocks = blocks
        self.config = config
        self.device = device
        self.dtype = dtype
        self.n_dof = self.nodes.shape[0] * self.dm

        sync = torch.cuda.synchronize if device.type == "cuda" else None
        #: setup phase walls (seconds, synchronised on CUDA)
        init_s = {}
        self._init_seconds = init_s

        def phase(name, fn):
            t = _time.perf_counter()
            out = fn()
            if sync is not None:
                sync()
            init_s[name] = _time.perf_counter() - t
            return out

        self.pattern, self._block_targets = phase(
            "union_pattern",
            lambda: build_union_pattern(self.n_dof, self.dm, blocks))
        #: one M1/M4 plan per block over the union pattern
        self._plans: List[ScatterPlan] = phase("plans", lambda: [
            build_scatter_plan(block_pattern(self.pattern, blk, bt), device)
            for blk, bt in zip(blocks, self._block_targets)])

        def tensor(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        def upload():
            arrs = {
                "nodes": tensor(self.nodes),
                "colidx": tensor(self.pattern.colidx, torch.int64),
                "diag_slot": tensor(self.pattern.diag_slot, torch.int64),
            }
            per_block = [{
                "elements": tensor(blk.elements, torch.int64),
                "dN": tensor(blk.element.dshape_at_gp),
                "w": tensor(blk.element.gauss_weights),
                "C": tensor(blk.material.C),
            } for blk in blocks]
            return arrs, per_block

        self._arrs, self._block_arrs = phase("upload", upload)

        def gradients():
            # initial-configuration gradients: the F = I + du/dX reference
            for ba in self._block_arrs:
                ba["dsdX0"], ba["vol0"] = assembly.gradients_and_volume(
                    self._arrs["nodes"], ba["elements"], ba["dN"], ba["w"])

        phase("gradients", gradients)

        # the Jacobi PCG's SpMV: M2 on the union pattern, or the plain one
        self._spmv = (gather_spmv(self._arrs["colidx"])
                      if config.spmv == "slices"
                      else ell_spmv.make_spmv(self.pattern, device))
        # nonlinear-analysis state (mirrors FEMSystem)
        self.geometric_nonlinear = False
        self.dt = 0.0
        self.time0 = self.time1 = 0.0
        self._ini_residual: Optional[float] = None
        #: CG iterations of the most recent CG solve, and of every one
        self._last_cg_iters: int = 0
        self._cg_iters_log: List[int] = []
        # the AMG (lazy: needs the fixed-dof mask)
        self._amg: Optional[AlgebraicMultigrid] = None
        self._amg_fixed_key: Optional[bytes] = None
        self._amg_fixed_obj = None
        self._amg_raw_csr = None  # cached no-BC f64 host operator
        self._bell_plan = None  # M3's host block plan of the union pattern
        self._bell_fine: Optional[k_bell.FinePlan] = None
        #: host walls (seconds) of the last hierarchy build, by phase
        self._amg_host_seconds: dict = {}
        self._block_meshes: dict = {}
        self.dof = torch.zeros(self.n_dof, dtype=dtype, device=device)
        #: the rescue's Newmark inertia (the stabilization hook of
        #: FEMSystem): the lumped diagonal, the predictor and the 0-d
        #: scale of the force scale * diag * (dof - ref); None when off
        self._stab_diag: Optional[torch.Tensor] = None
        self._stab_ref: Optional[torch.Tensor] = None
        self._stab_scale: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ #
    def _tensor(self, a, dt=None):
        return torch.as_tensor(a, dtype=dt or self.dtype, device=self.device)

    def _scalar(self, value: float) -> torch.Tensor:
        """A 0-d tensor of the system's dtype and device."""
        return torch.tensor(value, dtype=self.dtype, device=self.device)

    def _block_values(self, bi: int, Ke) -> torch.Tensor:
        """Block bi's element matrices scattered into the union layout by
        M1 (its plain version on the CPU); untouched rows are zero."""
        return scatter(Ke.contiguous(), self._plans[bi])

    def _linear_system(self, rhs, fixed, sval):
        """sum_b M1(Ke_b) in block order, then the linear Dirichlet
        elimination (femcy_tpu's _system_impl)."""
        values = None
        for bi, ba in enumerate(self._block_arrs):
            Ke = assembly.element_stiffness(ba["dsdX0"], ba["vol0"], ba["C"])
            v = self._block_values(bi, Ke)
            values = v if values is None else values + v
        return bc_mod.apply_dirichlet_linear(
            values, self._arrs["colidx"], self._arrs["diag_slot"], rhs,
            fixed, sval)

    def _newton_eval(self, dof, rhs, fixed, sval):
        """One residual/Jacobian evaluation over all blocks (femcy_tpu's
        _newton_eval_impl): pin prescribed dofs; per block F (initial
        configuration), the large-deformation Cauchy stress of its
        material, the current-configuration gradients, the internal force
        (M4) and the tangent (M1), each summed into the union arrays in
        block order; the rescue's inertia force and diagonal when on; then
        the Newton Dirichlet treatment."""
        a = self._arrs
        cfg = self.config
        dof = bc_mod.pin_dof(dof, fixed, sval)
        coords = a["nodes"] + dof.reshape(-1, self.dm)
        values = f_int = None
        for bi, (blk, ba) in enumerate(zip(self.blocks, self._block_arrs)):
            F = assembly.deformation_gradient(dof, ba["elements"], ba["dsdX0"])
            dsdx, vol = assembly.gradients_and_volume(
                coords, ba["elements"], ba["dN"], ba["w"])
            sigma = assembly.gp_stress(F, blk.material, large=True)
            f_e = assembly.element_internal_force(dsdx, sigma, vol)
            f_b = scatter_force(f_e.contiguous(), self._plans[bi])
            f_int = f_b if f_int is None else f_int + f_b
            if cfg.tangent == "consistent":
                Ke = assembly.consistent_tangent(
                    dof, ba["elements"], a["nodes"], ba["dN"], ba["w"],
                    blk.material)
            else:
                Ke = assembly.element_stiffness(dsdx, vol, ba["C"])
                if cfg.geometric_stiffness:
                    Ke += assembly.geometric_stiffness(dsdx, sigma, vol)
            v = self._block_values(bi, Ke)
            values = v if values is None else values + v
        if self._stab_diag is not None:
            # before the Dirichlet treatment, so constrained rows stay
            # zero-one
            d = self._stab_scale * self._stab_diag
            f_int = f_int + d * (dof - self._stab_ref)
            values.view(-1)[a["diag_slot"]] += d
        values, residual = bc_mod.apply_dirichlet_newton(
            values, a["colidx"], a["diag_slot"], f_int - rhs, fixed)
        return dof, values, residual, _rms(residual)

    def _solve_values(self, values, b, fixed):
        """Linear solve of the assembled (values, b) by femcy_tpu's ladder:
        host direct below the crossover, else the AMG-PCG
        (preconditioner="amg"), else the dense small-model CG
        (``dense_operator_max_dof``), else the Jacobi ELL-PCG."""
        cfg = self.config
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto"
            and self.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            x = direct_solve(self.pattern, values.cpu().numpy(),
                             b.cpu().numpy())
            return self._tensor(x)
        if cfg.preconditioner == "amg":
            self._ensure_amg(fixed)
            max_iters = cfg.cg_max_iters if cfg.cg_max_iters > 0 else self.n_dof
            # the eliminated operator in M3's layout, once per solve
            fine = k_bell.from_ell(self._bell_fine, values)
            x, iters, rmax = self._amg.pcg_solve(
                b, lambda v: k_bell.spmv(fine, v), eps=cfg.cg_eps,
                max_iters=max_iters)
            return cg_done(self, self.n_dof, "AMG-CG", x, iters, rmax, b)
        if 0 < cfg.dense_operator_max_dof and (
                self.n_dof <= cfg.dense_operator_max_dof):
            # the small-model dense CG: the union operator placed into a
            # dense matrix once per solve
            x, iters, rmax = dense_pcg_solve(
                ell_to_dense(values, self._arrs["colidx"], self.n_dof), b,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                block_dm=(self.dm if cfg.preconditioner == "block_jacobi"
                          else 0))
        else:
            x, iters, rmax = pcg_solve(
                values, self._arrs["colidx"], self._arrs["diag_slot"], b,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters, spmv=self._spmv)
        return cg_done(self, self.n_dof, "CG", x, iters, rmax, b)

    def _ensure_amg(self, fixed):
        """Smoothed-aggregation hierarchy over the union operator, built
        as femcy_tpu's MultiBlockSystem builds it: from the f64 host twin
        (every block's host element stiffnesses summed into the union
        pattern, ``union_values_host``), Dirichlet-eliminated on the host;
        kept while the fixed-dof mask holds.  ``_amg_host_seconds`` splits
        the host walls (the twin is cached across masks)."""
        if self._amg is not None and fixed is self._amg_fixed_obj:
            return
        wall0 = _time.perf_counter()
        fixed_np = fixed.cpu().numpy().astype(bool)
        key = fixed_np.tobytes()
        if self._amg is not None and self._amg_fixed_key == key:
            self._amg_fixed_obj = fixed
            return
        host_s = {}
        if self._amg_raw_csr is None:
            t = _time.perf_counter()
            vals = union_values_host(self.nodes, self.blocks,
                                     self._block_targets, self.pattern)
            self._amg_raw_csr = self.pattern.to_scipy(vals)
            host_s["host_twin"] = _time.perf_counter() - t
        t = _time.perf_counter()
        zeros = np.zeros(self.n_dof)
        K_bc, _ = dirichlet_csr_host(self._amg_raw_csr, zeros, fixed_np, zeros)
        host_s["dirichlet"] = _time.perf_counter() - t
        if self._bell_plan is None:
            t = _time.perf_counter()
            self._bell_plan = build_bell_plan(self.pattern, self.dm)
            self._bell_fine = k_bell.fine_plan(self._bell_plan, self.device)
            host_s["bell_plan"] = _time.perf_counter() - t
        self._amg = None  # release the old hierarchy before the new one
        self._amg = AlgebraicMultigrid(K_bc, self.dm, self.nodes, fixed_np,
                                       dtype=self.dtype, device=self.device)
        self._amg_fixed_key = key
        self._amg_fixed_obj = fixed
        host_s["unattributed"] = (
            _time.perf_counter() - wall0 - sum(host_s.values())
            - self._amg.setup_seconds["total"])
        self._amg_host_seconds = host_s
        if self.config.verbose:
            logger.info("amg: %d levels %s; host %s, setup %s",
                        self._amg.n_levels,
                        [lv.n_dof for lv in self._amg.levels], host_s,
                        self._amg.setup_seconds)

    # ------------------------------------------------------------------ #
    def solve(self, rhs, fixed, sval):
        """K x = rhs with symmetric Dirichlet elimination (numpy arrays or
        tensors); sets self.dof."""
        fixed = torch.as_tensor(fixed, dtype=torch.bool, device=self.device)
        values, b = self._linear_system(self._tensor(rhs), fixed,
                                        self._tensor(sval))
        self.dof = self._solve_values(values, b, fixed)
        return self.dof

    def _neumann_unit_pattern(self, nbc) -> np.ndarray:
        """Unit nodal-force pattern of one *Dsload summed over blocks: each
        facet goes to the block whose boundary owns it (its quadrature
        needs that block's shape functions)."""
        pattern = np.zeros(self.n_dof)
        remaining = [tuple(f) for f in nbc.face_set]
        for bi in range(len(self.blocks)):
            mesh_b = self.block_mesh(bi)
            owned = [f for f in remaining if f in mesh_b.boundary]
            if not owned:
                continue
            sub = dataclasses.replace(nbc, face_set=owned)
            pattern += bc_mod.neumann_unit_pattern(mesh_b, sub)
            owned_set = set(owned)
            remaining = [f for f in remaining if f not in owned_set]
        if remaining:
            raise ValueError(
                f"{len(remaining)} loaded facet(s) are on no "
                "block's boundary (e.g. an interior *Surface)"
            )
        return pattern

    def solve_model(self, model, **solve_kwargs) -> torch.Tensor:
        """Solve a read_inp_multi model: one increment at full load, or the
        adaptive-load-stepping Newton analysis for ``nlgeom`` models
        (``solve_nonlinear``; the report lands in ``self.last_report``)."""
        if getattr(model, "geometric_nonlinear", False):
            report = self.solve_nonlinear(model, **solve_kwargs)
            if not report.success:
                raise RuntimeError(
                    f"nonlinear multi-block analysis failed: {report.message}"
                )
            return self.dof

        fixed = np.zeros(self.n_dof, dtype=bool)
        sval = np.zeros(self.n_dof)
        for bcd in model.dirichlet_bcs:
            dofs = bcd.node_set * self.dm + bcd.dof
            fixed[dofs] = True
            sval[dofs] = bcd.value
        rhs = np.zeros(self.n_dof)
        for nbc in getattr(model, "neumann_bcs", []):
            rhs += nbc.traction * self._neumann_unit_pattern(nbc)
        return self.solve(rhs, fixed, sval)

    # ------------------------------------------------------------------ #
    # geometric-nonlinear analysis (ref: stiffnessMtrx.py:647-822)
    # ------------------------------------------------------------------ #
    def _advance_inc(self, rhs, fixed, sval, on_newton=None):
        """One nonlinear load increment: the shared Newton state machine
        driven by the multi-block evaluator."""
        newton_count = {"n": -1}

        def evaluate(dof):
            dof, values, residual, res = self._newton_eval(dof, rhs, fixed,
                                                           sval)
            res = float(res)  # the evaluation's one read-back
            newton_count["n"] += 1
            if on_newton is not None:
                self.dof = dof
                on_newton(self, newton_count["n"], res)
            return dof, values, residual, res

        def lin_solve(values, residual, reuse=None):
            return self._solve_values(values, residual, fixed)

        def finish(dof):
            self.dof = dof

        converged, loops, res, self._ini_residual = run_newton(
            self.dof, evaluate, lin_solve, finish, self.config,
            self._ini_residual,
        )
        return converged, loops, res

    def _lumped_volume_diag(self) -> torch.Tensor:
        """Unit-density volume-lumped nodal diagonal, one entry per dof,
        summed over the blocks in block order (host): the rescue's mass."""
        nodal = np.zeros(self.nodes.shape[0])
        for blk, ba in zip(self.blocks, self._block_arrs):
            ev = ba["vol0"].cpu().numpy().sum(axis=1)
            npe = blk.element.n_nodes
            np.add.at(nodal, blk.elements.reshape(-1), np.repeat(ev / npe, npe))
        return self._tensor(np.repeat(nodal, self.dm))

    def _tangent_diag_host(self, rhs, fixed, sval) -> np.ndarray:
        """Diagonal of the Dirichlet-treated union tangent at the current
        state, on the host."""
        _, values, _, _ = self._newton_eval(self.dof, rhs, fixed, sval)
        return values.view(-1)[self._arrs["diag_slot"]].cpu().numpy()

    def solve_nonlinear(self, model, user_dirichlet=None, on_increment=None,
                        on_newton=None) -> SolveReport:
        """Adaptive-load-stepping geometric-nonlinear analysis over all
        blocks: femcy_tpu's state machine (dt cutback with dof rollback,
        growth after fast convergence, min_inc abort, the dynamic rescue),
        ``run_increments`` shared with FEMSystem.solve."""
        t_start = _time.perf_counter()
        self.geometric_nonlinear = True
        self.dt = model.time_incs["ini_inc"]
        self.time0 = self.time1 = 0.0
        self.dof = torch.zeros_like(self.dof)
        # build_dirichlet_arrays only touches n_dof/dm/nodes of its mesh
        mesh_view = SimpleNamespace(n_dof=self.n_dof, dm=self.dm,
                                    nodes=self.nodes)
        nbcs = getattr(model, "neumann_bcs", [])
        patterns = (
            np.stack([self._neumann_unit_pattern(nbc) for nbc in nbcs])
            if nbcs else np.zeros((0, self.n_dof))
        )
        tractions_d = self._tensor(np.array([nbc.traction for nbc in nbcs]))
        patterns_d = self._tensor(patterns)

        def boundary(time1, load_ratio):
            fixed, sval = bc_mod.build_dirichlet_arrays(
                model.dirichlet_bcs, mesh_view, time1, load_ratio,
                user_dirichlet,
            )
            if patterns.shape[0]:
                rhs = (tractions_d * load_ratio) @ patterns_d
            else:
                rhs = torch.zeros_like(self.dof)
            return (rhs, torch.as_tensor(fixed, device=self.device),
                    self._tensor(sval))

        records, success, message = run_increments(
            self, model.time_incs, boundary, on_newton, on_increment,
            rescue=(functools.partial(dynamic_traverse, self)
                    if self.config.dynamic_rescue else None))
        self.last_report = SolveReport(
            success=success, increments=records,
            wall_time=seconds_since(t_start, self.device), message=message,
        )
        return self.last_report

    # ------------------------------------------------------------------ #
    def block_mesh(self, bi: int) -> FEMesh:
        """FEMesh view of block bi over the shared node table (cached:
        boundary extraction is the expensive part)."""
        if bi not in self._block_meshes:
            blk = self.blocks[bi]
            self._block_meshes[bi] = FEMesh(self.nodes, blk.elements,
                                            blk.element)
        return self._block_meshes[bi]

    def extrapolate_block(self, bi: int, gp_vals):
        """GP -> nodal patch extrapolation with block bi's own element
        matrix, (E_bi, G_bi) -> (E_bi, n_nodes_bi)."""
        M = torch.as_tensor(self.blocks[bi].element.extrapolation_matrix,
                            dtype=gp_vals.dtype, device=gp_vals.device)
        return gp_vals @ M.T

    def elastic_energy(self) -> float:
        """Total elastic energy summed over blocks: each block's psi(F)
        integrated with its GP volumes on the initial configuration
        (linear) or the current one (nonlinear), as femcy_tpu does."""
        coords = self._arrs["nodes"]
        if self.geometric_nonlinear:
            coords = coords + self.dof.reshape(-1, self.dm)
        total = 0.0
        for blk, ba in zip(self.blocks, self._block_arrs):
            F = assembly.deformation_gradient(self.dof, ba["elements"],
                                              ba["dsdX0"])
            _, vol = assembly.gradients_and_volume(
                coords, ba["elements"], ba["dN"], ba["w"])
            dens = assembly.gp_energy_density(F, blk.material)
            total += float((dens * vol).sum())
        return total

    def block_stress(self, bi: int, large: Optional[bool] = None):
        """(strain, Cauchy stress, Mises) per (element, GP) of block bi:
        Green strain and the large-deformation stress when ``large`` (by
        default: the analysis mode of the last solve), else small."""
        if large is None:
            large = self.geometric_nonlinear
        blk, ba = self.blocks[bi], self._block_arrs[bi]
        F = assembly.deformation_gradient(self.dof, ba["elements"],
                                          ba["dsdX0"])
        eye = torch.eye(self.dm, dtype=F.dtype, device=F.device)
        if large:
            strain = (F.transpose(-1, -2) @ F - eye) / 2.0
        else:
            strain = (F + F.transpose(-1, -2)) / 2.0 - eye
        stress = assembly.gp_stress(F, blk.material, large=large)
        return strain, stress, mises_stress(stress, blk.material)


def system_from_model(model, config: SolverConfig = SolverConfig(),
                      device="cuda") -> MultiBlockSystem:
    """InpBlockModel (io.inp.read_inp_multi) -> MultiBlockSystem."""
    from femcy_tpu_torch.elements import get_element
    from femcy_tpu_torch.materials import material_from_inp

    blocks = []
    for bi, (etype, elset, elements) in enumerate(model.element_blocks):
        mtype, params = model.material_of_block(bi)
        blocks.append(ElementBlock(
            elements=elements,
            element=get_element(etype),
            material=material_from_inp(mtype, params, etype),
            name=elset,
        ))
    return MultiBlockSystem(model.nodes, blocks, config, device=device)
