"""The equation system: assembly + BCs + linear/Newton solves + load
stepping + post-processing.

Torch counterpart of ``femcy_tpu.system.FEMSystem`` for the static
analysis of any mesh, linear or geometric-nonlinear, in the JAX package's
three layouts:

- a structured box (``meshgen.box_tets``, ``sparse_format`` "auto" or
  "dia"): assembly goes from the node coordinates to the analytic DIA
  layout through ``structured.structured_assemble_coords``; on CUDA the
  fused kernel (kernels/structured_fused, P3) for an isotropic material,
  else the prep and the accumulate kernel (kernels/structured_accumulate,
  P2); on the CPU their plain torch versions;
- any other mesh (or a box with ``sparse_format="ell"``): the ELL pattern
  (topology.build_pattern, native C++ code), and the general DIA layout
  when the mesh's offsets are bounded (``build_dia_pattern``, chosen
  exactly as in femcy_tpu); element stiffnesses scattered into either
  layout by the deterministic scatter kernel on CUDA (kernels/ell_scatter,
  M1) or its plain indexed add on the CPU;
- Dirichlet conditions are eliminated on the layout in use;
- the linear solve is the host direct solve below ``direct_solve_max_dof``
  dofs, the PCG above it.  On DIA: Jacobi, block-Jacobi, or (boxes only)
  the geometric multigrid V-cycle (solvers/multigrid), with the DIA SpMV
  kernel (kernels/dia_spmv, P1); on ELL: the Jacobi PCG with the ELL SpMV
  kernel (kernels/ell_spmv, M2) -- scalar Jacobi also under
  ``preconditioner="block_jacobi"``, as in femcy_tpu.  ``spmv="slices"``
  asks for the plain SpMV on either layout;
- geometric nonlinearity runs the JAX package's Newton-Raphson state
  machine (``run_newton``: boost, relax, stall refresh, NaN cut) on the
  host.  Each evaluation pins the prescribed dofs, computes the current
  kinematics, the Cauchy stress and the internal force -- summed by the
  box force kernel (kernels/structured_force, M5) or the general one
  (kernels/internal_force, M4) -- and the tangent: secant material
  stiffness plus geometric stiffness (the default) or the consistent
  tangent, both scattered as element matrices (P2 on the box through
  ``structured_dia_scatter``, M1 on the general layouts), or without
  geometric stiffness on the box from the current coordinates (P3);
- the adaptive load-stepping loop of ``solve`` is the JAX package's:
  cutback, dt growth, the "extrapolate" predictor, the global or
  per-increment residual reference (kept in checkpoints) and the failure
  diagnosis.

Every tensor lives on the ``device`` given to ``FEMSystem`` (``"cuda"`` by
default, ``"cpu"`` when asked for; CUDA without a card raises) in one float
dtype (float64 unless ``FEMCY_TPU_X64=0``, as in femcy_tpu).  The options
listed in config._LATER raise NotImplementedError naming the slice that
brings them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly, bc as bc_mod
from femcy_tpu_torch.config import SolverConfig
from femcy_tpu_torch.io.inp import InpModel
from femcy_tpu_torch.kernels import ell_spmv
from femcy_tpu_torch.kernels.dia_spmv import make_spmv
from femcy_tpu_torch.kernels.ell_scatter import build_scatter_plan, scatter
from femcy_tpu_torch.kernels.internal_force import scatter_force
from femcy_tpu_torch.kernels.structured_force import force_scatter
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.solvers.cg import pcg_solve
from femcy_tpu_torch.solvers.dia import (
    DIAPattern,
    build_dia_pattern,
    build_structured_dia_pattern,
    dia_dirichlet_linear,
    dia_dirichlet_newton,
    dia_pcg_solve,
)
from femcy_tpu_torch.solvers.direct import direct_solve, factorize
from femcy_tpu_torch.solvers.multigrid import StructuredMultigrid, coarsen_grids
from femcy_tpu_torch.structured import (
    build_structured_plan,
    structured_assemble_coords,
    structured_dia_scatter,
    structured_element_nodes,
)
from femcy_tpu_torch.topology import ELLPattern, build_pattern
from femcy_tpu_torch.utils.device import resolve_device
from femcy_tpu_torch.utils.timing import Timer

logger = logging.getLogger("femcy_tpu_torch")


def default_dtype() -> torch.dtype:
    """float64, or float32 when FEMCY_TPU_X64=0 (the JAX package's switch)."""
    if os.environ.get("FEMCY_TPU_X64", "1") == "0":
        return torch.float32
    return torch.float64


@dataclasses.dataclass
class IncrementRecord:
    kinc: int
    time: float
    dt: float
    newton_iters: int
    residual: float
    converged: bool


@dataclasses.dataclass
class SolveReport:
    success: bool
    increments: List[IncrementRecord]
    wall_time: float
    message: str = ""
    #: energy dissipated by static stabilization; always 0 here (the
    #: option is not ported yet, config._LATER)
    stabilization_energy: float = 0.0

    @property
    def n_increments(self) -> int:
        return len(self.increments)


def _rms(x):
    """Reference residual norm: sqrt(sum(x^2)/N) (ref: tiGadgets.py:28-37)."""
    return torch.sqrt((x * x).sum() / x.shape[0])


def run_newton(dof0, evaluate, lin_solve, finish, cfg, ini_residual):
    """The Newton-Raphson state machine with boost/relax line search
    (ref: stiffnessMtrx.py:756-822), femcy_tpu.system.run_newton, over
    three callables:

    evaluate(dof) -> (dof, values, residual, rms as a float)
        pin prescribed dofs, assemble residual + tangent
    lin_solve(values, residual, reuse=None) -> du
        the Newton linear solve
    finish(dof)
        persist the working dof into the owning system

    ``ini_residual`` is the caller's analysis-lifetime initial-residual
    cache (the reference quirk, stiffnessMtrx.py:760-762); pass the current
    value (or None) and store the returned one.

    Returns (converged, newton_loops, final_residual, ini_residual).
    """
    dof, values, residual, pre_residual = evaluate(dof0)
    if ini_residual is None:
        # cached for the whole analysis (the reference's process-lifetime
        # cache, stiffnessMtrx.py:760-762)
        ini_residual = pre_residual
    if cfg.newton_residual_ref == "increment":
        # measure convergence against THIS increment's initial unbalance
        ini = pre_residual
    else:
        ini = ini_residual
    if cfg.verbose:
        logger.info("initial residual = %.6e (ini=%.6e)", pre_residual, ini)

    newton_loop = 0
    residual_val = pre_residual
    # modified Newton: one LU per increment, refreshed on stall
    # (config.newton_jacobian_reuse; the dict is threaded through
    # _solve_linear_system's direct path)
    reuse = {} if cfg.newton_jacobian_reuse == "increment" else None
    if ini >= cfg.newton_abs_tol:
        newton_loop = -1
        while pre_residual / (ini + 1.0e-30) >= cfg.newton_rel_tol:
            newton_loop += 1
            if newton_loop >= cfg.newton_max_iters:
                finish(dof)
                return False, newton_loop, pre_residual, ini_residual

            du = lin_solve(values, residual, reuse=reuse)
            dof = dof - du
            dof, values, residual, residual_val = evaluate(dof)
            if np.isnan(residual_val):
                logger.warning("NaN residual; cutting back time step")
                finish(dof)
                return False, newton_loop, residual_val, ini_residual
            if cfg.verbose:
                logger.info("newton %d residual=%.6e", newton_loop,
                            residual_val)

            # boost: keep stepping while the residual declines
            # (ref: stiffnessMtrx.py:792-807)
            boost_loop = -1
            relaxation = 1.0
            while 0.1 * pre_residual < residual_val < pre_residual:
                new_residual = residual_val
                boost_loop += 1
                if boost_loop >= cfg.newton_boost_max:
                    break
                dof = dof - relaxation * du
                dof, values, residual, residual_val = evaluate(dof)
                if residual_val > new_residual:
                    dof = dof + relaxation * du
                    dof, values, residual, residual_val = evaluate(dof)
                    relaxation *= 0.5

            # relaxation: back off when the residual grows
            # (ref: stiffnessMtrx.py:809-819)
            relax_loop = -1
            relaxation = 0.5
            while residual_val > pre_residual:
                relax_loop += 1
                if relax_loop >= cfg.newton_relax_max:
                    break
                dof = dof + (1.0 - relaxation) * du
                du = relaxation * du
                dof, values, residual, residual_val = evaluate(dof)

            if (
                reuse is not None
                and residual_val > cfg.newton_reuse_stall * pre_residual
            ):
                # stale-Jacobian convergence stalled: refactorize with the
                # freshly assembled tangent on the next solve
                reuse["refresh"] = True
            pre_residual = residual_val
        newton_loop = max(newton_loop, 0)

    finish(dof)
    return True, newton_loop, residual_val, ini_residual


class FEMSystem:
    """Assemble and solve one body with one material.

    Parameters mirror femcy_tpu.FEMSystem (mesh, material, geometric
    nonlinearity flag, config) plus the torch ``device`` that every tensor
    of the system uses.  The dtype is ``default_dtype()``.
    """

    def __init__(
        self,
        mesh: FEMesh,
        material: Material,
        geometric_nonlinear: bool = False,
        config: SolverConfig = SolverConfig(),
        device="cuda",
    ):
        box = mesh.structure is not None and mesh.structure.get("kind") == "box_tets"
        structured = box and config.sparse_format in ("auto", "dia")
        if config.preconditioner == "multigrid":
            if not structured:
                raise ValueError(
                    "preconditioner='multigrid' needs a structured box_tets "
                    "mesh with the DIA layout (e.g. meshgen.box_tets)"
                )
            # fail fast, before any setup, if the grid cannot be coarsened
            info = mesh.structure
            coarsen_grids((info["nx"], info["ny"], info["nz"]))
        device = resolve_device(device)
        dtype = default_dtype()

        self.mesh = mesh
        self.material = material
        self.geometric_nonlinear = bool(geometric_nonlinear)
        self.config = config
        self.device = device
        self.dtype = dtype

        nu = getattr(material, "poisson_ratio", 0.0)
        if nu >= 0.495 and dtype == torch.float32:
            logger.warning(
                "near-incompressible material (nu=%.4f) in float32: expect "
                "O(1%%) stress error; use float64 (the default)", nu,
            )

        sync = torch.cuda.synchronize if device.type == "cuda" else None
        self.pattern: Optional[ELLPattern] = None
        self.dia: Optional[DIAPattern] = None
        self._structured_plan = None
        #: element stiffness -> values scatter of the general layouts
        self._scatter_plan = None
        #: setup phase walls (seconds, synchronised on CUDA): "pattern",
        #: "dia_pattern" and "scatter_map" on the general layouts, then
        #: "upload" and "gradients"
        init_s = {}
        self._init_seconds = init_s

        def phase(name, fn):
            t = _time.perf_counter()
            out = fn()
            if sync is not None:
                sync()
            init_s[name] = _time.perf_counter() - t
            return out

        if structured:
            # analytic pattern + scatter-free assembly plan (O(1) host setup)
            self.dia = build_structured_dia_pattern(mesh)
            self._structured_plan = build_structured_plan(mesh, self.dia)
        else:
            self.pattern = phase("pattern", lambda: build_pattern(mesh))
            # gather-free DIA layout when the offset structure allows it,
            # chosen exactly as femcy_tpu does
            if config.sparse_format in ("auto", "dia"):
                dia = phase("dia_pattern", lambda: build_dia_pattern(
                    mesh, max_offsets=config.dia_max_offsets, ell=self.pattern))
                dense_enough = (
                    dia is not None
                    and dia.n_offsets * self.pattern.n_dof <= 4 * self.pattern.nnz
                )
                if dia is not None and (config.sparse_format == "dia" or dense_enough):
                    self.dia = dia
                elif config.sparse_format == "dia":
                    raise ValueError(
                        "sparse_format='dia' but the mesh has no bounded offset "
                        "structure (try a bandwidth-reducing node ordering)"
                    )
            self._scatter_plan = phase("scatter_map", lambda: build_scatter_plan(
                self.pattern, device, dia=self.dia))

        elem = mesh.element

        def tensor(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        def upload():
            arrs = {
                "nodes": tensor(mesh.nodes),
                "elements": tensor(mesh.elements, torch.int64),
                "dN": tensor(elem.dshape_at_gp),
                "w": tensor(elem.gauss_weights),
                "C": tensor(material.C),
            }
            if self.pattern is not None and self.dia is None:
                # the ELL Dirichlet elimination and Jacobi diagonal
                arrs["colidx"] = tensor(self.pattern.colidx, torch.int64)
                arrs["diag_slot"] = tensor(self.pattern.diag_slot, torch.int64)
            return arrs

        arrs = phase("upload", upload)
        # initial-configuration gradients are constant: precompute once
        arrs["dsdX0"], arrs["vol0"] = phase(
            "gradients", lambda: assembly.gradients_and_volume(
                arrs["nodes"], arrs["elements"], arrs["dN"], arrs["w"]))
        self._arrs = arrs

        # --- state ----------------------------------------------------------
        self.dof = torch.zeros(mesh.n_dof, dtype=dtype, device=device)
        self._last_vol = arrs["vol0"]  # volume of the most recent assembly
        self.time0 = 0.0
        self.time1 = 0.0
        self.dt = 0.0
        #: PCG iteration count of the most recent CG solve (0 until one ran)
        self._last_cg_iters: int = 0
        #: the iteration count of every CG solve, in order
        self._cg_iters_log: List[int] = []
        #: the first Newton residual of the analysis (the global reference,
        #: config.newton_residual_ref="global"); None until one is known
        self._ini_residual: Optional[float] = None
        self.timer = Timer(verbose=config.verbose, sync=sync)
        #: last Dirichlet (fixed, sval) tensors applied by solve()
        self._last_dirichlet = None

        #: (prep, apply) of the SpMV kernel of the layout (P1 on DIA, M2 on
        #: ELL); None = the plain torch SpMV
        if config.spmv == "slices":
            self._spmv = None
        elif self.dia is not None:
            self._spmv = make_spmv(mesh.n_dof, self.dia.offsets, device)
        else:
            self._spmv = ell_spmv.make_spmv(self.pattern, device)
        # block Jacobi runs on the DIA layout only; the ELL PCG keeps the
        # scalar Jacobi under "block_jacobi", as femcy_tpu's does
        self._block_dm = (
            mesh.dm if config.preconditioner == "block_jacobi" else 0
        )
        # geometric multigrid (lazy: needs the fixed-dof mask, known only at
        # solve time)
        self._mg: Optional[StructuredMultigrid] = None
        self._mg_fixed_key: Optional[bytes] = None
        self._mg_fixed_obj = None

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _assemble_values(self, coords=None):
        """Values of the material stiffness in the system's layout, on the
        initial configuration by default, else (box only) on the
        configuration of ``coords``: on the structured box by
        structured_assemble_coords' default route, else element
        stiffnesses scattered by kernels/ell_scatter (one M1 launch on
        CUDA)."""
        a = self._arrs
        if self._structured_plan is not None:
            return structured_assemble_coords(
                a["nodes"] if coords is None else coords, self.mesh,
                a["dN"], a["w"], a["C"],
                self._structured_plan, C_host=np.asarray(self.material.C),
            )
        return scatter(self._element_stiffness(), self._scatter_plan)

    def _element_stiffness(self):
        """Element stiffnesses (E, edof, edof) on the initial configuration
        (plain torch einsum, as femcy_tpu leaves it to XLA)."""
        a = self._arrs
        return assembly.element_stiffness(a["dsdX0"], a["vol0"], a["C"])

    def _scatter(self, Ke):
        """Element matrices (E, edof, edof) -> values of the system's
        layout: P2's planes on the box (structured_dia_scatter), M1
        elsewhere."""
        if self._structured_plan is not None:
            return structured_dia_scatter(Ke, self._structured_plan)
        return scatter(Ke, self._scatter_plan)

    def _dirichlet_newton(self, values, residual, fixed):
        if self.dia is not None:
            return dia_dirichlet_newton(
                values, self.dia.offsets, self.dia.diag_idx, residual, fixed
            )
        a = self._arrs
        return bc_mod.apply_dirichlet_newton(
            values, a["colidx"], a["diag_slot"], residual, fixed
        )

    def _internal_force_parts(self, dof, fixed, sval):
        """Shared first half of every Newton evaluation: pin prescribed
        dofs, compute the current-configuration kinematics, the Cauchy
        stress and the internal nodal force (ref: stiffnessMtrx.py:609-644).
        The force is summed by M5 on the box and by M4 elsewhere (their
        plain versions on the CPU).  Returns (pinned dof, coords, dsdx,
        vol, sigma, f_int)."""
        a = self._arrs
        dm = self.mesh.dm
        dof = bc_mod.pin_dof(dof, fixed, sval)
        coords = a["nodes"] + dof.reshape(-1, dm)
        if self._structured_plan is not None:
            # element node values by grid slices, no gather
            u_e = structured_element_nodes(dof.reshape(-1, dm), self.mesh)
            F = assembly.deformation_gradient_u(u_e, a["dsdX0"])
            x_e = structured_element_nodes(coords, self.mesh)
            dsdx, vol = assembly.gradients_and_volume_x(x_e, a["dN"], a["w"])
        else:
            F = assembly.deformation_gradient(dof, a["elements"], a["dsdX0"])
            dsdx, vol = assembly.gradients_and_volume(
                coords, a["elements"], a["dN"], a["w"]
            )
        sigma = assembly.gp_stress(F, self.material, large=True)
        f_elem = assembly.element_internal_force(dsdx, sigma, vol).contiguous()
        if self._structured_plan is not None:
            f_int = force_scatter(f_elem, self._structured_plan, self.mesh)
        else:
            f_int = scatter_force(f_elem, self._scatter_plan)
        return dof, coords, dsdx, vol, sigma, f_int

    def _newton_eval(self, dof, rhs, fixed, sval):
        """One full residual/Jacobian evaluation of the Newton method.

        Pins the prescribed dofs, computes internal force and tangent on the
        current configuration, applies the Newton Dirichlet treatment and
        returns (pinned dof, K_bc, residual_bc, rms residual tensor, vol)
        (ref: stiffnessMtrx.py:609-644 + 756-758 + 310-341).
        """
        a = self._arrs
        cfg = self.config
        dof, coords, dsdx, vol, sigma, f_int = self._internal_force_parts(
            dof, fixed, sval
        )
        if cfg.tangent == "consistent":
            Ke = assembly.consistent_tangent(
                dof, a["elements"], a["nodes"], a["dN"], a["w"], self.material
            )
            values = self._scatter(Ke)
        elif self._structured_plan is None or cfg.geometric_stiffness:
            Ke = assembly.element_stiffness(dsdx, vol, a["C"])
            if cfg.geometric_stiffness:
                Ke += assembly.geometric_stiffness(dsdx, sigma, vol)
            values = self._scatter(Ke)
        else:
            values = self._assemble_values(coords)
        residual = f_int - rhs
        values, residual = self._dirichlet_newton(values, residual, fixed)
        return dof, values, residual, _rms(residual), vol

    def _linear_system(self, rhs, fixed, sval):
        """Assemble + Dirichlet-eliminate for the linear path, always on the
        initial configuration (as femcy_tpu's _linear_system_impl)."""
        values = self._assemble_values()
        if self.dia is not None:
            values, rhs = dia_dirichlet_linear(
                values, self.dia.offsets, self.dia.diag_idx, rhs, fixed, sval
            )
        else:
            values, rhs = bc_mod.apply_dirichlet_linear(
                values, self._arrs["colidx"], self._arrs["diag_slot"], rhs,
                fixed, sval,
            )
        return values, rhs, self._arrs["vol0"]

    def _solve_linear_system(self, values, b, fixed, reuse=None):
        """Direct host solve below ``direct_solve_max_dof`` dofs (or when
        forced), the PCG of the layout otherwise (ref:
        stiffnessMtrx.py:272-276); ``fixed`` (the Dirichlet mask ``values``
        was eliminated with) keys the multigrid hierarchy.

        ``reuse``: optional dict carrying a cached LU across Newton
        iterations (modified Newton, config.newton_jacobian_reuse); callers
        set reuse["refresh"]=True to force refactorization.  The CG paths
        have nothing to reuse and ignore it."""
        cfg = self.config
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto"
            and self.mesh.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            pattern = self.dia if self.dia is not None else self.pattern
            if reuse is not None:
                if reuse.get("lu") is None or reuse.pop("refresh", False):
                    reuse["lu"] = factorize(pattern, values.cpu().numpy())
                x = reuse["lu"].solve(b.cpu().numpy())
            else:
                x = direct_solve(pattern, values.cpu().numpy(),
                                 b.cpu().numpy())
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if cfg.preconditioner == "multigrid":
            self._ensure_multigrid(fixed)
            # <=0 means "up to n_dof", like the Jacobi path
            max_iters = cfg.cg_max_iters if cfg.cg_max_iters > 0 else self.mesh.n_dof
            x, iters, rmax = self._mg.pcg_solve(
                values, b, eps=cfg.cg_eps, max_iters=max_iters, spmv=self._spmv
            )
            if cfg.verbose:
                logger.info("MG-CG: %d iters, ||r||_inf=%.3e", iters, float(rmax))
            self._warn_cg_cap(iters, rmax, b)
            self._last_cg_iters = iters
            self._cg_iters_log.append(iters)
            return x
        if self.dia is not None:
            x, iters, rmax = dia_pcg_solve(
                values, self.dia.offsets, self.dia.diag_idx, b,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                block_dm=self._block_dm, spmv=self._spmv,
            )
        else:
            x, iters, rmax = pcg_solve(
                values, self._arrs["colidx"], self._arrs["diag_slot"], b,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters, spmv=self._spmv,
            )
        if cfg.verbose:
            logger.info("CG: %d iters, ||r||_inf=%.3e", iters, float(rmax))
        self._warn_cg_cap(iters, rmax, b)
        self._last_cg_iters = iters
        self._cg_iters_log.append(iters)
        return x

    def _ensure_multigrid(self, fixed):
        """Build (or rebuild, if the fixed-dof mask changed) the V-cycle
        hierarchy, from the small-strain operator; it is reused across
        increments and Newton iterations while the mask holds."""
        # within one increment every Newton solve passes the same mask
        # object: no device-to-host copy and hash per linear solve
        if self._mg is not None and fixed is self._mg_fixed_obj:
            return
        fixed_host = fixed.cpu().numpy()
        key = fixed_host.tobytes()
        if self._mg is not None and self._mg_fixed_key == key:
            self._mg_fixed_obj = fixed
            return
        self._mg = StructuredMultigrid(
            self.mesh, self.material, fixed_host, dia=self.dia,
            coarse_spmv="slices" if self.config.spmv == "slices" else "auto",
            device=self.device, dtype=self.dtype,
        )
        self._mg_fixed_key = key
        self._mg_fixed_obj = fixed

    def _warn_cg_cap(self, iters, rmax, b):
        """Warn when the CG exited on its iteration cap unconverged: the
        returned solution is silently truncated otherwise."""
        cap = (
            self.config.cg_max_iters
            if self.config.cg_max_iters > 0
            else self.mesh.n_dof
        )
        if iters < cap:
            return
        rmax0 = float(b.abs().max())
        if rmax0 > 0.0 and float(rmax) >= self.config.cg_eps * rmax0:
            logger.warning(
                "CG exited at the iteration cap (%d) UNCONVERGED: "
                "||r||_inf=%.3e >= eps*||r0||_inf=%.3e -- the solution is "
                "truncated; raise cg_max_iters, loosen cg_eps, or use a "
                "stronger preconditioner",
                cap, float(rmax), self.config.cg_eps * rmax0,
            )

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def solve(
        self,
        inp: InpModel,
        user_dirichlet: Optional[Callable] = None,
        on_increment: Optional[Callable] = None,
        on_newton: Optional[Callable] = None,
        resume: bool = False,
    ) -> SolveReport:
        """Run the full adaptive-load-stepping analysis
        (ref: stiffnessMtrx.py:647-711), the loop of femcy_tpu's
        ``FEMSystem.solve``.

        ``resume=True`` continues from the current (dof, time0, dt) state --
        e.g. right after ``load_checkpoint`` -- instead of restarting at t=0.
        ``on_newton(system, newton_loop, residual)`` is called after every
        Newton evaluation (the reference's ``show_newton_steps`` hook,
        stiffnessMtrx.py:663-666, 788-790).
        """
        t_start = _time.time()
        cfg = self.config
        incs = inp.time_incs
        max_time = incs["max_time"]
        min_inc = incs["min_inc"]
        max_inc = incs["max_inc"]
        if not resume:
            self.dt = incs["ini_inc"]
            self.time0 = self.time1 = 0.0
            self.dof = torch.zeros_like(self.dof)

        patterns, tractions = bc_mod.build_neumann_patterns(self.mesh, inp.neumann_bcs)
        patterns_d = torch.as_tensor(patterns, dtype=self.dtype, device=self.device)
        tractions_d = torch.as_tensor(tractions, dtype=self.dtype, device=self.device)

        records: List[IncrementRecord] = []
        dof_old = self.dof
        # linear-extrapolation predictor state (config.predictor): the
        # previous converged solution and the time step that produced
        # dof_old from it
        dof_prev: Optional[torch.Tensor] = None
        dt_prev = 0.0
        kinc = -1
        success = True
        message = "converged"

        while self.time1 < max_time:
            kinc += 1
            self.time1 = min(self.time0 + self.dt, max_time)
            load_ratio = self.time1 / max_time
            if (
                cfg.predictor == "extrapolate"
                and self.geometric_nonlinear
                and dof_prev is not None
                and dt_prev > 0.0
            ):
                alpha = (self.time1 - self.time0) / dt_prev
                self.dof = dof_old + alpha * (dof_old - dof_prev)
            if cfg.verbose:
                logger.info("kinc=%d time0=%.6g dt=%.6g", kinc, self.time0, self.dt)

            fixed, sval = bc_mod.build_dirichlet_arrays(
                inp.dirichlet_bcs, self.mesh, self.time1, load_ratio, user_dirichlet
            )
            fixed_d = torch.as_tensor(fixed, device=self.device)
            sval_d = torch.as_tensor(sval, dtype=self.dtype, device=self.device)
            self._last_dirichlet = (fixed_d, sval_d)
            if patterns.shape[0]:
                rhs = (tractions_d * load_ratio) @ patterns_d
            else:
                rhs = torch.zeros_like(self.dof)

            converged, newton_loops, res = self._advance_inc(
                rhs, fixed_d, sval_d, on_newton
            )

            if not converged:
                # cut back (ref: stiffnessMtrx.py:692-701)
                dof_trial = self.dof  # the failed trial state, pre-rollback
                self.time1 = self.time0
                self.dt *= cfg.dt_cutback
                self.dof = dof_old
                kinc -= 1
                records.append(IncrementRecord(
                    kinc + 1, self.time0, self.dt, newton_loops, res, False))
                if self.dt < min_inc:
                    success = False
                    message = (
                        "allowable minimum dt reached; Newton's method did "
                        "not converge"
                    )
                    if cfg.diagnose_failure:
                        diag = self._diagnose_failure(dof_trial, fixed_d, sval_d)
                        if diag:
                            message += "; " + diag
                    logger.warning(message)
                    break
                continue

            # grow dt after fast convergence (ref: stiffnessMtrx.py:702-704)
            if newton_loops <= cfg.newton_fast_iters:
                self.dt = min(self.dt * cfg.dt_growth, max_inc)
            dof_prev, dt_prev = dof_old, self.time1 - self.time0
            dof_old = self.dof
            self.time0 = self.time1
            records.append(
                IncrementRecord(kinc, self.time1, self.dt, newton_loops, res, True)
            )
            if cfg.checkpoint_path:
                self._write_checkpoint(cfg.checkpoint_path, kinc)
            if on_increment is not None:
                on_increment(self, records[-1])

        return SolveReport(
            success=success,
            increments=records,
            wall_time=_time.time() - t_start,
            message=message,
        )

    def _advance_inc(self, rhs, fixed, sval, on_newton=None):
        """One load increment (ref: stiffnessMtrx.py:714-822): assemble,
        eliminate and solve on the linear path; the Newton-Raphson loop
        (``run_newton``) on the geometric-nonlinear one.

        Returns (converged, newton_loops, final residual).
        """
        cfg = self.config
        if not self.geometric_nonlinear:
            with self.timer.section("assemble+bc"):
                values, rhs_bc, vol = self._linear_system(rhs, fixed, sval)
            with self.timer.section("linear_solve"):
                self.dof = self._solve_linear_system(values, rhs_bc, fixed)
            self._last_vol = vol
            return True, 0, 0.0

        newton_count = {"n": -1}

        def evaluate(dof):
            with self.timer.section("newton_eval"):
                dof, values, residual, res, vol = self._newton_eval(
                    dof, rhs, fixed, sval
                )
                res = float(res)  # the evaluation's one read-back
            self._last_vol = vol
            newton_count["n"] += 1
            if on_newton is not None:
                self.dof = dof  # expose the current state to the callback
                on_newton(self, newton_count["n"], res)
            return dof, values, residual, res

        def lin_solve(values, residual, reuse=None):
            with self.timer.section("linear_solve"):
                return self._solve_linear_system(
                    values, residual, fixed, reuse=reuse
                )

        def finish(dof):
            self.dof = dof

        converged, newton_loop, residual_val, self._ini_residual = run_newton(
            self.dof, evaluate, lin_solve, finish, cfg, self._ini_residual
        )
        return converged, newton_loop, residual_val

    # ------------------------------------------------------------------ #
    # failure diagnostics (ref: the reference aborts with a bare message,
    # stiffnessMtrx.py:698-701)
    # ------------------------------------------------------------------ #
    def min_element_volume(self, dof=None) -> float:
        """Smallest det(J)*w over all (element, Gauss point) at the given
        configuration (default: the current ``self.dof``).  Non-positive
        means the element is inverted there."""
        dof = self.dof if dof is None else torch.as_tensor(
            dof, dtype=self.dtype, device=self.device)
        a = self._arrs
        coords = a["nodes"] + dof.reshape(-1, self.mesh.dm)
        _, vol = assembly.gradients_and_volume(
            coords, a["elements"], a["dN"], a["w"])
        return float(vol.min())

    def tangent_min_eigenvalue(self, fixed=None, sval=None):
        """Smallest eigenvalue of the BC-constrained Newton tangent at the
        current ``self.dof`` (host shift-invert Lanczos on the free-dof
        block).  Negative or ~0 at a converged state means a limit or
        bifurcation point.  Returns None when the tangent is numerically
        singular.  ``fixed``/``sval`` default to the last Dirichlet arrays
        applied by ``solve``."""
        import scipy.sparse.linalg as spla

        if fixed is None or sval is None:
            if self._last_dirichlet is None:
                raise ValueError(
                    "no Dirichlet state available: pass fixed/sval or call "
                    "solve() first"
                )
            fixed, sval = self._last_dirichlet
        fixed = torch.as_tensor(fixed, device=self.device)
        sval = torch.as_tensor(sval, dtype=self.dtype, device=self.device)
        zeros = torch.zeros_like(self.dof)
        _, values, _, _, _ = self._newton_eval(self.dof, zeros, fixed, sval)
        layout = self.dia if self.dia is not None else self.pattern
        K = layout.to_scipy(values.cpu().numpy())
        free = ~fixed.cpu().numpy().astype(bool)
        Kf = K[free][:, free].tocsc()
        if Kf.shape[0] == 0:
            return None
        try:
            lam = spla.eigsh(
                Kf, k=1, sigma=0.0, which="LM", return_eigenvectors=False
            )
            return float(lam[0])
        except Exception as exc:  # singular splu / ARPACK breakdown
            logger.info("tangent eigenvalue probe failed: %s", exc)
            return None

    def _diagnose_failure(self, dof_trial, fixed, sval) -> str:
        """Classify why Newton could not converge at the minimum time step
        (femcy_tpu's diagnosis): element inversion at the trial
        configuration; loss of positive definiteness of the constrained
        tangent at the last converged state (a limit or bifurcation point);
        or, by elimination, a snap that develops within the increment."""
        parts = []
        try:
            vmin = self.min_element_volume(dof_trial)
            if np.isnan(vmin):
                parts.append("trial state diverged to NaN")
            elif vmin <= 0.0:
                parts.append(
                    "element inversion at the trial configuration "
                    f"(min det(J)w = {vmin:.3e})"
                )
        except Exception as exc:  # diagnostics must never mask the abort
            logger.info("element-volume probe failed: %s", exc)
        if self.mesh.n_dof <= self.config.diagnose_eig_max_dof:
            try:
                lam = self.tangent_min_eigenvalue(fixed, sval)
            except Exception as exc:
                logger.info("tangent eigenvalue probe failed: %s", exc)
                lam = False  # sentinel: skip reporting
            if lam is None:
                parts.append(
                    "tangent stiffness numerically singular at the last "
                    "converged state: limit/bifurcation point -- consider "
                    "Riks arc-length, static stabilization "
                    "(stabilize_factor), or stopping the schedule here"
                )
            elif lam is not False:
                if lam <= 0.0:
                    parts.append(
                        "tangent stiffness not positive definite at the last "
                        f"converged state (lambda_min = {lam:.3e}): "
                        "limit/bifurcation point -- the static branch is "
                        "unstable; consider Riks arc-length, static "
                        "stabilization (stabilize_factor), or stopping the "
                        "schedule here"
                    )
                elif not parts:
                    parts.append(
                        "tangent positive definite at the last converged "
                        f"state (lambda_min = {lam:.3e}); Newton divergence "
                        "without inversion or instability at the converged "
                        "state -- the instability develops WITHIN the "
                        "increment (within-increment snap; see PARITY.md)"
                    )
        return "; ".join(parts)

    # ------------------------------------------------------------------ #
    # post-processing (ref: stiffnessMtrx.py:436-606)
    # ------------------------------------------------------------------ #
    def deformation_gradient(self):
        a = self._arrs
        return assembly.deformation_gradient(self.dof, a["elements"], a["dsdX0"])

    def compute_strain_stress(self):
        """(strain, cauchy stress, mises) at every (element, GP): Green
        strain and the large-deformation stress on the geometric-nonlinear
        path, small strain and stress otherwise."""
        F = self.deformation_gradient()
        eye = torch.eye(self.mesh.dm, dtype=F.dtype, device=F.device)
        if self.geometric_nonlinear:
            strain = (F.transpose(-1, -2) @ F - eye) / 2.0
        else:
            strain = (F + F.transpose(-1, -2)) / 2.0 - eye
        stress = assembly.gp_stress(F, self.material,
                                    large=self.geometric_nonlinear)
        return strain, stress, mises_stress(stress, self.material)

    def elastic_energy(self) -> float:
        """Total elastic energy = sum psi(F) * vol over the most recently
        assembled configuration's volumes (ref: stiffnessMtrx.py:592-606)."""
        dens = assembly.gp_energy_density(self.deformation_gradient(), self.material)
        return float((dens * self._last_vol).sum())

    def extrapolate(self, gp_vals):
        """GP -> nodal patch extrapolation, (E, G) -> (E, n_nodes)."""
        M = torch.as_tensor(
            self.mesh.element.extrapolation_matrix,
            dtype=gp_vals.dtype, device=gp_vals.device,
        )
        return gp_vals @ M.T

    # ------------------------------------------------------------------ #
    def _write_checkpoint(self, path: str, kinc: int):
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez(
            path, dof=self.dof.cpu().numpy(), time0=self.time0, dt=self.dt,
            kinc=kinc,
            # nan when unset; restored so newton_residual_ref='global' gates
            # identically across a resume (stiffnessMtrx.py:760-762)
            ini_residual=(
                np.nan if self._ini_residual is None else self._ini_residual
            ),
        )

    def load_checkpoint(self, path: str):
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        self.dof = torch.as_tensor(data["dof"], dtype=self.dtype, device=self.device)
        self.time0 = self.time1 = float(data["time0"])
        self.dt = float(data["dt"])
        if "ini_residual" in data:
            ini = float(data["ini_residual"])
            self._ini_residual = None if np.isnan(ini) else ini


def mises_stress(stress, material: Material):
    """Von Mises stress per (element, GP), with the material-type-specific
    out-of-plane treatment (ref: stiffnessMtrx.py:457-501)."""
    s3 = stress
    if material.type in ("planeStress", "planeStrain"):
        s3 = stress.new_zeros(stress.shape[:-2] + (3, 3))
        s3[..., :2, :2] = stress
        if material.type == "planeStrain":
            s3[..., 2, 2] = material.poisson_ratio * (
                stress[..., 0, 0] + stress[..., 1, 1]
            )
    eye = torch.eye(3, dtype=stress.dtype, device=stress.device)
    tr = s3.diagonal(dim1=-2, dim2=-1).sum(-1)
    dev = s3 - tr[..., None, None] / 3.0 * eye
    return torch.sqrt(1.5 * (dev * dev).sum(dim=(-2, -1)))
