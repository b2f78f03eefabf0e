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
  asks for the plain SpMV on either layout.  ``preconditioner="amg"``
  forces the ELL layout and runs the smoothed-aggregation AMG-PCG
  (solvers/amg), whose fine apply and V-cycle go through the block-ELL
  SpMV kernel (kernels/bell_spmv, M3) whatever ``spmv`` says; its
  hierarchy is built once per Dirichlet mask from the eliminated operator
  pulled back through bf16, and kept across increments and Newton
  iterations;
- geometric nonlinearity runs the JAX package's Newton-Raphson state
  machine (``run_newton``: boost, relax, stall refresh, NaN cut) on the
  host.  Each evaluation pins the prescribed dofs, computes the current
  kinematics, the Cauchy stress and the internal force -- summed by the
  box force kernel (kernels/structured_force, M5) or the general one
  (kernels/internal_force, M4) -- and the tangent: secant material
  stiffness plus geometric stiffness (the default) or the consistent
  tangent, both scattered as element matrices (P2 on the box through
  ``structured_dia_scatter``, M1 on the general layouts), or without
  geometric stiffness on the box from the current coordinates (P3).  On a
  C3D4 box under a PK2 = C : E material the secant + geometric tangent
  takes one kernel from the displacement to the stress, the element force
  and P2's planes of Ke + Kg (kernels/newton_element, M9), then M5 and P2;
- the adaptive load-stepping loop of ``solve`` is the JAX package's:
  cutback, dt growth, the "extrapolate" predictor, the global or
  per-increment residual reference (kept in checkpoints), the failure
  diagnosis and static stabilization (``stabilize_factor``: a viscous
  force on the volume-lumped diagonal, added to the residual before the
  Dirichlet treatment and to the tangent's diagonal on every route);
- the solver extensions of femcy_tpu's slice G: the dense small-model CG
  (``dense_operator_max_dof``: the eliminated operator placed into a
  dense matrix once per solve, every matvec one dense product), the fused
  Newton step (``fused_newton``: evaluation and CG in one step, ``du``
  riding in ``run_newton``'s values slot), mixed-precision refinement
  (``mixed_precision_refine``: float32 solves corrected against the f64
  host operator or the f64 host internal force) and the device loop
  (``device_loop``, device_loop.py);
- the implicit-dynamics rescue (``dynamic_rescue``: ``dynamic_traverse``,
  a hook of ``run_increments``, shared with multiblock.py), which carries
  a within-increment snap through Newmark steps on the stabilization hook;
- slab sharding (``sharding="slab"``, parallel/structured.py): the same
  host state machine drives the slab solver's assembly, evaluation and
  CG over x-slabs of a box, on one or several devices of one process;
  banded sharding (``sharding="banded"``, parallel/banded.py) does the
  same over RCM-ordered block-tridiagonal row shards of any mesh.

Every tensor lives on the ``device`` given to ``FEMSystem`` (``"cuda"`` by
default, ``"cpu"`` when asked for; CUDA without a card raises) in one float
dtype (float64 unless ``FEMCY_TPU_X64=0``, as in femcy_tpu).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly, bc as bc_mod
from femcy_tpu_torch.config import SolverConfig
from femcy_tpu_torch.io.inp import InpModel
from femcy_tpu_torch.kernels import bell_spmv as k_bell
from femcy_tpu_torch.kernels import ell_spmv, newton_element
from femcy_tpu_torch.kernels.dia_spmv import make_spmv
from femcy_tpu_torch.kernels.ell_scatter import build_scatter_plan, scatter
from femcy_tpu_torch.kernels.internal_force import scatter_force
from femcy_tpu_torch.kernels.structured_accumulate import accumulate
from femcy_tpu_torch.kernels.structured_force import force_scatter
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.solvers.amg import AlgebraicMultigrid
from femcy_tpu_torch.solvers.bell import build_bell_plan, plan_node_graph
from femcy_tpu_torch.solvers.cg import (
    dense_pcg_solve,
    ell_to_dense,
    gather_spmv,
    pcg_solve,
)
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
    dia_to_dense_device,
    structured_assemble_coords,
    structured_dia_scatter,
    structured_element_nodes,
)
from femcy_tpu_torch.topology import ELLPattern, build_pattern
from femcy_tpu_torch.utils.device import resolve_device
from femcy_tpu_torch.utils.timing import Timer, seconds_since, span

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
    #: energy dissipated by static stabilization (config.stabilize_factor);
    #: 0 when stabilization is off
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


def run_increments(system, time_incs, boundary, on_newton=None,
                   on_increment=None, before_inc=None, after_inc=None,
                   diagnose=None, rescue=None):
    """The adaptive load stepping (ref: stiffnessMtrx.py:647-711) of
    femcy_tpu's ``FEMSystem.solve`` and ``MultiBlockSystem.
    solve_nonlinear``: each increment runs ``system._advance_inc``; a
    failure rolls the dof back and cuts dt (abort below ``min_inc``), fast
    convergence grows it.  Reads and moves ``system``'s ``config``,
    ``dof``, ``dt``, ``time0`` and ``time1``; the caller sets where they
    start.  The callables:

    boundary(time1, load_ratio) -> (rhs, fixed, sval)
        the increment's load and Dirichlet arrays, on the device
    before_inc(dof_old)
        at the start of an increment, after time1 is set
    after_inc(dof_old)
        after a converged increment, before it becomes the last one
    diagnose(dof_trial, fixed, sval) -> str
        appended to the abort message when non-empty
    rescue(rhs, fixed, sval, on_newton) -> (settled, steps, detail)
        the implicit-dynamics traversal (config.dynamic_rescue,
        ``dynamic_traverse``), tried up to ``dynamic_max_rescues`` times
        before an abort: the schedule is held at t_resc (the step's
        ``ini_inc``, or ``dynamic_rescue_dt`` of the total time, past the
        failure), ``boundary`` gives its arrays, and a settled traversal
        is recorded as a converged increment at t_resc with its Newmark
        steps in the Newton slot, after which the stepping resumes at
        ``ini_inc``; otherwise ``detail`` ends the abort message
    on_increment(system, record)
        after every converged increment, the rescue's included

    Returns (records, success, message)."""
    cfg = system.config
    max_time = time_incs["max_time"]
    min_inc = time_incs["min_inc"]
    max_inc = time_incs["max_inc"]
    records: List[IncrementRecord] = []
    dof_old = system.dof
    kinc = -1
    rescues = 0
    while system.time1 < max_time:
        kinc += 1
        system.time1 = min(system.time0 + system.dt, max_time)
        load_ratio = system.time1 / max_time
        if before_inc is not None:
            before_inc(dof_old)
        if cfg.verbose:
            logger.info("kinc=%d time0=%.6g dt=%.6g", kinc, system.time0,
                        system.dt)
        rhs, fixed, sval = boundary(system.time1, load_ratio)
        converged, newton_loops, res = system._advance_inc(
            rhs, fixed, sval, on_newton)

        if not converged:
            # cut back (ref: stiffnessMtrx.py:692-701)
            dof_trial = system.dof  # the failed trial state, pre-rollback
            system.time1 = system.time0
            system.dt *= cfg.dt_cutback
            system.dof = dof_old
            kinc -= 1
            records.append(IncrementRecord(
                kinc + 1, system.time0, system.dt, newton_loops, res, False))
            if system.dt < min_inc:
                message_extra = ""
                if rescue is not None and rescues < cfg.dynamic_max_rescues:
                    rescues += 1
                    step_dt = (cfg.dynamic_rescue_dt * max_time
                               if cfg.dynamic_rescue_dt > 0.0
                               else time_incs["ini_inc"])
                    t_resc = min(system.time0 + step_dt, max_time)
                    rhs_r, fixed_r, sval_r = boundary(t_resc, t_resc / max_time)
                    logger.warning(
                        "static increment failed at t=%.6g; attempting "
                        "implicit-dynamics traversal to t=%.6g "
                        "(rescue %d/%d)", system.time0, t_resc, rescues,
                        cfg.dynamic_max_rescues)
                    ok, nsteps, detail = rescue(rhs_r, fixed_r, sval_r,
                                                on_newton)
                    if ok:
                        logger.warning(
                            "dynamic rescue at t=%.6g -> %.6g: %s; "
                            "resuming statics", system.time0, t_resc, detail)
                        system.time0 = system.time1 = t_resc
                        system.dt = time_incs["ini_inc"]
                        dof_old = system.dof
                        kinc += 1
                        records.append(IncrementRecord(
                            kinc, t_resc, system.dt, nsteps, 0.0, True))
                        if on_increment is not None:
                            on_increment(system, records[-1])
                        continue
                    logger.warning("%s", detail)
                    message_extra = "; " + detail
                message = ("allowable minimum dt reached; Newton's method "
                           "did not converge")
                if diagnose is not None:
                    diag = diagnose(dof_trial, fixed, sval)
                    if diag:
                        message += "; " + diag
                message += message_extra
                logger.warning(message)
                return records, False, message
            continue

        # grow dt after fast convergence (ref: stiffnessMtrx.py:702-704)
        if newton_loops <= cfg.newton_fast_iters:
            system.dt = min(system.dt * cfg.dt_growth, max_inc)
        if after_inc is not None:
            after_inc(dof_old)
        dof_old = system.dof
        system.time0 = system.time1
        records.append(IncrementRecord(
            kinc, system.time1, system.dt, newton_loops, res, True))
        if on_increment is not None:
            on_increment(system, records[-1])
    return records, True, "converged"


def dynamic_traverse(system, rhs, fixed, sval, on_newton):
    """Traverse a within-increment snap with implicit dynamics
    (config.dynamic_rescue; femcy_tpu's ``FEMSystem._dynamic_traverse``,
    shared, as there, by ``FEMSystem`` and ``MultiBlockSystem``).

    Loads and Dirichlet values are HELD at the target time (the caller
    builds ``rhs``/``fixed``/``sval`` there); the mesh gets a unit-density
    lumped mass and Newmark-beta with numerical dissipation (gamma > 1/2,
    beta = (gamma + 1/2)^2 / 4) integrates the jump in pseudo-time until
    the kinetic energy stays below ``dynamic_settle_tol`` of the elastic
    energy for two steps; a static Newton polish then confirms the
    far-side equilibrium (a rejected polish tightens the settle tolerance
    by 1e-2 and the integration goes on).  The first step h0 puts
    M/(beta h0^2) at the median of diag(K)/M over the free dofs; h is cut
    by 4 when a step's Newton fails and doubled after a fast one.  Each
    Newmark step is one ``system._advance_inc`` with the stabilization
    hook (``_stab_diag``, ``_stab_ref``, ``_stab_scale``) carrying the
    inertia: scale 1/(beta h^2), reference the predictor; the polish keeps
    the hook at scale 0.  Duck-typed over ``config``, ``dof``, those three
    attributes, ``_scalar``, ``_advance_inc``, ``elastic_energy``,
    ``_tangent_diag_host`` and ``_lumped_volume_diag``.

    Returns (settled, Newmark steps, detail).  ``system.dof`` holds the
    settled state on success and the entry state otherwise; the
    stabilization state is restored either way."""
    cfg = system.config
    gamma = cfg.dynamic_gamma
    beta = 0.25 * (gamma + 0.5) ** 2
    u_entry = system.dof
    saved = (system._stab_diag, system._stab_ref, system._stab_scale)
    if system._stab_diag is not None:
        # a huge leftover stabilization scale (C/dt at dt -> min_inc)
        # would corrupt the stiffness probe below
        system._stab_scale = system._scalar(0.0)
        system._stab_ref = u_entry

    def restore():
        system._stab_diag, system._stab_ref, system._stab_scale = saved

    # pseudo-time scale: M/(beta h0^2) ~ diag(K) at the median free dof,
    # i.e. the first step is strongly inertia-regularized
    kdiag = system._tangent_diag_host(rhs, fixed, sval)
    m = system._lumped_volume_diag()
    m_np = m.cpu().numpy()
    free = ~fixed.cpu().numpy().astype(bool)
    ratio = kdiag[free] / np.maximum(m_np[free], 1e-300)
    w2 = float(np.median(ratio))
    if not np.isfinite(w2) or w2 <= 0.0:
        restore()
        return False, 0, "dynamic rescue: degenerate stiffness/mass ratio"
    h0 = 1.0 / math.sqrt(beta * w2)
    h = h0
    system._stab_diag = m

    def polish(u):
        """Static Newton at the settled state (scale 0: pure statics) --
        the true acceptance gate; kinetic energy alone can accept a state
        outside any static basin."""
        system._stab_scale = system._scalar(0.0)
        system._stab_ref = u
        system.dof = u
        conv, _, _ = system._advance_inc(rhs, fixed, sval, on_newton)
        return conv

    u = u_entry
    v = torch.zeros_like(u)
    acc = torch.zeros_like(u)
    notfix = torch.as_tensor(free, dtype=u.dtype, device=u.device)
    steps = attempts = settled = polish_fails = 0
    settle_tol = cfg.dynamic_settle_tol
    e_kin = np.inf
    while steps < cfg.dynamic_max_steps:
        attempts += 1
        if attempts > 4 * cfg.dynamic_max_steps or h < 1e-8 * h0:
            system.dof = u_entry
            restore()
            return False, steps, (
                "dynamic rescue: Newmark Newton could not converge "
                f"(h collapsed to {h:.3e} of h0={h0:.3e})"
            )
        pred = u + h * v + (0.5 - beta) * h * h * acc
        system._stab_ref = pred
        system._stab_scale = system._scalar(1.0 / (beta * h * h))
        system.dof = u
        converged, loops, _ = system._advance_inc(rhs, fixed, sval, on_newton)
        if not converged:
            system.dof = u
            h *= 0.25
            continue
        steps += 1
        u_new = system.dof
        # prescribed dofs move by pinning, not by dynamics: their
        # fictitious acceleration must not enter the energy budget
        a_new = notfix * (u_new - pred) / (beta * h * h)
        v = notfix * (v + h * ((1.0 - gamma) * acc + gamma * a_new))
        acc = a_new
        u = u_new
        e_kin = 0.5 * float((m * v * v).sum())
        e_el = abs(system.elastic_energy())
        if cfg.verbose or steps % 25 == 0:
            logger.info("rescue step %d: h/h0=%.2e E_kin/E_elas=%.2e",
                        steps, h / h0, e_kin / max(e_el, 1e-300))
        if e_kin < settle_tol * max(e_el, 1e-300):
            settled += 1
            if settled >= 2:
                if polish(u):
                    restore()
                    return True, steps, (
                        f"settled in {steps} Newmark steps"
                        + (f" ({polish_fails} settle(s) rejected by the "
                           "static polish)" if polish_fails else "")
                    )
                # settled kinetically but not statically: tighten the
                # settle tolerance and keep integrating toward the
                # attractor (h -> inf is the static limit)
                polish_fails += 1
                settle_tol *= 1e-2
                settled = 0
                system.dof = u
                logger.info("rescue step %d: static polish rejected the "
                            "settled state; tightening settle tol to %.1e",
                            steps, settle_tol)
        else:
            settled = 0
        if loops <= cfg.newton_fast_iters:
            # no upper cap: h must reach the snap mode's fundamental
            # period for the gamma dissipation to kill the swing; Newton
            # failing at too large an h is the regulator (h *= 0.25)
            h *= 2.0
    system.dof = u_entry
    restore()
    if polish_fails:
        return False, steps, (
            "dynamic rescue: settled dynamically "
            f"{polish_fails} time(s) but the static polish never "
            "converged (no static equilibrium basin reached within "
            f"{cfg.dynamic_max_steps} steps)"
        )
    return False, steps, (
        "dynamic rescue: kinetic energy did not settle within "
        f"{cfg.dynamic_max_steps} steps (E_kin/E_elas ~ "
        f"{e_kin / max(abs(system.elastic_energy()), 1e-300):.1e})"
    )


def cg_done(system, n_dof: int, what: str, x, iters: int, rmax, b):
    """Log, warn at the iteration cap (unless ``system._suppress_cg_warn``:
    refinement's inner solves truncate by design), and record on
    ``system`` (its ``_last_cg_iters`` and ``_cg_iters_log``) the
    iterations of a finished CG solve; returns ``x``."""
    if system.config.verbose:
        logger.info("%s: %d iters, ||r||_inf=%.3e", what, iters, float(rmax))
    if not getattr(system, "_suppress_cg_warn", False):
        warn_cg_cap(system.config, n_dof, iters, rmax, b)
    system._last_cg_iters = iters
    system._cg_iters_log.append(iters)
    return x


def warn_cg_cap(config: SolverConfig, n_dof: int, iters: int, rmax, b):
    """Warn when a CG exited on its iteration cap unconverged: the
    returned solution is silently truncated otherwise."""
    cap = config.cg_max_iters if config.cg_max_iters > 0 else n_dof
    if iters < cap:
        return
    rmax0 = float(b.abs().max())
    if rmax0 > 0.0 and float(rmax) >= config.cg_eps * rmax0:
        logger.warning(
            "CG exited at the iteration cap (%d) UNCONVERGED: "
            "||r||_inf=%.3e >= eps*||r0||_inf=%.3e -- the solution is "
            "truncated; raise cg_max_iters, loosen cg_eps, or use a "
            "stronger preconditioner",
            cap, float(rmax), config.cg_eps * rmax0,
        )


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
        amg = config.preconditioner == "amg"
        if amg and structured:
            raise ValueError(
                "preconditioner='amg' runs on the general ELL path; this "
                "structured mesh already has the geometric 'multigrid'"
            )
        if amg and config.sparse_format == "dia":
            # the block-ELL plan indexes ``values`` as (n_dof, ell_width)
            raise ValueError(
                "preconditioner='amg' requires the ELL layout; "
                "sparse_format='dia' is incompatible"
            )
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

        # near-incompressible models condition the operator like
        # E/(1-2*nu): float32 loses O(1%) of the stress.  Refinement engages
        # on the linear path and the standard Newton path; the fused step
        # has no host residual hook, so the warning stays live there
        nu = getattr(material, "poisson_ratio", 0.0)
        fused_nl = self.geometric_nonlinear and config.fused_newton
        if (nu >= 0.495 and dtype == torch.float32
                and (not config.mixed_precision_refine or fused_nl)):
            logger.warning(
                "near-incompressible material (nu=%.4f) in float32: expect "
                "O(1%%) stress error; set "
                "SolverConfig(mixed_precision_refine=True) to recover f64 "
                "accuracy with float32 bulk work (linear and standard-Newton "
                "analyses%s), or use float64 (the default, FEMCY_TPU_X64=1)",
                nu, " -- NOT the fused_newton path used here" if fused_nl
                else "",
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
            # chosen exactly as femcy_tpu does; never under "amg"
            if config.sparse_format in ("auto", "dia") and not amg:
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
        #: the box's secant + Kg Newton evaluation by the Newton element
        #: kernel (M9, kernels/newton_element.py; its plain version on the
        #: CPU) in place of the einsum route
        self._newton_element = newton_element.route_applies(
            mesh, material, config, self._structured_plan)

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
        #: static stabilization (config.stabilize_factor): the volume-lumped
        #: diagonal, the increment's start state and the 0-d coefficient
        #: C/dt of the viscous force scale*diag*(dof - ref); None when off
        self._stab_diag: Optional[torch.Tensor] = None
        self._stab_ref: Optional[torch.Tensor] = None
        self._stab_scale: Optional[torch.Tensor] = None
        #: mixed-precision refinement (config.mixed_precision_refine): the
        #: increment's f64 host (rhs, fixed, sval), the f64 host operator
        #: (built at the first linear refinement), the linear refinement's
        #: cached LU and its last outer iteration count
        self._host_bc = None
        self._refine_K = None
        self._refine_reuse: Optional[dict] = None
        self._refine_iters: int = 0
        #: set while refinement's inner solves run: they truncate by design
        self._suppress_cg_warn = False
        #: f64 master state of the last refinement: the certified solution,
        #: exact beyond the float32 representation floor of ``self.dof``
        self.dof_refined: Optional[np.ndarray] = None
        self._warned_fused_refine = False
        #: the cached device-loop program (config.device_loop)
        self._device_loop_prog = None
        #: small-model dense CG (config.dense_operator_max_dof)
        self._use_dense_cg = (
            0 < config.dense_operator_max_dof
            and mesh.n_dof <= config.dense_operator_max_dof
        )

        #: (prep, apply) of the SpMV kernel of the layout (P1 on DIA, M2 on
        #: ELL; under "amg", whose solve applies M3, the Jacobi PCG of the
        #: fused step and the device loop still takes M2); the plain torch
        #: SpMV under "slices": None on DIA, the gather pair on ELL
        if config.spmv == "slices":
            self._spmv = (None if self.dia is not None
                          else gather_spmv(self._arrs["colidx"]))
        elif self.dia is not None:
            self._spmv = make_spmv(mesh.n_dof, self.dia.offsets, device)
        else:
            self._spmv = ell_spmv.make_spmv(self.pattern, device)
        # block Jacobi runs on the DIA layout and in the dense CG; the ELL
        # PCG keeps the scalar Jacobi under "block_jacobi", as femcy_tpu's
        # does
        self._block_dm = (
            mesh.dm if config.preconditioner == "block_jacobi" else 0
        )
        # geometric multigrid (lazy: needs the fixed-dof mask, known only at
        # solve time)
        self._mg: Optional[StructuredMultigrid] = None
        self._mg_fixed_key: Optional[bytes] = None
        self._mg_fixed_obj = None
        # algebraic multigrid (lazy like _mg: needs the fixed mask)
        self._amg: Optional[AlgebraicMultigrid] = None
        self._amg_fixed_key: Optional[bytes] = None
        self._amg_fixed_obj = None
        self._amg_raw_csr = None  # cached no-BC f64 host operator
        self._bell_plan = None
        #: M3's fine-level block ids and counts on the device
        self._bell_fine: Optional[k_bell.FinePlan] = None
        #: host walls (seconds) of the last hierarchy build, by phase
        self._amg_host_seconds: dict = {}

        #: the sharded solver (config.sharding "slab", parallel/
        #: structured.py, or "banded", parallel/banded.py): the same host
        #: state machine drives its shards instead of the single-device
        #: steps; None otherwise
        self._shard_sys = None
        if config.sharding != "none":
            cards = torch.cuda.device_count() if device.type == "cuda" else 0
            n = config.sharding_devices or cards
            if n < 1:
                raise ValueError(
                    f"sharding={config.sharding!r} on the CPU needs "
                    "sharding_devices > 0")
            shards = ([torch.device("cuda", i % cards) for i in range(n)]
                      if cards else [device] * n)
        if config.sharding == "banded":
            # any mesh: RCM + block-tridiagonal row shards, either tangent
            # (the consistent one evaluates per element shard); the ELL
            # pattern built above is reused (a structured box builds one)
            from femcy_tpu_torch.parallel.banded import BandedShardedSolver

            self._shard_sys = BandedShardedSolver(
                mesh, material, devices=shards, cg_eps=config.cg_eps,
                cg_iters=config.cg_max_iters,
                geometric_stiffness=config.geometric_stiffness,
                pattern=self.pattern, tangent=config.tangent,
                dtype=dtype,
            )
        elif config.sharding == "slab":
            if self._structured_plan is None:
                raise ValueError(
                    "sharding='slab' needs a structured box_tets mesh "
                    "(e.g. meshgen.box_tets); unstructured meshes use "
                    "sharding='banded'"
                )
            from femcy_tpu_torch.parallel.structured import (
                ShardedStructuredSolver,
            )

            self._shard_sys = ShardedStructuredSolver(
                mesh, material, devices=shards, cg_eps=config.cg_eps,
                cg_iters=config.cg_max_iters,
                preconditioner=("multigrid"
                                if config.preconditioner == "multigrid"
                                else "jacobi"),
                geometric_stiffness=config.geometric_stiffness,
                tangent=config.tangent, dtype=dtype,
            )

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _assemble_values(self):
        """Values of the material stiffness in the system's layout, on the
        initial configuration: on the structured box by
        ``_structured_values``, else element stiffnesses scattered by
        kernels/ell_scatter (one M1 launch on CUDA)."""
        if self._structured_plan is not None:
            with span("femcy.assemble.scatter"):
                return self._structured_values(self._arrs["nodes"])
        with span("femcy.assemble.ke"):
            Ke = self._element_stiffness()
        with span("femcy.assemble.scatter"):
            return scatter(Ke, self._scatter_plan)

    def _structured_values(self, coords):
        """(box only) DIA values of the material stiffness on the
        configuration of ``coords``, by structured_assemble_coords' default
        route (P3 on CUDA, which makes each element's stiffness inside its
        scatter)."""
        a = self._arrs
        return structured_assemble_coords(
            coords, self.mesh, a["dN"], a["w"], a["C"],
            self._structured_plan, C_host=np.asarray(self.material.C),
        )

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
        with span("femcy.dirichlet"):
            if self.dia is not None:
                return dia_dirichlet_newton(
                    values, self.dia.offsets, self.dia.diag_idx, residual,
                    fixed
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
        vol, sigma, f_int) -- the stabilization force, when on, is already
        folded into ``f_int``.  Under a profile the three steps are the
        spans "femcy.newton.kinematics", ".stress" and ".force"."""
        a = self._arrs
        dm = self.mesh.dm
        with span("femcy.newton.kinematics"):
            dof = bc_mod.pin_dof(dof, fixed, sval)
            coords = a["nodes"] + dof.reshape(-1, dm)
            if self._structured_plan is not None:
                # element node values by grid slices, no gather
                u_e = structured_element_nodes(dof.reshape(-1, dm), self.mesh)
                F = assembly.deformation_gradient_u(u_e, a["dsdX0"])
                x_e = structured_element_nodes(coords, self.mesh)
                dsdx, vol = assembly.gradients_and_volume_x(
                    x_e, a["dN"], a["w"])
            else:
                F = assembly.deformation_gradient(dof, a["elements"],
                                                  a["dsdX0"])
                dsdx, vol = assembly.gradients_and_volume(
                    coords, a["elements"], a["dN"], a["w"]
                )
        with span("femcy.newton.stress"):
            sigma = assembly.gp_stress(F, self.material, large=True)
        with span("femcy.newton.force"):
            f_elem = assembly.element_internal_force(
                dsdx, sigma, vol).contiguous()
            if self._structured_plan is not None:
                f_int = force_scatter(f_elem, self._structured_plan, self.mesh)
            else:
                f_int = scatter_force(f_elem, self._scatter_plan)
            if self._stab_diag is not None:
                # static stabilization: the viscous force, applied BEFORE
                # the Dirichlet treatment so constrained rows stay
                # zero-one; the matching tangent add happens in _newton_eval
                d = self._stab_scale * self._stab_diag
                f_int = f_int + d * (dof - self._stab_ref)
        return dof, coords, dsdx, vol, sigma, f_int

    def _newton_element_parts(self, dof, fixed, sval):
        """The box's secant + Kg evaluation by the Newton element kernel
        (M9): pin the prescribed dofs, then one launch for the planes of
        Ke + Kg, the element forces and the volumes, M5 for the internal
        force (with the stabilization force when on) and P2 for the tangent.
        Returns (pinned dof, values, f_int, vol).  Under a profile M9 is
        the span "femcy.newton.tangent", M5 ".force", P2 ".scatter", and
        ".stress" is empty."""
        a = self._arrs
        plan = self._structured_plan
        with span("femcy.newton.kinematics"):
            dof = bc_mod.pin_dof(dof, fixed, sval)
        with span("femcy.newton.stress"):
            pass
        with span("femcy.newton.tangent"):
            planes, f_elem, vol = newton_element.evaluate(
                a["nodes"], dof, a["dsdX0"], self.material, plan, self.mesh)
        with span("femcy.newton.force"):
            f_int = force_scatter(f_elem, plan, self.mesh)
            if self._stab_diag is not None:
                d = self._stab_scale * self._stab_diag
                f_int = f_int + d * (dof - self._stab_ref)
        del f_elem
        with span("femcy.newton.scatter"):
            values = accumulate(planes, plan.accumulate_table)
        return dof, values, f_int, vol

    def _newton_eval(self, dof, rhs, fixed, sval):
        """One full residual/Jacobian evaluation of the Newton method.

        Pins the prescribed dofs, computes internal force and tangent on the
        current configuration, applies the Newton Dirichlet treatment and
        returns (pinned dof, K_bc, residual_bc, rms residual tensor, vol)
        (ref: stiffnessMtrx.py:609-644 + 756-758 + 310-341).  The box's
        secant + Kg tangent of a C3D4 mesh takes the Newton element kernel
        (``_newton_element_parts``); every other route the einsums below.
        Under a profile the element tangent is the span
        "femcy.newton.tangent" and its scatter "femcy.newton.scatter"; the
        box's route without Kg has the scatter alone, since P3 makes the
        tangent inside it.
        """
        if self._newton_element:
            dof, values, f_int, vol = self._newton_element_parts(
                dof, fixed, sval)
            return self._newton_finish(dof, values, f_int, rhs, fixed, vol)
        a = self._arrs
        cfg = self.config
        dof, coords, dsdx, vol, sigma, f_int = self._internal_force_parts(
            dof, fixed, sval
        )
        if (cfg.tangent == "consistent" or self._structured_plan is None
                or cfg.geometric_stiffness):
            with span("femcy.newton.tangent"):
                if cfg.tangent == "consistent":
                    Ke = assembly.consistent_tangent(
                        dof, a["elements"], a["nodes"], a["dN"], a["w"],
                        self.material
                    )
                else:
                    Ke = assembly.element_stiffness(dsdx, vol, a["C"])
                    if cfg.geometric_stiffness:
                        Ke += assembly.geometric_stiffness(dsdx, sigma, vol)
            with span("femcy.newton.scatter"):
                values = self._scatter(Ke)
        else:
            with span("femcy.newton.scatter"):
                values = self._structured_values(coords)
        return self._newton_finish(dof, values, f_int, rhs, fixed, vol)

    def _newton_finish(self, dof, values, f_int, rhs, fixed, vol):
        """The end of every Newton evaluation: the stabilization diagonal,
        the residual and the Newton Dirichlet treatment."""
        self._add_stab_diag(values)
        residual = f_int - rhs
        values, residual = self._dirichlet_newton(values, residual, fixed)
        return dof, values, residual, _rms(residual), vol

    def _add_stab_diag(self, values):
        """Static stabilization's tangent term, in place: the diagonal
        matching the viscous force folded into f_int by
        ``_internal_force_parts`` (every route's values are fresh)."""
        if self._stab_diag is None:
            return
        d = self._stab_scale * self._stab_diag
        if self.dia is not None:
            values[:, self.dia.diag_idx] += d
        else:
            values.view(-1)[self._arrs["diag_slot"]] += d

    def _residual_rms(self, dof, rhs, fixed, sval):
        """(pinned dof, rms of the Dirichlet-zeroed Newton residual) with no
        tangent: the device loop's line-search and convergence probe."""
        dof, _, _, _, _, f_int = self._internal_force_parts(dof, fixed, sval)
        residual = torch.where(fixed, f_int.new_zeros(()), f_int - rhs)
        return dof, _rms(residual)

    def _fused_step(self, dof, rhs, fixed, sval):
        """One fused Newton iteration (config.fused_newton): the evaluation
        and its CG.  Returns (pinned dof, du, rms residual at dof, vol)."""
        dof, values, residual, res, vol = self._newton_eval(
            dof, rhs, fixed, sval)
        return dof, self._step_solve(values, residual), res, vol

    def _step_solve(self, values, residual):
        """The Newton solve of the fused step and the device loop: the
        dense CG below ``dense_operator_max_dof``, else the Jacobi PCG of
        the layout (block-Jacobi on DIA under "block_jacobi"), whatever
        ``preconditioner`` and ``linear_solver`` say -- femcy_tpu's
        in-program dispatch.  Records the iterations but never warns at
        the cap, as femcy_tpu's does not."""
        cfg = self.config
        if self._use_dense_cg:
            du, iters, _ = self._dense_cg_core(values, residual)
        elif self.dia is not None:
            du, iters, _ = dia_pcg_solve(
                values, self.dia.offsets, self.dia.diag_idx, residual,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                block_dm=self._block_dm, spmv=self._spmv,
            )
        else:
            du, iters, _ = pcg_solve(
                values, self._arrs["colidx"], self._arrs["diag_slot"],
                residual, eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                spmv=self._spmv,
            )
        self._last_cg_iters = iters
        self._cg_iters_log.append(iters)
        return du

    def _dense_cg_core(self, values, b):
        """Small-model dense CG: the eliminated layout values -> a dense
        (n, n) operator (one indexed add, built once per solve and freed
        with it) -> the dense-matvec Jacobi (or node-block-Jacobi) PCG.
        Returns (x, iterations, max|r|)."""
        cfg = self.config
        if self.dia is not None:
            A = dia_to_dense_device(values, self.dia.offsets)
        else:
            A = ell_to_dense(values, self._arrs["colidx"], self.mesh.n_dof)
        return dense_pcg_solve(A, b, eps=cfg.cg_eps,
                               max_iters=cfg.cg_max_iters,
                               block_dm=self._block_dm)

    def _linear_system(self, rhs, fixed, sval):
        """Assemble + Dirichlet-eliminate for the linear path, always on the
        initial configuration (as femcy_tpu's _linear_system_impl); the
        spans "femcy.assemble" and "femcy.dirichlet" under a profile."""
        with span("femcy.assemble"):
            values = self._assemble_values()
        with span("femcy.dirichlet"):
            if self.dia is not None:
                values, rhs = dia_dirichlet_linear(
                    values, self.dia.offsets, self.dia.diag_idx, rhs, fixed,
                    sval
                )
            else:
                values, rhs = bc_mod.apply_dirichlet_linear(
                    values, self._arrs["colidx"], self._arrs["diag_slot"],
                    rhs, fixed, sval,
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
        have nothing to reuse and ignore it.

        The CG ladder is femcy_tpu's: the multigrid, the AMG, the dense
        small-model CG (``dense_operator_max_dof``), then the Jacobi PCG of
        the layout."""
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
        # <=0 means "up to n_dof", like the Jacobi path
        max_iters = cfg.cg_max_iters if cfg.cg_max_iters > 0 else self.mesh.n_dof
        if cfg.preconditioner == "multigrid":
            self._ensure_multigrid(fixed)
            x, iters, rmax = self._mg.pcg_solve(
                values, b, eps=cfg.cg_eps, max_iters=max_iters, spmv=self._spmv
            )
            return cg_done(self, self.mesh.n_dof, "MG-CG", x, iters, rmax, b)
        if cfg.preconditioner == "amg":
            self._ensure_amg(fixed, values=values)
            # the eliminated operator in M3's layout, once per solve
            fine = k_bell.from_ell(self._bell_fine, values)
            x, iters, rmax = self._amg.pcg_solve(
                b, lambda v: k_bell.spmv(fine, v), eps=cfg.cg_eps,
                max_iters=max_iters,
            )
            return cg_done(self, self.mesh.n_dof, "AMG-CG", x, iters, rmax, b)
        if self._use_dense_cg:
            x, iters, rmax = self._dense_cg_core(values, b)
        elif self.dia is not None:
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
        return cg_done(self, self.mesh.n_dof, "CG", x, iters, rmax, b)

    def _refine_linear_solve(self, rhs_np, fixed_np, sval_np, fixed_d,
                             sval_d):
        """Mixed-precision iterative refinement (femcy_tpu's
        ``_refine_linear_solve``): x_{k+1} = x_k + solve(b - K_f64 x_k),
        the residual on the host against the exactly-assembled f64 CSR
        operator (assembly_host), every inner solve the regular
        ``_solve_linear_system`` in the system's dtype on the eliminated
        device operator (one cached LU on the direct path).  Returns the
        f64 solution (numpy)."""
        from femcy_tpu_torch import assembly_host

        cfg = self.config
        if self._refine_K is None:
            pattern = self.pattern
            if pattern is None:
                pattern = build_pattern(self.mesh)
            self._refine_K = assembly_host.assemble_csr_host(
                self.mesh, pattern, np.asarray(self.material.C))
            self._refine_reuse = {}
        K_bc, b = assembly_host.dirichlet_csr_host(
            self._refine_K, rhs_np, fixed_np, sval_np)
        # the inner operator: the eliminated device assembly (initial
        # configuration, constant across increments for a fixed mask)
        values, _, _ = self._linear_system(
            torch.zeros_like(self.dof), fixed_d, sval_d)
        x = np.zeros(self.mesh.n_dof)
        bmax = float(np.abs(b).max())
        rmax = bmax
        it = 0
        self._suppress_cg_warn = True  # truncated inner solves are expected
        try:
            for it in range(cfg.refine_max_iters):
                r = b - K_bc @ x
                rmax = float(np.abs(r).max())
                if bmax == 0.0 or rmax <= cfg.refine_tol * bmax:
                    break
                d = self._solve_linear_system(
                    values, torch.as_tensor(r, dtype=self.dtype,
                                            device=self.device),
                    fixed_d, reuse=self._refine_reuse,
                )
                x = x + d.cpu().numpy().astype(np.float64)
        finally:
            self._suppress_cg_warn = False
        self._refine_iters = it
        if bmax > 0.0 and rmax > 1.0e-6 * bmax:
            logger.warning(
                "mixed-precision refinement stalled at ||r||/||b||=%.3e "
                "after %d iterations (kappa*eps_f32 too large?)",
                rmax / bmax, it,
            )
        elif cfg.verbose:
            logger.info("refinement: %d outer iterations, ||r||/||b||=%.3e",
                        it, rmax / (bmax + 1e-300))
        return x

    def _refine_tangent(self, dof, fixed, sval):
        """The frozen tangent of the Newton refinement: the consistent one
        at ``dof`` (the secant is not contractive there), plus the
        stabilization diagonal when on, Newton-Dirichlet-eliminated."""
        a = self._arrs
        dof = bc_mod.pin_dof(dof, fixed, sval)
        Ke = assembly.consistent_tangent(
            dof, a["elements"], a["nodes"], a["dN"], a["w"], self.material)
        values = self._scatter(Ke)
        self._add_stab_diag(values)
        values, _ = self._dirichlet_newton(values, torch.zeros_like(dof),
                                           fixed)
        return values

    def _newton_refine(self, rhs, fixed, sval):
        """Mixed-precision refinement of a converged Newton increment
        (femcy_tpu's ``_newton_refine``): modified-Newton steps whose
        residual is the f64 host internal force (plus the stabilization
        force when on), each solve in the system's dtype against the
        frozen consistent tangent, refreshed when an iteration contracts
        by less than 10x.  Stops at ``refine_tol`` of the force scale, on
        no progress, or after ``refine_max_iters``.  Writes the f64 state
        to ``dof_refined`` and its rounding to ``dof``."""
        from femcy_tpu_torch import assembly_host

        cfg = self.config
        rhs_np, fixed_np, sval_np = self._host_bc
        fixed_np = np.asarray(fixed_np, bool)
        dof = self.dof.cpu().numpy().astype(np.float64)
        dof = np.where(fixed_np, np.asarray(sval_np, np.float64), dof)

        def device(v):
            return torch.as_tensor(v, dtype=self.dtype, device=self.device)

        values = self._refine_tangent(device(dof), fixed, sval)
        reuse = {}  # one LU for the whole refinement (modified Newton)

        # the equilibrium the device Newton converged to includes the
        # stabilization force; the f64 residual measures that same system
        stab_scale = 0.0
        stab_d = stab_ref = None
        if self._stab_diag is not None:
            stab_scale = float(self._stab_scale)
            if stab_scale != 0.0:
                stab_d = self._stab_diag.cpu().numpy().astype(np.float64)
                stab_ref = self._stab_ref.cpu().numpy().astype(np.float64)

        def f64_residual(d):
            f = assembly_host.internal_force_host(
                self.mesh, self.material, d, large=True)
            if stab_d is not None:
                f = f + stab_scale * stab_d * (d - stab_ref)
            r = f - rhs_np
            r[fixed_np] = 0.0
            return r, float(np.sqrt(np.mean(f * f)))

        r, scale = f64_residual(dof)
        rms = float(np.sqrt(np.mean(r * r)))
        floor = cfg.refine_tol * max(scale, 1e-300)
        it = 0
        self._suppress_cg_warn = True
        try:
            for it in range(cfg.refine_max_iters):
                if rms <= floor:
                    break
                du = self._solve_linear_system(values, device(r), fixed,
                                               reuse=reuse)
                dof_new = dof - du.cpu().numpy().astype(np.float64)
                r_new, _ = f64_residual(dof_new)
                rms_new = float(np.sqrt(np.mean(r_new * r_new)))
                if rms_new >= rms:
                    break  # no progress: the solve's noise floor
                contraction = rms_new / max(rms, 1e-300)
                dof, r, rms = dof_new, r_new, rms_new
                if rms > floor and contraction > 0.1:
                    # the frozen tangent's rate is linear: refresh it at the
                    # current state (one evaluation and one LU)
                    values = self._refine_tangent(device(dof), fixed, sval)
                    reuse["refresh"] = True
        finally:
            self._suppress_cg_warn = False
        self._refine_iters = it
        if cfg.verbose:
            logger.info("newton refinement: %d iterations, "
                        "rms(r64)/rms(f)=%.3e", it, rms / max(scale, 1e-300))
        self.dof = device(dof)
        self.dof_refined = dof

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

    def _ensure_amg(self, fixed, values=None):
        """Build (or rebuild on a changed fixed-dof mask) the smoothed-
        aggregation hierarchy (solvers/amg.py).

        With ``values`` (the caller's already eliminated device ELL
        operator) the hierarchy is built from that operator pulled back
        once through bf16 (one device-to-host copy) into a BSR matrix
        straight from the blockwise ELL layout.  Without ``values`` it
        falls back to the f64 host twin (assembly_host), cached.  Either
        way the hierarchy is kept across increments and Newton iterations
        while the mask holds; the PCG always iterates on the caller's
        exact current operator, so on the nonlinear path it is a frozen-
        hierarchy preconditioner (still SPD, still convergent).
        ``_amg_host_seconds`` records the host phases of a build; every
        phase is timed, so "unattributed" is what none of them covers."""
        # within one increment every Newton solve passes the same mask
        # object: no device-to-host copy and hash per linear solve
        if self._amg is not None and fixed is self._amg_fixed_obj:
            return
        import scipy.sparse as sp

        from femcy_tpu_torch import assembly_host

        wall0 = _time.perf_counter()
        host_s = {}
        fixed_np = fixed.cpu().numpy().astype(bool)
        key = fixed_np.tobytes()
        host_s["fixed_key"] = _time.perf_counter() - wall0
        if self._amg is not None and self._amg_fixed_key == key:
            self._amg_fixed_obj = fixed
            return
        with span("femcy.setup.amg"):
            if self._bell_plan is None:
                t = _time.perf_counter()
                self._bell_plan = build_bell_plan(self.pattern, self.mesh.dm)
                self._bell_fine = k_bell.fine_plan(self._bell_plan,
                                                   self.device)
                host_s["bell_plan"] = _time.perf_counter() - t
            plan = self._bell_plan
            n_dof = self.mesh.n_dof
            if values is not None:
                # the exact operator being solved, pulled back in bf16: the
                # hierarchy is a preconditioner, 8 significand bits suffice
                t = _time.perf_counter()
                values_np = values.to(torch.bfloat16).float().cpu().numpy()
                host_s["pullback"] = _time.perf_counter() - t
                # direct BSR from the blockwise ELL layout: a reshape and a
                # boolean select, no CSR intermediate
                t = _time.perf_counter()
                dm = plan.dm
                blocks = values_np.reshape(
                    plan.n_nodes, dm, plan.width, dm
                ).transpose(0, 2, 1, 3)[plan.valid]
                indptr = np.zeros(plan.n_nodes + 1, dtype=np.int64)
                np.cumsum(plan.valid.sum(axis=1), out=indptr[1:])
                K_bc = sp.bsr_matrix(
                    (blocks, plan.ncol[plan.valid].astype(np.int64), indptr),
                    shape=(n_dof, n_dof),
                )
                host_s["bsr"] = _time.perf_counter() - t
            else:
                t = _time.perf_counter()
                if self._amg_raw_csr is None:
                    self._amg_raw_csr = assembly_host.assemble_csr_host(
                        self.mesh, self.pattern, np.asarray(self.material.C)
                    )
                zeros = np.zeros(n_dof)
                K_bc, _ = assembly_host.dirichlet_csr_host(
                    self._amg_raw_csr, zeros, fixed_np, zeros
                )
                host_s["host_twin"] = _time.perf_counter() - t
            t = _time.perf_counter()
            # the plan already holds the node adjacency: the hierarchy's fine
            # graph (fully fixed nodes isolated, as in the eliminated operator)
            fine_graph = plan_node_graph(plan, fixed_np)
            host_s["fine_graph"] = _time.perf_counter() - t
            self._amg = None  # release the old hierarchy before the new one
            self._amg = AlgebraicMultigrid(
                K_bc, self.mesh.dm, self.mesh.nodes, fixed_np,
                fine_strength_theta=self.config.amg_fine_theta,
                dtype=self.dtype, fine_graph=fine_graph, device=self.device,
            )
            self._amg_fixed_key = key
            self._amg_fixed_obj = fixed
        host_s["unattributed"] = (
            _time.perf_counter() - wall0
            - sum(host_s.values())
            - self._amg.setup_seconds["total"]
        )
        self._amg_host_seconds = host_s
        if self.config.verbose:
            logger.info("amg: %d levels %s, complexity %.3f; host %s, setup %s",
                        self._amg.n_levels,
                        [lv.n_dof for lv in self._amg.levels],
                        self._amg.complexity, host_s,
                        self._amg.setup_seconds)

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
        t_start = _time.perf_counter()
        cfg = self.config
        if cfg.device_loop:
            # the device-loop program (device_loop.py); raises on what it
            # cannot express and never runs the host loop in its place
            from femcy_tpu_torch.device_loop import _unsupported, device_solve

            why = _unsupported(cfg, self, on_increment, on_newton)
            if why is not None:
                raise ValueError(f"device_loop: {why}")
            return device_solve(self, inp, user_dirichlet, resume=resume)
        incs = inp.time_incs
        if not resume:
            self.dt = incs["ini_inc"]
            self.time0 = self.time1 = 0.0
            self.dof = torch.zeros_like(self.dof)

        patterns, tractions = bc_mod.build_neumann_patterns(self.mesh, inp.neumann_bcs)
        patterns_d = torch.as_tensor(patterns, dtype=self.dtype, device=self.device)
        tractions_d = torch.as_tensor(tractions, dtype=self.dtype, device=self.device)

        # static stabilization setup (config.stabilize_factor): the damping
        # matrix is the volume-lumped diagonal; the coefficient C is
        # calibrated from the first converged increment's elastic energy
        stab_on = cfg.stabilize_factor > 0.0 and self.geometric_nonlinear
        stab_energy = 0.0
        stab_c: Optional[float] = None  # calibrated (C); None until then
        if stab_on:
            if self._stab_diag is None:
                self._stab_diag = self._lumped_volume_diag()
                self._stab_ref = self.dof
                self._stab_scale = self._scalar(0.0)
        else:
            # off, or switched off since a previous solve
            self._stab_diag = self._stab_ref = self._stab_scale = None

        # linear-extrapolation predictor state (config.predictor): the
        # previous converged solution and the time step that produced
        # dof_old from it
        dof_prev: Optional[torch.Tensor] = None
        dt_prev = 0.0

        def before_inc(dof_old):
            if (
                cfg.predictor == "extrapolate"
                and self.geometric_nonlinear
                and dof_prev is not None
                and dt_prev > 0.0
            ):
                alpha = (self.time1 - self.time0) / dt_prev
                self.dof = dof_old + alpha * (dof_old - dof_prev)
            if stab_on:
                self._stab_ref = dof_old
                self._stab_scale = self._scalar(
                    0.0 if stab_c is None  # calibration increment: undamped
                    else stab_c / (self.time1 - self.time0)
                )

        def boundary(time1, load_ratio):
            with span("femcy.boundary"):
                fixed, sval = bc_mod.build_dirichlet_arrays(
                    inp.dirichlet_bcs, self.mesh, time1, load_ratio, user_dirichlet
                )
                fixed_d = torch.as_tensor(fixed, device=self.device)
                sval_d = torch.as_tensor(sval, dtype=self.dtype, device=self.device)
                self._last_dirichlet = (fixed_d, sval_d)
                if patterns.shape[0]:
                    rhs = (tractions_d * load_ratio) @ patterns_d
                else:
                    rhs = torch.zeros_like(self.dof)
                # f64 host copies feed the refinement's exact residual
                self._host_bc = None
                if cfg.mixed_precision_refine:
                    rhs_np = ((tractions * load_ratio) @ patterns
                              if patterns.shape[0] else np.zeros(self.mesh.n_dof))
                    self._host_bc = (rhs_np, fixed, sval)
                return rhs, fixed_d, sval_d

        def after_inc(dof_old):
            nonlocal dof_prev, dt_prev, stab_c, stab_energy
            if stab_on:
                du_inc = self.dof - dof_old
                mduu = float((self._stab_diag * du_inc * du_inc).sum())
                if stab_c is None:
                    # calibrate C so this increment WOULD have dissipated
                    # stabilize_factor x its elastic energy (Abaqus's
                    # dissipated-energy-fraction scheme, constant factor)
                    elas0 = abs(self.elastic_energy())
                    if mduu > 0.0 and elas0 > 0.0:
                        stab_c = (
                            cfg.stabilize_factor * elas0
                            * (self.time1 - self.time0) / mduu
                        )
                        logger.info(
                            "stabilization calibrated: C=%.3e "
                            "(dissipated-energy fraction %.1e)",
                            stab_c, cfg.stabilize_factor,
                        )
                else:
                    # dissipated energy of this increment: f_damp . du
                    stab_energy += float(self._stab_scale) * mduu
            dof_prev, dt_prev = dof_old, self.time1 - self.time0

        def increment_done(system, record):
            if cfg.checkpoint_path:
                self._write_checkpoint(cfg.checkpoint_path, record.kinc)
            if on_increment is not None:
                on_increment(self, record)

        def rescue(rhs, fixed, sval, on_newton):
            nonlocal dof_prev, dt_prev
            out = dynamic_traverse(self, rhs, fixed, sval, on_newton)
            if out[0]:  # statics resume with no predictor history
                dof_prev, dt_prev = None, 0.0
            return out

        with span("femcy.solve"):
            records, success, message = run_increments(
                self, incs, boundary, on_newton, increment_done, before_inc,
                after_inc,
                self._diagnose_failure if cfg.diagnose_failure else None,
                rescue if cfg.dynamic_rescue and self.geometric_nonlinear
                else None,
            )

        if stab_on and success and stab_energy > 0.0:
            elas = abs(self.elastic_energy())
            if stab_energy > cfg.stabilize_energy_warn * max(elas, 1e-300):
                logger.warning(
                    "stabilization dissipated %.3e of energy (%.1f%% of the "
                    "elastic energy %.3e) -- the viscous bias is NOT small; "
                    "reduce stabilize_factor",
                    stab_energy, 100.0 * stab_energy / max(elas, 1e-300), elas,
                )
        return SolveReport(
            success=success,
            increments=records,
            wall_time=seconds_since(t_start, self.device),
            message=message,
            stabilization_energy=stab_energy,
        )

    def _scalar(self, value: float) -> torch.Tensor:
        """A 0-d tensor of the system's dtype and device."""
        return torch.tensor(value, dtype=self.dtype, device=self.device)

    def _lumped_volume_diag(self) -> torch.Tensor:
        """Unit-density volume-lumped nodal diagonal, one entry per dof:
        each element spreads its volume equally over its nodes (host, once
        per system).  The damping matrix of ``stabilize_factor``; its
        absolute scale cancels against the calibrated coefficient."""
        ev = self._arrs["vol0"].cpu().numpy().sum(axis=1)
        npe = self.mesh.element.n_nodes
        nodal = np.zeros(self.mesh.n_nodes)
        np.add.at(nodal, self.mesh.elements.reshape(-1),
                  np.repeat(ev / npe, npe))
        return torch.as_tensor(np.repeat(nodal, self.mesh.dm),
                               dtype=self.dtype, device=self.device)

    def _tangent_diag_host(self, rhs, fixed, sval) -> np.ndarray:
        """Diagonal of the Dirichlet-treated Newton tangent at the current
        state, on the host: ``dynamic_traverse``'s pseudo-time scale.  One
        single-device evaluation, also under sharding (as femcy_tpu's)."""
        _, values, _, _, _ = self._newton_eval(self.dof, rhs, fixed, sval)
        if self.dia is not None:
            d = values[:, self.dia.diag_idx]
        else:
            d = values.view(-1)[self._arrs["diag_slot"]]
        return d.cpu().numpy()

    def _advance_inc(self, rhs, fixed, sval, on_newton=None):
        """One load increment (ref: stiffnessMtrx.py:714-822): assemble,
        eliminate and solve on the linear path; the Newton-Raphson loop
        (``run_newton``) on the geometric-nonlinear one.

        Returns (converged, newton_loops, final residual).
        """
        cfg = self.config
        sh = self._shard_sys
        if sh is not None and hasattr(sh, "new_increment"):
            # the banded solver's preconditioner setup is made once per
            # increment
            sh.new_increment()
        if not self.geometric_nonlinear:
            if sh is not None:
                with self.timer.section("sharded_linear"):
                    x, iters = sh.solve(rhs.cpu().numpy(), fixed.cpu().numpy(),
                                        sval.cpu().numpy())
                self._last_cg_iters = iters
                self._cg_iters_log.append(iters)
                self.dof = torch.as_tensor(x, dtype=self.dtype,
                                           device=self.device)
                return True, 0, 0.0
            if cfg.mixed_precision_refine and self._host_bc is not None:
                with self.timer.section("refine_solve"):
                    x = self._refine_linear_solve(*self._host_bc, fixed, sval)
                self.dof = torch.as_tensor(x, dtype=self.dtype,
                                           device=self.device)
                self.dof_refined = x
                self._last_vol = self._arrs["vol0"]
                return True, 0, 0.0
            with self.timer.section("assemble+bc"):
                values, rhs_bc, vol = self._linear_system(rhs, fixed, sval)
            with self.timer.section("linear_solve"):
                self.dof = self._solve_linear_system(values, rhs_bc, fixed)
            self._last_vol = vol
            return True, 0, 0.0

        if sh is not None:
            return self._advance_inc_sharded(rhs, fixed, sval, on_newton)
        newton_count = {"n": -1}
        # fused_newton: one step per iteration is both the evaluator and
        # the solver; du rides in the values slot and lin_solve unwraps it
        fused = cfg.fused_newton

        def evaluate(dof):
            with self.timer.section("fused_step" if fused else "newton_eval"):
                if fused:
                    dof, values, res, vol = self._fused_step(
                        dof, rhs, fixed, sval)
                    residual = None
                else:
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
            if fused:
                return values
            with self.timer.section("linear_solve"):
                return self._solve_linear_system(
                    values, residual, fixed, reuse=reuse
                )

        def finish(dof):
            self.dof = dof

        converged, newton_loop, residual_val, self._ini_residual = run_newton(
            self.dof, evaluate, lin_solve, finish, cfg, self._ini_residual
        )
        if converged and cfg.mixed_precision_refine and self._host_bc is not None:
            if fused:
                if not self._warned_fused_refine:
                    logger.warning(
                        "mixed_precision_refine is skipped under "
                        "fused_newton (no host residual hook in the fused "
                        "step); use the standard Newton path")
                    self._warned_fused_refine = True
            else:
                with self.timer.section("newton_refine"):
                    self._newton_refine(rhs, fixed, sval)
        return converged, newton_loop, residual_val

    def _advance_inc_sharded(self, rhs, fixed, sval, on_newton=None):
        """The Newton increment under sharding: ``run_newton`` over the
        sharded solver's evaluation and CG, the working dof, tangent and
        residual as its blocks (slabs, or the banded solver's permuted
        block rows; femcy_tpu's sharded branch of ``_advance_inc``).  The
        stabilization / Newmark hook's blocks are stacked once per
        increment.  No refinement under sharding."""
        sh = self._shard_sys
        rhs_s = sh.stack(rhs)
        fixed_np = fixed.cpu().numpy()
        fixed_s = sh.stack(fixed_np)
        sval_s = sh.stack(sval)
        stab_s = None
        if self._stab_diag is not None:
            stab_s = (sh.stack(self._stab_diag), sh.stack(self._stab_ref),
                      self._stab_scale)
        newton_count = {"n": -1}

        def evaluate(dof):
            with self.timer.section("newton_eval"):
                dof, values, residual, res = sh.newton_eval(
                    dof, rhs_s, fixed_s, sval_s, stab_s=stab_s)
                res = float(res)
            newton_count["n"] += 1
            if on_newton is not None:
                finish(dof)
                on_newton(self, newton_count["n"], res)
            return dof, values, residual, res

        def lin_solve(values, residual, reuse=None):
            with self.timer.section("linear_solve"):
                du, iters, rmax = sh.cg(values, residual, fixed_np, fixed_s)
            b_max = torch.stack([r.abs().max().cpu() for r in residual])
            return cg_done(self, self.mesh.n_dof, f"{self.config.sharding} CG",
                           du, iters, rmax, b_max)

        def finish(dof):
            self.dof = torch.as_tensor(sh.unstack(dof), dtype=self.dtype,
                                       device=self.device)

        converged, newton_loop, residual_val, self._ini_residual = run_newton(
            sh.stack(self.dof), evaluate, lin_solve, finish, self.config,
            self._ini_residual)
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
        if (self._shard_sys is None
                and self.mesh.n_dof <= self.config.diagnose_eig_max_dof):
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
        with span("femcy.post"):
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
        assembled configuration's volumes (ref: stiffnessMtrx.py:592-606);
        under sharding, which keeps no global volumes, a nonlinear
        analysis integrates over the current configuration."""
        vol = self._last_vol
        if self._shard_sys is not None and self.geometric_nonlinear:
            a = self._arrs
            coords = a["nodes"] + self.dof.reshape(-1, self.mesh.dm)
            if self._structured_plan is not None:
                _, vol = assembly.gradients_and_volume_x(
                    structured_element_nodes(coords, self.mesh), a["dN"],
                    a["w"])
            else:  # sharding="banded": the general connectivity gather
                _, vol = assembly.gradients_and_volume(
                    coords, a["elements"], a["dN"], a["w"])
        dens = assembly.gp_energy_density(self.deformation_gradient(), self.material)
        return float((dens * vol).sum())

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
