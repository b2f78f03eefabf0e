"""Solver configuration.

The reference has no config system (SURVEY.md §5) -- its knobs are hardcoded
(CG eps at conjugateGradientSolver.py:15, the scipy/CG crossover at
stiffnessMtrx.py:273, Newton caps at stiffnessMtrx.py:771-819).  Here they are
a dataclass so library users and the CLI can set them without editing code.

Copy of ``femcy_tpu.config``: every field and default is the same (pinned by
tests/test_torch_host.py), so a config written for the JAX package loads
here.  Values whose code path the port does not have yet raise
``NotImplementedError`` naming the ROADMAP slice that brings it.
"""

from __future__ import annotations

import dataclasses

#: (field, predicate on its value, the later slice that implements it)
_LATER = (
    ("sharding", lambda v: v == "banded",
     "banded multi-device sharding (ROADMAP slice I.3)"),
)

_CHOICES = {
    "linear_solver": ("auto", "direct", "cg"),
    "sparse_format": ("auto", "dia", "ell"),
    "spmv": ("auto", "slices", "pallas"),
    "preconditioner": ("jacobi", "block_jacobi", "multigrid", "amg"),
    "sharding": ("none", "slab", "banded"),
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Knobs of the equation-system solve.

    Defaults reproduce the reference behaviour exactly.
    """

    # --- linear solver ---------------------------------------------------
    #: relative residual (infinity norm) tolerance of the PCG
    #: (ref: conjugateGradientSolver.py:15, eps=1e-3).
    cg_eps: float = 1.0e-3
    #: hard cap on CG iterations; <=0 means n_dof (ref: CG loops at most
    #: b.shape[0] times, conjugateGradientSolver.py:109).
    cg_max_iters: int = 0
    #: below this many dofs use the host direct sparse solve, above it the
    #: on-device PCG (ref: stiffnessMtrx.py:273, 1e5 crossover).
    direct_solve_max_dof: int = 100_000
    #: force one solver regardless of size: "auto" | "direct" | "cg"
    linear_solver: str = "auto"
    #: sparse storage: "auto" picks the gather-free DIA (diagonal-offset)
    #: layout when the mesh's dof graph has a bounded offset set (structured
    #: grids, bandwidth-reduced meshes) -- XLA's gather/scatter on TPU is
    #: ~500x off HBM speed, so this is the fast path; "ell" forces the
    #: general padded-row layout; "dia" requires the DIA layout.
    sparse_format: str = "auto"
    #: max distinct column offsets for the DIA layout to be considered
    dia_max_offsets: int = 1024
    #: SpMV inside the CG: "auto" and "pallas" run the hand-written Hopper
    #: kernel on CUDA tensors (kernels/dia_spmv.py on the DIA layout,
    #: kernels/ell_spmv.py on the ELL layout), in any dtype and at any
    #: size; "slices" is an explicit request for the plain torch SpMV
    #: (shifted slices on DIA, the row gather on ELL).  On CPU tensors every
    #: value runs the plain version.
    spmv: str = "auto"
    #: small-model dense CG: when 0 < n_dof <= this, CG solves run with
    #: the Dirichlet-eliminated operator placed into a DENSE (n, n) matrix
    #: once per solve (solvers/cg.ell_to_dense, structured.
    #: dia_to_dense_device) and every matvec is one dense product.  It
    #: keeps the Newton solve on the device for models too small to fill
    #: it with a sparse SpMV.  0 disables (default): the host direct solver
    #: remains the choice below ``direct_solve_max_dof``.  Memory: n_dof^2
    #: * itemsize per operator.
    dense_operator_max_dof: int = 0
    #: CG preconditioner: "jacobi" (reference parity,
    #: conjugateGradientSolver.py:48-51), "block_jacobi" (dm x dm node
    #: blocks; fewer iterations for elasticity; DIA layout only),
    #: "multigrid" (geometric V-cycle; structured box_tets meshes with
    #: dyadically coarsenable dims only; mesh-independent iteration counts)
    #: or "amg" (smoothed-aggregation ALGEBRAIC multigrid, solvers/amg.py:
    #: any unstructured mesh on the general ELL path; host setup from an
    #: f64 twin assembly, device V-cycle; near-mesh-independent counts --
    #: 16/19/24/26 PCG iterations where Jacobi needs hundreds).  Applies to
    #: the CG path -- the direct solver ignores it.
    preconditioner: str = "jacobi"
    #: fine-level strength-of-connection threshold for the AMG hierarchy
    #: (solvers/amg.py fine_strength_theta).  0 (default) aggregates on the
    #: raw sparsity -- right for quasi-uniform meshes and cheapest to set
    #: up.  On strongly GRADED meshes set ~0.12: the Frobenius filter stops
    #: aggregation across large element-size jumps (measured at 12:1
    #: gradation: 38 -> 17 PCG iterations, equal dofs;
    #: tests/test_amg.py::test_amg_graded_mesh_iterations_bounded).
    amg_fine_theta: float = 0.0

    # --- mixed-precision refinement ---------------------------------------
    #: near-incompressible answer in float32 (FEMCY_TPU_X64=0): keep the
    #: BULK work (every inner linear solve) in float32 and recover float64
    #: accuracy by iterative refinement -- an outer loop computing the
    #: residual against the exactly-assembled f64 host operator
    #: (assembly_host.py) and feeding it back as a float32 correction
    #: solve.  Converges whenever kappa(K) * eps_f32 < 1.  On the
    #: geometric-nonlinear path each converged increment is polished by
    #: modified-Newton steps on the f64 host residual (the f64 state lands
    #: in ``FEMSystem.dof_refined``); skipped under ``fused_newton``.
    mixed_precision_refine: bool = False
    #: outer refinement iterations cap / relative-residual target
    refine_max_iters: int = 10
    refine_tol: float = 1.0e-11

    # --- multi-device sharding --------------------------------------------
    #: "none" runs single-device; "slab" shards the WHOLE analysis (linear
    #: solves and the full adaptive-stepping Newton state machine) over
    #: x-slabs of a structured box_tets mesh whose nx is divisible by the
    #: shard count (parallel/structured.py): one process drives every shard,
    #: the halos move between the shards' tensors.  "banded" (every .inp
    #: model: RCM ordering + block-tridiagonal row shards) is femcy_tpu's
    #: and raises until ROADMAP slice I.3.
    sharding: str = "none"
    #: number of shards; 0 = one per CUDA card (torch.cuda.device_count()).
    #: Shard i lives on card i % device count, or on the CPU for a CPU
    #: system, so several shards may share one device
    sharding_devices: int = 0

    # --- Newton-Raphson (geometric nonlinearity) -------------------------
    #: converged when residual / initial_residual < this
    #: (ref: stiffnessMtrx.py:771).
    newton_rel_tol: float = 0.01
    #: absolute convergence short-circuit (ref: stiffnessMtrx.py:767).
    newton_abs_tol: float = 1.0e-9
    #: max Newton iterations per increment (ref: stiffnessMtrx.py:774).
    newton_max_iters: int = 24
    #: max "boost" line-search steps while the residual keeps declining
    #: (ref: stiffnessMtrx.py:798).
    newton_boost_max: int = 10
    #: max relaxation halvings when the residual grows
    #: (ref: stiffnessMtrx.py:813).
    newton_relax_max: int = 2
    #: grow dt by this factor after fast convergence (<= fast_iters Newton
    #: loops) (ref: stiffnessMtrx.py:702-704).
    dt_growth: float = 1.5
    newton_fast_iters: int = 8
    #: shrink dt by this factor on non-convergence (ref: stiffnessMtrx.py:694).
    dt_cutback: float = 0.25
    #: include the initial-stress (geometric) stiffness in the Newton
    #: Jacobian.  The reference uses the secant material stiffness only
    #: (README.md:93), which stalls on the high-load Cook cases; the
    #: consistent tangent converges everywhere the secant does, faster.
    #: Set False for strict reference parity.
    geometric_stiffness: bool = True
    #: Newton Jacobian: "secant" = reference-style constant material tangent
    #: (+ geometric stiffness when enabled above); "consistent" = exact
    #: per-element tangent of the internal force by forward-mode autodiff
    #: (converges on the high-load Cook cases the secant cannot).
    tangent: str = "secant"
    #: reuse the factorized Jacobian across Newton iterations of one
    #: increment ("increment") instead of refactorizing every iteration
    #: ("never" = reference parity).  Modified Newton: factorize on the
    #: first iteration, refactorize only when the residual reduction stalls
    #: (ratio > newton_reuse_stall per iteration); every reused iteration
    #: then costs one triangular solve instead of a full LU.  Affects the
    #: host direct-solve path only (the CG path has nothing to reuse).
    newton_jacobian_reuse: str = "never"
    #: residual ratio above which a reused factorization is refreshed
    newton_reuse_stall: float = 0.3
    #: fuse each Newton iteration's residual + tangent evaluation and its
    #: CG linear solve into one step returning (dof, du, rms): the Newton
    #: state machine's evaluator is also its solver.  Forces the CG linear
    #: solver (dense below ``dense_operator_max_dof``, else the Jacobi PCG
    #: of the layout; never the multigrid or the AMG); the boost line
    #: search reuses the fused step as its evaluator, so each boost probe
    #: pays one (discarded) CG.
    fused_newton: bool = False
    #: initial guess for each increment's Newton iteration: "previous"
    #: starts from the last converged state (reference parity -- the
    #: reference always continues from the current dof); "extrapolate" is
    #: Abaqus/Standard's default linear extrapolation -- start from
    #: dof + (dt/dt_prev) * (dof - dof_prev_converged).  Fewer Newton
    #: iterations on smooth load paths, and it can carry large-rotation
    #: displacement-driven analyses through states the unpredicted Newton
    #: cannot reach.  Prescribed dofs are pinned exactly either way.
    predictor: str = "previous"
    #: run the whole nonlinear analysis -- adaptive load stepping, Newton
    #: with the boost line search and relaxation backtracking, the inner
    #: CG -- as the device-loop program of device_loop.py: line-search and
    #: convergence probes evaluate the residual alone, the boost undo keeps
    #: the pre-step state, and the linear solve is the fused step's CG
    #: dispatch (dense/DIA/ELL Jacobi; never the multigrid, the AMG or the
    #: direct solve).  Raises ValueError for a linear analysis,
    #: stabilization, dynamic rescue, refinement and per-increment or
    #: per-Newton callbacks.
    device_loop: bool = False
    #: per-solve cap on recorded (attempted) increments of the device loop;
    #: hitting it aborts with status 3 rather than looping unboundedly
    device_loop_max_records: int = 512
    #: what the relative Newton tolerance is measured against:
    #: "increment" (default) = the first residual of each increment;
    #: "global" = the first residual of the whole analysis, cached forever --
    #: the reference's quirky behaviour (stiffnessMtrx.py:760-762), which lets
    #: small increments "converge" with zero Newton work and accumulate error.
    newton_residual_ref: str = "increment"

    # --- static stabilization ----------------------------------------------
    #: viscous damping that carries a static analysis through LOCAL
    #: instabilities -- the same scheme as Abaqus ``*Static, stabilize``
    #: with a constant damping factor.  The damping matrix is the
    #: volume-lumped (unit-density mass) diagonal M_v; the damping force
    #: (C/dt)*M_v*(u - u_conv) is added to the residual and (C/dt)*M_v to
    #: the tangent diagonal.  The coefficient C is CALIBRATED from the first
    #: converged increment so that the energy it would have dissipated there
    #: equals ``stabilize_factor`` times that increment's elastic energy
    #: (Abaqus's "dissipated energy fraction", default there 2e-4); damping
    #: is inactive during that calibration increment.  At a LOCAL
    #: instability the tangent's soft mode is regularized proportionally to
    #: 1/dt, so the adaptive stepping machine finds the dt where Newton
    #: converges and crosses on a damped quasi-static path.  It cannot cross
    #: a within-increment SNAP (no nearby equilibrium: the C/dt term then
    #: degenerates to a frozen crawl -- measured on the C3D10 twist at
    #: 174.55 deg, see PARITY.md); use ``dynamic_rescue`` for those.  The
    #: dissipated energy accumulates in
    #: ``SolveReport.stabilization_energy`` and a warning fires when it
    #: exceeds ``stabilize_energy_warn`` of the elastic energy.  0 disables
    #: (default).  Geometric-nonlinear analyses only (sharded or not).
    stabilize_factor: float = 0.0
    #: warn when stabilization_energy / elastic_energy exceeds this
    stabilize_energy_warn: float = 0.05

    # --- implicit-dynamics snap traversal ----------------------------------
    #: when a geometric-nonlinear static analysis aborts (dt cut below
    #: min_inc) at a state where the structure SNAPS -- no nearby static
    #: equilibrium, so neither dt cutback nor viscous stabilization can
    #: help -- traverse the event with implicit dynamics instead of giving
    #: up: hold the loads/BCs just past the failure point, give the mesh a
    #: unit-density lumped mass, integrate Newmark-beta with numerical
    #: dissipation (``dynamic_gamma`` > 1/2) until the kinetic energy decays
    #: below ``dynamic_settle_tol`` of the elastic energy, then polish with
    #: a pure static Newton solve and resume the normal adaptive-stepping
    #: analysis from the far side.  This is the standard engineering answer
    #: to snap-through (Abaqus: restart the step as *Dynamic); the reference
    #: can only abort (stiffnessMtrx.py:698-701).  Each Newmark step reuses
    #: the full Newton machinery -- the effective tangent K + M/(beta h^2)
    #: rides the same code path as stabilize_factor.  Off by default.
    #: Geometric-nonlinear analyses only (sharded or not).
    dynamic_rescue: bool = False
    #: Newmark gamma; > 1/2 adds numerical (high-frequency) dissipation.
    #: beta is derived as (gamma + 1/2)^2 / 4 (unconditionally stable pair).
    dynamic_gamma: float = 0.75
    #: rescue settles when kinetic energy < this fraction of elastic energy
    #: for two consecutive steps
    dynamic_settle_tol: float = 1.0e-7
    #: abort the rescue after this many converged Newmark steps
    dynamic_max_steps: int = 400
    #: how far past the failure point to hold the schedule during a rescue
    #: (fraction of total time); 0 = the step's ini_inc
    dynamic_rescue_dt: float = 0.0
    #: maximum number of distinct rescues per solve()
    dynamic_max_rescues: int = 4

    # --- failure diagnostics ----------------------------------------------
    #: when a nonlinear analysis aborts (dt cut below min_inc), diagnose WHY
    #: and append the finding to ``SolveReport.message``: element inversion
    #: (min det(J)·w over all Gauss points of the failed trial
    #: configuration), and -- below the dof cap -- the smallest eigenvalue
    #: of the BC-constrained tangent at the last converged state.
    #: lambda_min <= 0 (or collapsing toward 0) means a limit/bifurcation
    #: point (e.g. buckling): load-stepped Newton cannot traverse it at ANY
    #: dt, so cutting dt further is futile -- use Riks arc-length
    #: continuation (load-driven folds), stabilization, or stop the schedule
    #: at the instability.  The reference aborts with no diagnosis
    #: (stiffnessMtrx.py:698-701).
    diagnose_failure: bool = True
    #: skip the eigenvalue probe above this many dofs (it runs a host
    #: shift-invert eigsh on the assembled tangent)
    diagnose_eig_max_dof: int = 50_000

    # --- observability ----------------------------------------------------
    verbose: bool = False

    # --- checkpointing ------------------------------------------------------
    #: if set, write an .npz checkpoint of (dof, time, dt) after every
    #: converged increment (the reference has none; SURVEY.md §5).
    checkpoint_path: str | None = None

    def __post_init__(self):
        for name, choices in _CHOICES.items():
            if getattr(self, name) not in choices:
                raise ValueError(
                    f"{name}={getattr(self, name)!r}: expected one of {choices}"
                )
        for name, later, slice_name in _LATER:
            if later(getattr(self, name)):
                raise NotImplementedError(
                    f"SolverConfig({name}={getattr(self, name)!r}) needs "
                    f"{slice_name}, not yet ported to femcy_tpu_torch"
                )
