"""Riks (arc-length) continuation for limit-point problems.

Torch counterpart of ``femcy_tpu.solvers.riks``.  Load control cannot pass
a limit point: beyond the fold no equilibrium exists at the next load.
Arc-length control makes the load factor lambda an unknown and constrains
the step size along the equilibrium path instead, so the solver walks
through folds and reports them.

Ramm's normal-plane variant (cylindrical constraint, psi = 0): per
corrector iteration solve the same tangent against two right-hand sides
(residual and load pattern) and pick dlambda so the correction stays
normal to the accumulated step:

    K du_r = r,   K du_q = q_bc
    dlam = (Du . du_r) / (Du . du_q),    du = -du_r + dlam du_q

The device work is FEMSystem's Newton evaluation (``_newton_eval``) and
linear solve (``_solve_linear_system``); the continuation logic is a host
loop that reads each scalar it tests back once.

Scope: geometric nonlinearity with proportional Neumann loading and
homogeneous Dirichlet BCs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

import numpy as np
import torch

from femcy_tpu_torch import bc as bc_mod

logger = logging.getLogger("femcy_tpu_torch")


@dataclasses.dataclass
class RiksStep:
    step: int
    lam: float
    dl: float
    iters: int
    residual: float
    #: current stiffness parameter q.du_q (sign change = limit point)
    stiffness: float
    u_norm: float


@dataclasses.dataclass
class RiksReport:
    success: bool  # reached lam_target
    steps: List[RiksStep]
    lam_max: float  # largest load factor visited
    limit_point: bool  # stiffness parameter changed sign
    lam_limit: float | None  # lambda at the first sign change
    #: converged state at the first negative-stiffness evaluation: the
    #: tangent there is indefinite (q . K^-1 q < 0), usable for det-K
    #: diagnostics
    u_limit: np.ndarray | None = None
    message: str = ""

    @property
    def lam_history(self):
        return [s.lam for s in self.steps]


def riks_solve(
    system,
    inp,
    lam_target: float = 1.0,
    first_dlam: float = 0.1,
    max_steps: int = 120,
    max_iters: int = 16,
    tol: float = 1.0e-6,
    dl_growth: float = 1.5,
    dl_cutback: float = 0.25,
    min_dl_ratio: float = 1.0e-4,
) -> RiksReport:
    """Trace the equilibrium path of ``inp``'s load case up to lam_target.

    ``system`` is a FEMSystem built for the same mesh/material with
    geometric_nonlinear=True; its dof state is updated in place.
    ``first_dlam`` sizes the first step as a fraction of the full load.
    """
    assert system.geometric_nonlinear, "riks_solve is for nonlinear problems"
    mesh = system.mesh

    def tensor(a):
        return torch.as_tensor(a, dtype=system.dtype, device=system.device)

    # proportional load pattern q at lambda = 1
    patterns, tractions = bc_mod.build_neumann_patterns(mesh, inp.neumann_bcs)
    if not patterns.shape[0]:
        raise ValueError("riks_solve needs Neumann (proportional) loading")
    q = tensor(np.einsum("b,bn->n", tractions, patterns))

    fixed_np, sval_np = bc_mod.build_dirichlet_arrays(
        inp.dirichlet_bcs, mesh, 1.0, 1.0, None
    )
    if np.any(sval_np != 0.0):
        raise ValueError(
            "riks_solve supports homogeneous Dirichlet BCs only "
            "(displacement-driven continuation is a different constraint)"
        )
    fixed = torch.as_tensor(fixed_np, device=system.device)
    sval = tensor(sval_np)
    q_bc = torch.where(fixed, torch.zeros_like(q), q)
    q_rms = float(torch.sqrt(torch.sum(q_bc * q_bc) / q_bc.shape[0]))

    def evaluate(u, lam):
        u, values, residual, res, vol = system._newton_eval(
            u, lam * q, fixed, sval
        )
        system._last_vol = vol
        return u, values, residual, float(res)

    def solve(values, b):
        return system._solve_linear_system(values, b, fixed)

    u = system.dof
    lam = 0.0
    Du_prev = None
    dl = None  # set from the first predictor
    steps: List[RiksStep] = []
    stiffness_prev = None
    limit_point = False
    lam_limit = None
    u_limit = None
    lam_max = 0.0
    success = False
    message = "max_steps reached"
    dl0 = None

    for step in range(max_steps):
        # ---- predictor -------------------------------------------------
        u0, lam0 = u, lam
        u_eval, values, residual, _ = evaluate(u, lam)
        du_q = solve(values, q_bc)
        norm_q = float(torch.linalg.norm(du_q))
        stiffness = float(torch.dot(q_bc, du_q))
        if stiffness < 0.0 and u_limit is None:
            # q . K^-1 q < 0 proves the tangent is indefinite here
            u_limit = u_eval.cpu().numpy()
        if stiffness_prev is not None and stiffness * stiffness_prev < 0.0:
            limit_point = True
            if lam_limit is None:
                lam_limit = lam
            logger.info(
                "riks: limit point detected near lambda=%.4f "
                "(stiffness parameter changed sign)", lam
            )
        stiffness_prev = stiffness

        if dl is None:
            dl = abs(first_dlam) * norm_q
            dl0 = dl
        if Du_prev is None:
            sign = 1.0
        else:
            # follow the path: keep the predictor aligned with the last step
            sign = 1.0 if float(torch.dot(Du_prev, du_q)) >= 0.0 else -1.0
        dlam = sign * dl / norm_q
        Du = dlam * du_q
        Dlam = dlam
        u = u_eval + Du
        lam = lam0 + Dlam

        # ---- corrector (normal plane) -----------------------------------
        converged = False
        res = np.inf
        for it in range(max_iters):
            u, values, residual, res = evaluate(u, lam)
            if not np.isfinite(res):
                break
            if res <= tol * q_rms * max(1.0, abs(lam)):
                converged = True
                break
            du_r = solve(values, residual)
            du_q = solve(values, q_bc)
            denom = float(torch.dot(Du, du_q))
            if denom == 0.0 or not np.isfinite(denom):
                break
            dlam = float(torch.dot(Du, du_r)) / denom
            du = -du_r + dlam * du_q
            u = u + du
            lam += dlam
            Du = Du + du
            Dlam += dlam

        if not converged:
            # retreat and shrink the arc
            u, lam = u0, lam0
            dl *= dl_cutback
            if dl < min_dl_ratio * dl0:
                message = "arc length shrank below the minimum"
                break
            continue

        Du_prev = Du
        lam_max = max(lam_max, lam)
        steps.append(
            RiksStep(
                step=step, lam=lam, dl=dl, iters=it + 1, residual=res,
                stiffness=stiffness,
                u_norm=float(torch.linalg.norm(u)),
            )
        )
        system.dof = u
        if it + 1 <= 5:
            dl = min(dl * dl_growth, 10.0 * dl0)

        if lam >= lam_target:
            # land exactly on the target with a short load-controlled Newton
            lam = lam_target
            for _ in range(max_iters):
                u, values, residual, res = evaluate(u, lam)
                if res <= tol * q_rms * max(1.0, abs(lam)):
                    break
                du_r = solve(values, residual)
                u = u - du_r
            system.dof = u
            success = res <= tol * q_rms * max(1.0, abs(lam))
            message = "reached lam_target" if success else (
                "overshot lam_target but could not re-converge at it"
            )
            break

    return RiksReport(
        success=success,
        steps=steps,
        lam_max=lam_max,
        limit_point=limit_point,
        lam_limit=lam_limit,
        u_limit=u_limit,
        message=message,
    )
