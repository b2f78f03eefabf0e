"""Linear load cases on the unit box: the z=0 face clamped, the z=1 face's
x- and y-dofs prescribed at ``a (cos t, sin t)``, its z-dof free; ``a``
drawn from the mix's ``amplitude``, ``t`` from its ``angle`` (radians).
One fixed-dof mask for every case, so a preconditioner built on it in
set-up is kept.

Compared numbers, beside the field gaps (``checks.field_gaps``):

``residual_free``, ``residual_fixed``
    the eliminated system's residual at the program's displacement, on the
    free and on the prescribed rows, over the infinity norm of its right-
    hand side: the PCG's own stopping rule, whose limit ``cg_eps`` the mix
    states.
"""

from __future__ import annotations

import math

import numpy as np

from fembench.harness import checks, meshes

NONLINEAR = False


def case(mix: dict, draw) -> dict:
    return {"a": draw("amplitude"), "theta": draw("angle")}


def prescribed(case: dict, nodes: np.ndarray, time: float = 1.0):
    """(fixed mask, values) over the 3 N dofs."""
    bottom, top = meshes.faces(nodes)
    fixed = np.zeros(3 * nodes.shape[0], dtype=bool)
    sval = np.zeros(3 * nodes.shape[0])
    for d in range(3):
        fixed[3 * bottom + d] = True
    fixed[3 * top] = fixed[3 * top + 1] = True
    sval[3 * top] = case["a"] * math.cos(case["theta"])
    sval[3 * top + 1] = case["a"] * math.sin(case["theta"])
    return fixed, sval


def prepare(mesh) -> dict:
    """What every case of a run shares, worked out once in set-up."""
    bottom, top = meshes.faces(mesh.nodes)
    return {"bottom": bottom, "top": top}


def solve(program, case: dict, keep: bool):
    """One linear analysis of ``case``; (success, nothing more to keep)."""
    bottom, top = program.prepared["bottom"], program.prepared["top"]
    bcs = [(bottom, d, 0.0, False) for d in range(3)]
    bcs.append((top, 0, case["a"] * math.cos(case["theta"]), False))
    bcs.append((top, 1, case["a"] * math.sin(case["theta"]), False))
    inp = program.inp_model(bcs, {"ini_inc": 1.0, "max_time": 1.0,
                                  "min_inc": 1e-5, "max_inc": 1.0})
    return program.system.solve(inp).success, {}


def ended(sample: dict) -> bool:
    return sample["success"]


def numbers(torch, model, sample: dict):
    n = model.n_nodes
    fixed_np, sval_np = prescribed(sample["case"], model.nodes.cpu().numpy())
    fixed = checks.on(torch, model, fixed_np, torch.bool)
    sval = checks.on(torch, model, sval_np)
    u = sample["u"].to(model.device, torch.float64)
    zero = sval.new_zeros(())
    ku = model.internal_force(torch.where(fixed, sval, u).view(n, 3),
                              large=False).reshape(-1)
    ks = model.internal_force(torch.where(fixed, sval, zero).view(n, 3),
                              large=False).reshape(-1)
    b_norm = torch.where(fixed, sval, -ks).abs().max()
    out = {
        "residual_free": float(ku[~fixed].abs().max() / b_norm),
        "residual_fixed": float((u - sval)[fixed].abs().max() / b_norm),
    }
    out.update(checks.field_gaps(model, sample, u.view(n, 3), large=False))
    return out
