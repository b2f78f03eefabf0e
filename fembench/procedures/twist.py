"""A geometrically nonlinear twist of the unit box: the z=0 face clamped,
the z=1 face turned about the vertical axis through ``center`` by the
angle ``sense * time * pi`` (all three dofs prescribed through the
program's user hook, as ``*Boundary, user`` gives them), in
``increments`` equal increments of ``inc``; ``inc`` and ``sense`` drawn
from the mix.  The check keeps the state after every converged increment.

Compared numbers, beside the field gaps of the returned state
(``checks.field_gaps``):

``newton_ratio``
    for every converged increment (the last one's state being the
    displacement the analysis returned), the rms of the internal force on
    the free dofs at the program's state over its rms at the increment's
    start (the previous state with the new prescribed values): the Newton
    rule, whose limit ``newton_rel_tol`` the mix states.
``prescribed_gap``
    the prescribed dofs of every increment's state against the values the
    reference works out, over their largest magnitude.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from fembench.harness import checks, meshes

NONLINEAR = True


def case(mix: dict, draw) -> dict:
    return {"inc": draw("inc"), "sense": draw("sense"),
            "increments": mix["increments"], "center": list(mix["center"])}


def rotation(center, sense: float):
    """The prescribed displacement: a rigid turn of the nodes about the
    vertical axis through ``center`` by ``sense * time * pi``, as the
    program's user hook takes it: ``fn(nodes (K, 3), dof, time) -> (K,)``."""
    cx, cy = float(center[0]), float(center[1])

    def fn(nodes, dof: int, time: float):
        angle = sense * time * math.pi
        c, s = math.cos(angle), math.sin(angle)
        x = np.asarray(nodes[:, 0], np.float64) - cx
        y = np.asarray(nodes[:, 1], np.float64) - cy
        if dof == 0:
            return c * x + s * y - x
        if dof == 1:
            return -s * x + c * y - y
        return np.zeros(nodes.shape[0])

    return fn


def times(inc: float, increments: int) -> List[float]:
    """The end time of each increment, summed as the load stepping sums
    them (time0 + dt), so the last one is exactly the analysis' end."""
    t, out = 0.0, []
    for _ in range(increments):
        t = t + inc
        out.append(t)
    return out


def prescribed(case: dict, nodes: np.ndarray, time: float):
    """(fixed mask, values) over the 3 N dofs at ``time``."""
    bottom, top = meshes.faces(nodes)
    fixed = np.zeros(3 * nodes.shape[0], dtype=bool)
    sval = np.zeros(3 * nodes.shape[0])
    fn = rotation(case["center"], case["sense"])
    for d in range(3):
        fixed[3 * bottom + d] = True
        fixed[3 * top + d] = True
        sval[3 * top + d] = fn(nodes[top], d, time)
    return fixed, sval


def prepare(mesh) -> dict:
    """What every case of a run shares, worked out once in set-up."""
    bottom, top = meshes.faces(mesh.nodes)
    return {"bottom": bottom, "top": top}


def solve(program, case: dict, keep: bool):
    """One twist; (success, the (time, displacement on the host) of every
    converged increment when ``keep``)."""
    bottom, top = program.prepared["bottom"], program.prepared["top"]
    bcs = [(bottom, d, 0.0, False) for d in range(3)]
    bcs += [(top, d, 0.0, True) for d in range(3)]
    inc = case["inc"]
    inp = program.inp_model(bcs, {
        "ini_inc": inc, "max_time": times(inc, case["increments"])[-1],
        "min_inc": 1e-5, "max_inc": inc})
    increments = []
    on_inc = None
    if keep:
        def on_inc(system, record):
            increments.append((record.time, system.dof.cpu()))
    report = program.system.solve(
        inp, user_dirichlet=rotation(case["center"], case["sense"]),
        on_increment=on_inc)
    return report.success, {"increments": increments}


def ended(sample: dict) -> bool:
    """Success, and the last converged increment at the planned end."""
    if not sample["success"]:
        return False
    case = sample["case"]
    end = times(case["inc"], case["increments"])[-1]
    incs = sample["increments"]
    return bool(incs) and abs(incs[-1][0] - end) <= 1e-12 * end


def _rms_free(torch, model, u, fixed):
    f = model.internal_force(u.view(model.n_nodes, 3), large=True).reshape(-1)
    f = torch.where(fixed, f.new_zeros(()), f)
    return float(torch.sqrt((f * f).sum() / f.numel()))


def numbers(torch, model, sample: dict):
    nodes = model.nodes.cpu().numpy()
    case = sample["case"]
    prev = torch.zeros(3 * model.n_nodes, dtype=torch.float64,
                       device=model.device)
    ratio, gap = 0.0, 0.0
    # the last increment's state is the analysis' answer, judged as returned
    incs = list(sample["increments"])
    if incs:
        incs[-1] = (incs[-1][0], sample["u"])
    for time, u in incs:
        fixed_np, sval_np = prescribed(case, nodes, time)
        fixed = checks.on(torch, model, fixed_np, torch.bool)
        sval = checks.on(torch, model, sval_np)
        u = u.to(model.device, torch.float64)
        start = torch.where(fixed, sval, prev)
        ratio = max(ratio, _rms_free(torch, model, u, fixed)
                    / _rms_free(torch, model, start, fixed))
        gap = max(gap, float((u - sval)[fixed].abs().max()
                             / sval[fixed].abs().max()))
        prev = u
    out = {"newton_ratio": ratio, "prescribed_gap": gap}
    out.update(checks.field_gaps(
        model, sample, sample["u"].to(model.device, torch.float64)
        .view(model.n_nodes, 3), large=True))
    return out
