"""Where a Newton evaluation's time goes on the card.

Builds the twist of ``chip_smoke.py``'s Newton phases at full width (the
1,053,696-element box with the multigrid, and the unstructured box on
ELL), evaluates the residual and tangent (``FEMSystem._newton_eval``) at
the first increment's pinned state, and traces a few evaluations and one
linear solve with ``torch.profiler``.  Prints, per case, the wall per
evaluation, the device busy time and share, and the device time by
kernel name (CUDA events only), with the card's name and power limit.

Run from the repository root on a machine with one card:

    python3 -m femcy_tpu_torch.tools.newton_profile
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

REPS = 5
DEVICE = "cuda"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _device_events(prof):
    """(total device microseconds, {name: device microseconds}) over the
    trace's CUDA events."""
    by_name = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total
    return sum(by_name.values()), by_name


def _case(label, mesh, config, card):
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.bc import build_dirichlet_arrays
    from femcy_tpu_torch.io.inp import DirichletBC
    from femcy_tpu_torch.user import make_rotation_dirichlet

    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
    fixed, sval = build_dirichlet_arrays(
        bcs, mesh, 0.004, 0.2, make_rotation_dirichlet((0.5, 0.5, 0.0)))
    system = FEMSystem(mesh, LinearIsotropic(1000.0, 0.3), True,
                       SolverConfig(**config), device=DEVICE)
    fixed = torch.as_tensor(fixed, device=DEVICE)
    sval = torch.as_tensor(sval, dtype=system.dtype, device=DEVICE)
    rhs = torch.zeros_like(system.dof)

    def evaluate():
        out = system._newton_eval(system.dof, rhs, fixed, sval)
        float(out[3])  # the evaluation's one read-back, as in solve()
        return out

    _, values, residual, _, _ = evaluate()  # builds the kernels' tables
    system._solve_linear_system(values, residual, fixed)  # and the cycle
    del values, residual
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REPS):
        evaluate()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / REPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            out = evaluate()
        torch.cuda.synchronize()
    busy, by_name = _device_events(prof)
    top_ = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"{label} on {card}: one Newton evaluation {wall * 1e3:.2f} ms of "
          f"wall; device busy {busy / REPS / 1e3:.2f} ms "
          f"({busy / REPS / 1e3 / (wall * 1e3):.1%}); by kernel, ms per "
          "evaluation: " + "; ".join(
              f"{name[:70]} {us / REPS / 1e3:.3f}" for name, us in top_),
          flush=True)

    _, values, residual, _, _ = out
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        system._solve_linear_system(values, residual, fixed)
        torch.cuda.synchronize()
        lin = time.perf_counter() - t
    busy, _ = _device_events(prof)
    print(f"{label} on {card}: one tangent solve {lin * 1e3:.2f} ms of wall "
          f"under the profiler, {system._last_cg_iters} CG iterations, "
          f"device busy {busy / 1e3:.2f} ms ({busy / 1e3 / (lin * 1e3):.1%})",
          flush=True)


def main() -> None:
    from femcy_tpu_torch.meshgen import box_tets, unstructured_box_tets

    card = _card()
    print(card, flush=True)
    _case("box Newton", box_tets(56, 56, 56),
          dict(preconditioner="multigrid", linear_solver="cg"), card)
    _case("ELL Newton", unstructured_box_tets(56), {}, card)


if __name__ == "__main__":
    main()
