"""Where a consistent-tangent evaluation's time goes on the card, and what
the one-pass form saves.

``assembly.consistent_tangent_elems`` takes the element tangent as one
``torch.func.vmap`` of the jvp over the edof unit seeds; its first port
ran one jvp per seed in a Python loop (``loop_tangent`` below, kept here
as the yardstick).  On unstructured_box_tets(12) (10,368 C3D4, the mesh
of chip_smoke.py's "consistent tangent" Newton case) at a seeded state,
in float64, this prints for each form: its time by CUDA events and by
the host clock, and a ``torch.profiler`` breakdown of one call: kernel
launches and device time against host time (the share the device is
busy), and the five busiest kernels.  Both forms must agree to 1e-13
relative.

Run on the card from the repository root:

    python3 -m femcy_tpu_torch.tools.tangent_profile

It raises without a card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from femcy_tpu_torch import assembly
from femcy_tpu_torch.materials import LinearIsotropic
from femcy_tpu_torch.meshgen import unstructured_box_tets

NX = 12


def loop_tangent(u_e, x0_e, dN, w, material):
    """The loop form: one jvp per element dof j, with the unit seed e_j
    in every element, giving column j of every element's Jacobian."""
    E, n, dm = u_e.shape
    edof = n * dm
    u_flat = u_e.reshape(E, edof)

    def fe(u):
        return assembly._element_internal_force(u.reshape(E, n, dm), x0_e,
                                                dN, w, material)

    Ke = u_e.new_empty((E, edof, edof))
    seed = torch.zeros_like(u_flat)
    for j in range(edof):
        seed.zero_()
        seed[:, j] = 1.0
        Ke[:, :, j] = torch.func.jvp(fe, (u_flat,), (seed,))[1]
    return Ke


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def _profile(fn):
    """(kernel launches, device ms, host ms, top kernels) of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return launches, dev_us / 1e3, host_ms, [
        (e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tangent_profile needs a CUDA card")
    dev = "cuda"
    mesh = unstructured_box_tets(NX)
    mat = LinearIsotropic(1000.0, 0.3)
    nodes = torch.as_tensor(mesh.nodes, device=dev)
    elements = torch.as_tensor(mesh.elements, dtype=torch.int64, device=dev)
    dN = torch.as_tensor(np.asarray(mesh.element.dshape_at_gp), device=dev)
    w = torch.as_tensor(np.asarray(mesh.element.gauss_weights), device=dev)
    dof = torch.as_tensor(
        np.random.default_rng(0).normal(scale=1e-3, size=mesh.n_dof),
        device=dev)
    u_e = dof.reshape(-1, 3)[elements]
    x0_e = nodes[elements]
    forms = {
        "loop": lambda: loop_tangent(u_e, x0_e, dN, w, mat),
        "vmap": lambda: assembly.consistent_tangent_elems(u_e, x0_e, dN, w,
                                                          mat),
    }
    ref = forms["loop"]()
    one = forms["vmap"]()
    rel = float((one - ref).abs().max() / ref.abs().max())
    print(f"consistent tangent on unstructured_box_tets({NX}): "
          f"{mesh.n_elements} C3D4, float64, {torch.cuda.get_device_name(0)}"
          f"; vmap vs loop rel {rel:.3e}", flush=True)
    if rel > 1e-13:
        raise SystemExit(f"the two forms disagree: {rel:.3e}")
    for name, fn in forms.items():
        ev = _events_ms(fn, 5)
        host = _host_ms(fn, 5)
        launches, dev_ms, host1, top = _profile(fn)
        print(f"{name}: {ev:.3f} ms by events, {host:.3f} ms by the host "
              f"clock; one profiled call: {launches} kernel launches, "
              f"device busy {dev_ms:.3f} ms of {host1:.3f} ms host "
              f"({100.0 * dev_ms / host1:.1f}%); top kernels "
              f"{[(k, n, round(ms, 3)) for k, n, ms in top]}", flush=True)


if __name__ == "__main__":
    main()
