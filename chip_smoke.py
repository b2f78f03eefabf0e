#!/usr/bin/env python3
"""Drive femcy_tpu_torch's main path once on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. card: print ``nvidia-smi --query-gpu=name,power.limit``; exit non-zero
   when torch sees no CUDA device.
2. build: compile the CUDA kernels (csrc/*.cu, one nvcc per source, all
   started together, sm_90a) and load them.
3. kernels: in float32 and float64, on box_tets(9, 7, 5) and on the
   1,053,696-element box_tets(56, 56, 56):
   - P1 DIA SpMV kernel vs the plain ``dia_spmv`` on the analytic operator
     after Dirichlet elimination, x seeded with numpy; also at the sizes of
     the multigrid's coarse levels at NX=56 (28^3 and 14^3 grids: 73,167
     and 10,125 dofs);
   - P2 structured accumulate kernel vs the plain accumulate and vs the
     f64 numpy analytic operator, and bit-identical on a rerun;
   - P3 fused assembly kernel vs its plain version (isotropic prep + plain
     accumulate) and vs the f64 analytic operator, bit-identical on a
     rerun; then on the nodes jittered by up to 0.1 cell (uniform,
     seeded) vs its plain version, bit-identical on a rerun.
   Tolerances, relative to max|reference|: 1e-12 in float64, 1e-5 in
   float32.  At NX=56 the kernels and their plain versions are timed with
   CUDA events, in turns (plain, kernel, kernel, plain), the runs of each
   turn queued behind a device spin so the events read device time, not
   the host's launch rate (``cuda_ms``); P1 also against
   cuSPARSE's CSR matvec of the same operator's in-range entries and P2
   against one ``index_add_`` of the planes over int64 targets (each
   built before the timing, timed in turns with the kernel), P3 against
   the two-stage path it replaces (isotropic prep + P2).
4. two-stage path: ``structured_assemble_coords(accumulate="pallas")`` on
   the NX=56 box in float64 against the analytic operator, with P2's
   launch counter zeroed just before and read just after.  Then M5, the
   box's internal-force scatter, in float32 and float64 on box_tets(9, 7,
   5), (56, 56, 56), (5, 6, 19) (no multiple of the kernel's tile, also run
   at a 2 x 3 x 2 tile) and (2, 3, 1) (thinner than a tile): bit for bit
   against its plain version run on the CPU on the same seeded element
   forces, bit-identical on a rerun, at
   NX=56 timed in turns with its plain version and one ``index_add_`` of
   the forces over their int64 dof targets; and, in float64 at NX=56, the
   Ke -> planes transpose of ``structured_dia_scatter`` (the box Newton
   tangent's way into P2) timed beside P2, with the call's peak memory.
5. multigrid slice (the main path): FEMSystem(box_tets(56, 56, 56),
   LinearIsotropic(1000, 0.3), SolverConfig(preconditioner="multigrid"),
   device="cuda") in float64 (555,579 dofs; levels 56^3 -> 28^3 -> 14^3 ->
   7^3), the z=0 face clamped and an x-displacement prescribed on the z=1
   face; solve, strain/stress, Mises, energy and extrapolation, with every
   launch counter zeroed just before and read just after.  Checks:
   success, finite output of the expected shapes, P3 launched once per
   assembly, P1 launched as often as the V-cycle's structure predicts for
   the iteration count, the assembled operator equal to the analytic one
   (1e-12 relative), ||A x - b||_inf <= cg_eps * ||b||_inf with the plain
   SpMV, and the prescribed ux within the residual of its rows.  Then a
   warm solve, and on box_tets(8, 8, 8) the multigrid CG at cg_eps=1e-10
   against the host direct solve.
6. Jacobi slice: the same box and checks with the default SolverConfig
   (Jacobi PCG), counters zeroed and read around it; then, on
   box_tets(9, 7, 5), the CG path with cg_eps=1e-10 against the host
   direct solve.
7. general kernels: in float32 and float64, on unstructured_box_tets(9)
   and (56) (random node numbering, 0.2-cell jitter, seed 0):
   - M1 deterministic stiffness scatter kernel bit for bit equal to its
     plain version run on the CPU (``Ke.cpu()`` through ``scatter_plain``:
     the indexed add of the expanded targets, in contribution order) and,
     in float64, within 1e-12 of the f64 host operator
     (``assembly_host.assemble_csr_host``; in float32 that reading is
     printed, not gated: it measures the f32 element math); bit-identical
     on a rerun;
   - M2 ELL SpMV kernel vs the plain row gather on the operator after
     Dirichlet elimination, x seeded with numpy;
   - M4, the general internal-force scatter over M1's plan, bit for bit
     equal to its plain version run on the CPU on seeded element forces,
     bit-identical on a rerun (at NX=9 also on the plan with one more node
     that no element names, whose forces must be 0); at NX=56 timed in
     turns with its plain version and one ``index_add_`` over the int64
     dof targets, its bound printed beside its reads at 32-byte sector
     granularity (``kernels.internal_force.m4_read_sectors``).
   Tolerances as in phase 3; at NX=56 both timed in turns, M1 also
   against one ``index_add_`` over the int64 dof-level targets and M2
   against cuSPARSE's CSR matvec of the valid slots (both built before
   the timing).  Then M1 on both routes, in float32 and float64, bit for
   bit equal to the CPU plain version on seeded random element
   stiffnesses (and M4 on seeded element forces), on rect_tris(5, 4),
   box_hexes(4, 3, 3), box_hexes20(2, 2, 1), box_wedges(2, 2, 2) and a
   box_hexes(2, 2, 2) with one hex collapsed (an element that names a
   node twice), M1 each also on a DIA layout of 2^15 + 1 columns (a wide plan: int32 indices,
   sums kept in the output); on node rows either side of the longest one
   the kernel sums in shared memory (tet fans whose apex has 682 and 683
   node slots, triangle fans whose centre has 1536 and 1537); and the
   general-DIA route at box_hexes(48, 48, 48) on its own element
   stiffnesses, bit-equal to the CPU plain version and timed in turns
   with it and with one ``index_add_``, with its own bound.
8. ELL slice (the general main path): FEMSystem(unstructured_box_tets(56),
   LinearIsotropic(1000, 0.3), SolverConfig(), device="cuda") in float64
   (1,053,696 C3D4 elements, 555,579 dofs; "auto" picks the ELL layout
   and the Jacobi CG), the boundary model of phase 5, every launch counter
   zeroed just before and read just after.  Checks: M1 launched once per
   assembly, M2 once per CG iteration, P1-P3 never; the operator against
   the f64 host operator (1e-12), M1 bit-identical on a rerun, ||A x -
   b||_inf <= cg_eps * ||b||_inf with the plain SpMV, the prescribed ux
   within the residual of its rows, finite output of the expected shapes,
   and the system's SpMV kernel against the plain SpMV on the eliminated
   operator (1e-12, x seeded with numpy).
   Prints the init wall with its phases, the first and warm solve walls
   and the Timer sections.  This is not the twin of the JAX bench cell
   c3d4_1053k_unstructured_amg, which needs the AMG (not ported yet).
9. general-DIA slice: the same on box_hexes(48, 48, 48) (110,592 C3D8
   elements, 352,947 dofs, K = 99 offsets): M1 into the DIA slots, P1 in
   the CG; operator vs the host operator and vs M1's plain version, P1 vs
   the plain ``dia_spmv`` at these 99 mesh-derived offsets.
10. .inp entry point: an unstructured_box_tets(12) C3D4 model written as
   Abaqus text (node sets, *Boundary, a *Surface with a *Dsload
   pressure, *Elastic, *Static), read with read_inp, solved on the card
   with the CG at cg_eps=1e-10 (M1 and M2) against the host direct solve.
11. Newton, box (a main path): FEMSystem(box_tets(56, 56, 56),
   LinearIsotropic(1000, 0.3), geometric_nonlinear=True,
   SolverConfig(preconditioner="multigrid", linear_solver="cg")) in
   float64, z=0 clamped and the z=1 face turned about the box axis by the
   rotation hook under ``*Boundary, user`` (``TWIST``: 3.6 degrees in five
   increments), every launch counter zeroed just before the solve and
   read just after.  Checks: success, the increment/Newton history
   against ``EXPECTED_NEWTON``, M5 and P2 launched once per Newton
   evaluation, no kernel of another path, the f64 host residual
   (``assembly_host.internal_force_host`` at the final dof, BC rows
   zeroed) within 1e-8 of the last residual the device reported (its rms,
   and the vector of a fresh evaluation), finite output of the expected
   shapes; a warm solve repeats the history.  Prints the walls, the
   newton_eval / linear_solve split, the evaluations, the CG iterations
   of every solve and the peak memory.
12. Newton, ELL: the same on unstructured_box_tets(56) with the default
   config (ELL, Jacobi CG): M4 and M1 once per evaluation.
13. Newton, small: unstructured_box_tets(12) with ``tangent="consistent"``
   and with ``newton_jacobian_reuse="increment"`` (both below the
   direct-solve limit; M4 and M1), and box_tets(16, 16, 16) with the
   reference's secant tangent (``geometric_stiffness=False``: P3 from the
   current coordinates, and M5), the same checks without the warm solve.
14. print the launch counts and the CG iterations of every path, each
   beside the count that the deterministic kernels have always given, and
   fail on another count (a kernel changed its rounding), and the Newton
   histories beside the pinned ones; then the kernel table as one JSON
   line: per kernel, its f64 time and its plain version's, the library
   call's (null for P3, which no single PyTorch call computes from
   coordinates), its bound (the larger of its bytes over 3.35 TB/s and its
   operations over the f64 peak, from this run's shapes) and the launches
   of the path that runs it (P1 and P3 from the multigrid slice, P2 and
   M5 from the box Newton path, M1 and M2 from the ELL slice, M4 from the
   ELL Newton path); then the result line ``{"ok": true, "device":
   {...}}`` last.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

TOL = {"float32": 1e-5, "float64": 1e-12}
#: the bound of a kernel: the larger of its bytes over the HBM rate and its
#: operations over the peak rate of its type (H100 SXM data sheet, dense,
#: 700 W; float64 and float32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
DEVICE = "cuda"
SMALL, FULL = (9, 7, 5), (56, 56, 56)
#: boxes M5 is also held to its plain version on: one that is no multiple
#: of its tile (and is also run at a small tile), one thinner than a tile
M5_EDGE_BOXES = ((5, 6, 19), (2, 3, 1))
#: unstructured_box_tets sizes of the general kernel checks; the last one
#: is the ELL slice's mesh
UNSTRUCT = (9, 56)
HEX = (48, 48, 48)
INP_NX = 12
#: the CG iterations of each path, as the deterministic kernels have given
#: them since they were ported; another count means a kernel changed its
#: rounding
EXPECTED_CG_ITERS = {"multigrid box": 6, "jacobi box": 257, "ELL slice": 312,
                     "general-DIA slice": 163, ".inp model, CG": 260}
#: the Newton cases' time schedule: the top face turned by time * pi about
#: the box axis, 3.6 degrees in five increments.  Each increment's first
#: Newton iterate puts its whole turn into the top element layer, 1/56
#: thick, so the step stays small: larger ones inverted tets of the
#: jittered mesh or stalled the box's CG when tried
TWIST = {"ini_inc": 0.004, "max_time": 0.02, "min_inc": 1e-5,
         "max_inc": 0.004}
#: the increment/Newton history of each Newton case, (Newton loops,
#: converged) per increment record, as the card has given it since the
#: Newton path was ported; another history means the path's arithmetic
#: changed
EXPECTED_NEWTON = {"box Newton": [(2, True)] * 5, "ELL Newton": [(2, True)] * 5,
                   "consistent tangent": [(1, True)] * 5,
                   "Jacobian reuse": [(1, True)] * 5,
                   "box secant": [(1, True)] * 5}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


_SLEEP_CYCLES_PER_MS = []


def _queue_ahead(host_ms: float) -> None:
    """Hold the current stream in a device-side spin for about
    ``host_ms`` (at most 300 ms), so that work the host queues meanwhile
    runs back to back after it: a kernel of tens of microseconds is
    shorter than its wrapper's host time, and without this the events
    would time the host's launch rate."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:  # calibrate the spin once
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    torch.cuda._sleep(int(min(host_ms, 300.0) * _SLEEP_CYCLES_PER_MS[0]))


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, by CUDA
    events, after one warm-up run; the runs are queued behind a device
    spin longer than the host takes to queue them (``_queue_ahead``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _queue_ahead(3.0 * reps * host_ms + 1.0)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps_plain: int, reps_kernel: int,
             library=None):
    """(kernel ms, plain ms, library ms or None), timed plain, library,
    kernel, kernel, library, plain; the library call gets the kernel's
    repetitions."""
    p1 = cuda_ms(plain, reps_plain)
    l1 = cuda_ms(library, reps_kernel) if library else None
    k1 = cuda_ms(kernel, reps_kernel)
    k2 = cuda_ms(kernel, reps_kernel)
    l2 = cuda_ms(library, reps_kernel) if library else None
    p2 = cuda_ms(plain, reps_plain)
    lib = (l1 + l2) / 2.0 if library else None
    return (k1 + k2) / 2.0, (p1 + p2) / 2.0, lib


def bound(n_bytes: float, flops: float, name: str):
    """(ms, "bytes" or "operations"): the least time the card could take
    for n_bytes moved and flops done in dtype ``name``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(abs_err, ms, plain_ms, library_ms, bound_ms_by):
    """One kernel's numbers for the kernel table."""
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1]}


def csr_matvec(keep, cols, values):
    """The library yardstick of an SpMV: a CSR tensor (int32 indices) of
    the entries of ``values`` where ``keep`` holds, and its matvec."""
    import warnings

    import torch

    n = keep.shape[0]
    crow = torch.zeros(n + 1, dtype=torch.int32, device=keep.device)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        A = torch.sparse_csr_tensor(crow, cols[keep].int(), values[keep],
                                    size=(n, n), check_invariants=False)
    return lambda x: A @ x


def accumulate_targets(plan, device):
    """P2's function as flat int64 targets, one per plane entry: entry
    (o, 12 p + q, cell) of the (6, 144, cells) planes goes to DIA value
    (node * 3 + i) * K + k of the (n_dof, K) output, where (i, k) is the
    group of ``plan.groups`` that holds (o, p, q) and node is the cell's
    node shifted by that combo's corner."""
    import torch

    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    sx, sy = (ny + 1) * (nz + 1), nz + 1
    base = np.full((6, 144), -1, dtype=np.int64)
    for (i, k), combos in plan.groups.items():
        for o, p, q, (dx, dy, dz) in combos:
            base[o, 12 * p + q] = ((dx * sx + dy * sy + dz) * 3 + i) * K + k
    check(bool((base >= 0).all()), "a plane entry has no DIA value")
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    node = torch.as_tensor((cx * sx + cy * sy + cz).reshape(-1) * (3 * K),
                           device=device)
    return (torch.as_tensor(base, device=device)[:, :, None]
            + node[None, None]).reshape(-1)


def launch_counters():
    """Every kernel wrapper by its row name in the kernel table."""
    from femcy_tpu_torch.kernels import (
        dia_spmv,
        ell_scatter,
        ell_spmv,
        internal_force,
        structured_accumulate,
        structured_force,
        structured_fused,
    )

    return {"dia_spmv": dia_spmv.spmv,
            "structured_accumulate": structured_accumulate.accumulate,
            "structured_fused": structured_fused.fused_assemble,
            "ell_scatter": ell_scatter.scatter,
            "ell_spmv": ell_spmv.spmv,
            "internal_force": internal_force.scatter_force,
            "structured_force": structured_force.force_scatter}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def z_faces(mesh):
    z = mesh.nodes[:, 2]
    return np.nonzero(z < 1e-9)[0], np.nonzero(z > z.max() - 1e-9)[0]


def kernel_checks(torch, card, results):
    """Phase 3.  Returns the f64 analytic operator of the FULL box."""
    from femcy_tpu_torch.kernels import dia_spmv as k_spmv
    from femcy_tpu_torch.kernels import structured_accumulate as k_acc
    from femcy_tpu_torch.kernels import structured_fused as k_fused
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern, dia_spmv
    from femcy_tpu_torch.structured import (
        accumulate_planes,
        analytic_structured_dia_values,
        build_structured_plan,
        dia_dirichlet_linear_numpy,
        fused_assemble_plain,
        stiffness_planes,
    )

    mat = LinearIsotropic(1000.0, 0.3)
    full_ref = None
    for dims in (SMALL, FULL):
        mesh = box_tets(*dims)
        dia = build_structured_dia_pattern(mesh)
        plan = build_structured_plan(mesh, dia)
        table = plan.accumulate_table
        fplan = k_fused.build_fused_plan(mesh, plan, mat.C)
        check(fplan is not None, "P3 plan unsupported for LinearIsotropic")
        ref = analytic_structured_dia_values(mesh, mat.C, dia)
        if dims == FULL:
            full_ref = ref
        fixed = np.zeros(mesh.n_dof, bool)
        bottom, _ = z_faces(mesh)
        for d in range(3):
            fixed[bottom * 3 + d] = True
        ref_bc = dia_dirichlet_linear_numpy(ref, dia.offsets, dia.diag_idx, fixed)
        x_np = np.random.default_rng(0).standard_normal(mesh.n_dof)
        # every node moved by up to 0.1 cell per axis (uniform, seeded)
        cell = (mesh.nodes.max(0) - mesh.nodes.min(0)) / np.array(dims)
        jittered = mesh.nodes + cell * np.random.default_rng(3).uniform(
            -0.1, 0.1, mesh.nodes.shape)
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            tol = TOL[name]

            def dev(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)

            # P1: DIA SpMV
            vals = dev(ref_bc)
            x = dev(x_np)
            plan1 = k_spmv.spmv_plan(mesh.n_dof, dia.offsets, DEVICE)
            vt = k_spmv.prep_values(plan1, vals)
            y_k = k_spmv.spmv(plan1, vt, x)
            y_p = dia_spmv(vals, dia.offsets, x)
            torch.cuda.synchronize()
            abs1 = float((y_k - y_p).abs().max())
            rel1 = abs1 / float(y_p.abs().max())
            check(rel1 <= tol, f"P1 {dims} {name}: {rel1:.3e} > {tol:.0e}")

            # P2: structured accumulate
            coords = dev(mesh.nodes)
            planes = stiffness_planes(
                coords, mesh, dev(mesh.element.dshape_at_gp),
                dev(mesh.element.gauss_weights), dev(mat.C),
            )
            v_k = k_acc.accumulate(planes, table)
            v_p = accumulate_planes(planes, plan)
            torch.cuda.synchronize()
            abs2 = float((v_k - v_p).abs().max())
            rel2 = abs2 / float(v_p.abs().max())
            rel2a = float(np.abs(v_k.double().cpu().numpy() - ref).max()
                          / np.abs(ref).max())
            check(rel2 <= tol, f"P2 vs plain {dims} {name}: {rel2:.3e}")
            check(rel2a <= tol, f"P2 vs analytic {dims} {name}: {rel2a:.3e}")
            check(torch.equal(v_k, k_acc.accumulate(planes, table)),
                  f"P2 {dims} {name}: rerun not bit-identical")
            del planes, v_k, v_p

            # P3: fused assembly from the coordinates
            v_k = k_fused.fused_assemble(coords, fplan)
            v_p = fused_assemble_plain(coords, mesh, fplan.lam, fplan.mu, plan)
            torch.cuda.synchronize()
            abs3 = float((v_k - v_p).abs().max())
            rel3 = abs3 / float(v_p.abs().max())
            rel3a = float(np.abs(v_k.double().cpu().numpy() - ref).max()
                          / np.abs(ref).max())
            check(rel3 <= tol, f"P3 vs plain {dims} {name}: {rel3:.3e}")
            check(rel3a <= tol, f"P3 vs analytic {dims} {name}: {rel3a:.3e}")
            check(torch.equal(v_k, k_fused.fused_assemble(coords, fplan)),
                  f"P3 {dims} {name}: rerun not bit-identical")
            del v_k, v_p
            # P3 on jittered coordinates: every tet's gradients differ, so
            # a wrong cell or halo node shows in every row, not only at
            # the box's faces
            jit = dev(jittered)
            v_k = k_fused.fused_assemble(jit, fplan)
            v_p = fused_assemble_plain(jit, mesh, fplan.lam, fplan.mu, plan)
            torch.cuda.synchronize()
            rel3j = float((v_k - v_p).abs().max() / v_p.abs().max())
            check(rel3j <= tol, f"P3 vs plain, jittered {dims} {name}: "
                  f"{rel3j:.3e}")
            check(torch.equal(v_k, k_fused.fused_assemble(jit, fplan)),
                  f"P3 jittered {dims} {name}: rerun not bit-identical")
            del v_k, v_p, jit
            print(f"kernels {dims} {name}: P1 rel err {rel1:.3e}, P2 rel err "
                  f"{rel2:.3e} vs plain, {rel2a:.3e} vs analytic f64, P3 rel "
                  f"err {rel3:.3e} vs plain, {rel3a:.3e} vs analytic f64, "
                  f"{rel3j:.3e} vs plain on jittered coordinates "
                  f"(tol {tol:.0e})", flush=True)

            if dims == FULL:
                planes = stiffness_planes(
                    coords, mesh, dev(mesh.element.dshape_at_gp),
                    dev(mesh.element.gauss_weights), dev(mat.C),
                )
                # P1's yardstick: cuSPARSE's CSR matvec of the in-range
                # entries, built here, outside the timed window
                n, K = vals.shape
                cols = (torch.arange(n, device=DEVICE)[:, None]
                        + torch.as_tensor(dia.offsets, device=DEVICE)[None])
                keep = (cols >= 0) & (cols < n)
                nnz1 = int(keep.sum())
                lib1 = csr_matvec(keep, cols, vals)
                del cols, keep
                check(float((lib1(x) - y_p).abs().max()) <= tol * float(
                    y_p.abs().max()), "P1's CSR yardstick disagrees")
                ms1, pms1, lms1 = in_turns(
                    lambda: dia_spmv(vals, dia.offsets, x),
                    lambda: k_spmv.spmv(plan1, vt, x), 20, 50,
                    lambda: lib1(x))
                del lib1
                isz = vals.element_size()
                b1 = bound((K * n + 2 * n) * isz + 4 * K, 2 * nnz1, name)
                # P2's yardstick: one index_add_ of the planes into their
                # DIA values over int64 targets, built here, outside the
                # timed window
                targets = accumulate_targets(plan, DEVICE)
                lib_out = torch.zeros(n * K, dtype=dtype, device=DEVICE)
                planes_flat = planes.view(-1)
                lib_out.index_add_(0, targets, planes_flat)
                v_k = k_acc.accumulate(planes, table)
                check(float((lib_out.view(n, K) - v_k).abs().max()) <= tol
                      * float(v_k.abs().max()), "P2's index_add_ yardstick "
                      "disagrees")
                del v_k
                ms2, pms2, lms2 = in_turns(
                    lambda: accumulate_planes(planes, plan),
                    lambda: k_acc.accumulate(planes, table), 3, 10,
                    lambda: lib_out.index_add_(0, targets, planes_flat))
                del targets, lib_out
                nc = dims[0] * dims[1] * dims[2]
                b2 = bound((planes.numel() + n * K) * isz
                           + 4 * (table.col_start.size + table.entries.size),
                           864 * nc, name)
                del planes
                lame = (fplan.lam, fplan.mu)
                dN = dev(mesh.element.dshape_at_gp)
                w = dev(mesh.element.gauss_weights)

                def two_stage():
                    return k_acc.accumulate(
                        stiffness_planes(coords, mesh, dN, w, None, lame=lame),
                        table)

                ms3, pms3, _ = in_turns(
                    lambda: fused_assemble_plain(coords, mesh, *lame, plan),
                    lambda: k_fused.fused_assemble(coords, fplan), 3, 10)
                ms3b, two_ms, _ = in_turns(
                    two_stage, lambda: k_fused.fused_assemble(coords, fplan),
                    3, 10)
                # per tet: the gradients (~180 flops) and 144 stiffness
                # entries of ~7 flops, 48 of them with a 7-flop dot term
                b3 = bound((mesh.n_nodes * 3 + n * K) * isz,
                           6 * nc * (180 + 144 * 7 + 48 * 7), name)
                print(f"timing {dims} {name} on {card}: P1 dia_spmv kernel "
                      f"{ms1:.4f} ms, plain {pms1:.4f} ms, CSR matvec "
                      f"(cuSPARSE, {nnz1} entries) {lms1:.4f} ms, bound "
                      f"{b1[0]:.4f} ms ({b1[1]}); P2 accumulate "
                      f"kernel {ms2:.4f} ms, plain {pms2:.4f} ms, index_add_ "
                      f"{lms2:.4f} ms, bound {b2[0]:.4f} ms ({b2[1]}); P3 fused "
                      f"kernel {ms3:.4f} ms, plain {pms3:.4f} ms, bound "
                      f"{b3[0]:.4f} ms ({b3[1]}); P3 "
                      f"{ms3b:.4f} ms against the two-stage path (isotropic "
                      f"prep + P2) {two_ms:.4f} ms", flush=True)
                results[name] = {
                    "dia_spmv": row(abs1, ms1, pms1, lms1, b1),
                    "structured_accumulate": row(abs2, ms2, pms2, lms2, b2),
                    "structured_fused": row(abs3, ms3, pms3, None, b3),
                }
            del vals, vt, coords
        torch.cuda.empty_cache()
    return full_ref


def coarse_spmv_checks(torch):
    """Phase 3, P1 at the multigrid's coarse-level sizes at NX=56: the
    eliminated analytic operators of the 28^3 and 14^3 grids."""
    from femcy_tpu_torch.kernels import dia_spmv as k_spmv
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern, dia_spmv
    from femcy_tpu_torch.structured import (
        analytic_structured_dia_values,
        dia_dirichlet_linear_numpy,
    )

    mat = LinearIsotropic(1000.0, 0.3)
    for n in (28, 14):
        mesh = box_tets(n, n, n)
        dia = build_structured_dia_pattern(mesh)
        fixed = np.zeros(mesh.n_dof, bool)
        bottom, _ = z_faces(mesh)
        for d in range(3):
            fixed[bottom * 3 + d] = True
        vals_np = dia_dirichlet_linear_numpy(
            analytic_structured_dia_values(mesh, mat.C, dia), dia.offsets,
            dia.diag_idx, fixed)
        x_np = np.random.default_rng(1).standard_normal(mesh.n_dof)
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            vals = torch.as_tensor(vals_np, dtype=dtype, device=DEVICE)
            x = torch.as_tensor(x_np, dtype=dtype, device=DEVICE)
            plan = k_spmv.spmv_plan(mesh.n_dof, dia.offsets, DEVICE)
            y_k = k_spmv.spmv(plan, k_spmv.prep_values(plan, vals), x)
            y_p = dia_spmv(vals, dia.offsets, x)
            torch.cuda.synchronize()
            rel = float((y_k - y_p).abs().max() / y_p.abs().max())
            check(rel <= TOL[name],
                  f"P1 at {mesh.n_dof} dofs {name}: {rel:.3e}")
            print(f"kernels coarse level {n}^3 ({mesh.n_dof} dofs) {name}: P1 "
                  f"rel err {rel:.3e} (tol {TOL[name]:.0e})", flush=True)


def box_force_checks(torch, card, results):
    """Phase 4b: M5 (the box's internal-force scatter) in float32 and
    float64 on box_tets(9, 7, 5) and (56, 56, 56), bit for bit against its
    plain version run on the CPU on the same seeded element forces and
    against its own rerun; at NX=56 timed in turns with its plain version
    and one ``index_add_`` over the int64 dof targets.  The same checks,
    untimed, on ``M5_EDGE_BOXES`` (the first also at a 2 x 3 x 2 tile).
    Then, in float64
    at NX=56, the Ke -> planes transpose of ``structured_dia_scatter`` timed
    beside P2 on the box's element stiffnesses, with the call's peak
    memory."""
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.kernels import structured_accumulate as k_acc
    from femcy_tpu_torch.kernels import structured_force as k_sf
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
    from femcy_tpu_torch.structured import (
        build_structured_plan,
        structured_dia_scatter,
        structured_force_scatter,
    )

    for dims in (SMALL,) + M5_EDGE_BOXES + (FULL,):  # FULL last: used below
        mesh = box_tets(*dims)
        plan = build_structured_plan(mesh, build_structured_dia_pattern(mesh))
        f_np = np.random.default_rng(10).standard_normal((mesh.n_elements, 4, 3))
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            f_e = torch.as_tensor(f_np, dtype=dtype, device=DEVICE)
            ref = structured_force_scatter(f_e.cpu(), plan, mesh)
            runs = {plan.force_tile[name]:
                    lambda: k_sf.force_scatter(f_e, plan, mesh)}
            if dims == M5_EDGE_BOXES[0]:
                runs[(2, 3, 2)] = lambda: k_sf.launch_at(f_e, plan, (2, 3, 2))
            tiles = list(runs)
            for tile, run in runs.items():
                f_k = run()
                got = f_k.cpu()
                abs5 = float((got - ref).abs().max())
                check(torch.equal(got, ref), f"M5 {dims} {name} tile {tile}: "
                      "not bit-equal to the CPU plain version (max abs "
                      f"difference {abs5:.3e})")
                check(torch.equal(f_k, run()),
                      f"M5 {dims} {name} tile {tile}: rerun not bit-identical")
            print(f"box force kernel {dims} {name}: M5 bit-equal to the CPU "
                  f"plain version at tiles {tiles}, bit-identical rerun",
                  flush=True)
            if dims != FULL:
                continue
            elements = torch.as_tensor(mesh.elements.astype(np.int64),
                                       device=DEVICE)
            targets = (elements[:, :, None] * 3
                       + torch.arange(3, device=DEVICE)).reshape(-1)
            lib_out = torch.zeros(mesh.n_dof, dtype=dtype, device=DEVICE)
            f_flat = f_e.view(-1)
            lib_out.index_add_(0, targets, f_flat)
            check(float((lib_out - f_k).abs().max()) <= TOL[name]
                  * float(f_k.abs().max()), "M5's index_add_ yardstick "
                  "disagrees")
            ms, pms, lms = in_turns(
                lambda: structured_force_scatter(f_e, plan, mesh),
                lambda: k_sf.force_scatter(f_e, plan, mesh), 3, 20,
                lambda: lib_out.index_add_(0, targets, f_flat))
            b = bound((f_e.numel() + mesh.n_dof) * f_e.element_size(),
                      f_e.numel(), name)
            print(f"timing box_tets{dims} {name} on {card}: M5 "
                  f"structured_force kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"index_add_ {lms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})",
                  flush=True)
            results[name]["structured_force"] = row(abs5, ms, pms, lms, b)
            del targets, lib_out, elements
        del f_e, f_k
        torch.cuda.empty_cache()

    # the box Newton tangent's Ke -> planes transpose beside P2
    mat = LinearIsotropic(1000.0, 0.3)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=DEVICE)

    nodes = dev(mesh.nodes)
    elements = torch.as_tensor(mesh.elements.astype(np.int64), device=DEVICE)
    dsdx, vol = assembly.gradients_and_volume(
        nodes, elements, dev(mesh.element.dshape_at_gp),
        dev(mesh.element.gauss_weights))
    Ke = assembly.element_stiffness(dsdx, vol, dev(mat.C))
    del dsdx, vol, nodes, elements
    nc = plan.nx * plan.ny * plan.nz
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    structured_dia_scatter(Ke, plan)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    planes = Ke.reshape(nc, 6, 144).permute(1, 2, 0).contiguous()
    table = plan.accumulate_table
    p2_ms, t_ms, _ = in_turns(
        lambda: Ke.reshape(nc, 6, 144).permute(1, 2, 0).contiguous(),
        lambda: k_acc.accumulate(planes, table), 5, 5)
    print(f"structured_dia_scatter at {FULL} float64 on {card}: Ke "
          f"{Ke.numel() * 8 / 1e9:.3f} GB; Ke -> planes transpose {t_ms:.4f} "
          f"ms, P2 {p2_ms:.4f} ms; the call's peak memory above its input "
          f"{peak / 1e9:.3f} GB", flush=True)
    del Ke, planes
    torch.cuda.empty_cache()


def two_stage_run(torch, full_ref):
    """Phase 4.  Returns P2's launch count on the two-stage path."""
    from femcy_tpu_torch.kernels import structured_accumulate as k_acc
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
    from femcy_tpu_torch.structured import (
        build_structured_plan,
        structured_assemble_coords,
    )

    mat = LinearIsotropic(1000.0, 0.3)
    mesh = box_tets(*FULL)
    plan = build_structured_plan(mesh, build_structured_dia_pattern(mesh))

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=DEVICE)

    args = (dev(mesh.nodes), mesh, dev(mesh.element.dshape_at_gp),
            dev(mesh.element.gauss_weights), dev(mat.C), plan)
    k_acc.accumulate.launches = 0
    values = structured_assemble_coords(*args, accumulate="pallas",
                                        C_host=mat.C)
    torch.cuda.synchronize()
    launches = k_acc.accumulate.launches
    check(launches == 1, f"two-stage path launched P2 {launches} times")
    err = float(np.abs(values.cpu().numpy() - full_ref).max()
                / np.abs(full_ref).max())
    check(err <= TOL["float64"], f"two-stage operator vs analytic: {err:.3e}")
    print(f"two-stage path (isotropic prep + P2) on {FULL}: operator rel err "
          f"{err:.3e} vs analytic f64, P2 launches {launches}", flush=True)
    del values
    torch.cuda.empty_cache()
    return launches


def boundary_model(mesh, ux: float, element_type: str = "C3D4"):
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel

    bottom, top = z_faces(mesh)
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, ux))
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type=element_type,
        node_sets={"bottom": bottom, "top": top}, ele_sets={}, face_sets={},
        dirichlet_bcs=bcs, neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=False,
        time_incs={"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                   "max_inc": 1.0},
    )


def slice_run(torch, card, full_ref, preconditioner: str):
    """Phases 5 and 6: the path through FEMSystem with ``preconditioner``.
    Returns its launch counts and CG iterations."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.dia import dia_spmv

    mg = preconditioner == "multigrid"
    cg = "MG-CG" if mg else "CG"
    mat = LinearIsotropic(1000.0, 0.3)
    mesh = box_tets(*FULL)
    inp = boundary_model(mesh, 0.01)
    t = time.perf_counter()
    system = FEMSystem(mesh, mat, geometric_nonlinear=False,
                       config=SolverConfig(preconditioner=preconditioner),
                       device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    check(system.dtype == torch.float64, "default dtype is not float64")
    print(f"{preconditioner} slice: {mesh.n_elements} C3D4 elements, "
          f"{mesh.n_nodes} nodes, {mesh.n_dof} dofs; FEMSystem setup "
          f"{setup_s:.3f} s", flush=True)

    zero_launches()
    t = time.perf_counter()
    report = system.solve(inp)
    strain, stress, mises = system.compute_strain_stress()
    energy = system.elastic_energy()
    nodal = system.extrapolate(mises)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    launches = read_launches()
    iters = system._last_cg_iters
    timing = system.timer.summary()
    print(f"{preconditioner} slice on {card}: first solve of the process "
          f"(kernel library loaded{', hierarchy built inside' if mg else ''}):"
          f" assembly+bc {timing['assemble+bc']['first']:.4f} s, {cg} {iters} "
          f"iterations in {timing['linear_solve']['first']:.4f} s, "
          f"solve+post-processing {total_s:.4f} s; launches {launches}",
          flush=True)

    E = mesh.n_elements
    check(report.success, "solve reported failure")
    check(iters > 0, f"the {cg} path did not run")
    check(launches["structured_fused"] == report.n_increments,
          f"P3 launched {launches['structured_fused']} times for "
          f"{report.n_increments} assemblies")
    check(launches["structured_accumulate"] == 0,
          "P2 launched on the isotropic default path")
    check(launches["ell_scatter"] == launches["ell_spmv"] == 0,
          f"general-path kernels launched on the box: {launches}")
    if mg:
        # every V-cycle smooths levels 0..L-2 with 2 * smooth_steps
        # operator applications plus one residual each; the PCG runs one
        # V-cycle before its loop and one plus one fine SpMV per iteration
        L = len(system._mg.levels)
        per_cycle = (2 * system._mg.smooth_steps + 1) * (L - 1)
        expect = (iters + 1) * per_cycle + iters
        check(launches["dia_spmv"] == expect,
              f"P1 launched {launches['dia_spmv']} times, the {L}-level "
              f"cycle predicts {expect} for {iters} iterations")
    else:
        check(launches["dia_spmv"] >= iters > 0,
              f"P1 launched {launches['dia_spmv']} times for {iters} CG "
              "iterations")
    check(tuple(system.dof.shape) == (mesh.n_dof,), "dof shape")
    check(tuple(stress.shape) == (E, 1, 3, 3), "stress shape")
    check(tuple(strain.shape) == (E, 1, 3, 3), "strain shape")
    check(tuple(mises.shape) == (E, 1), "mises shape")
    check(tuple(nodal.shape) == (E, 4), "extrapolation shape")
    for name, t_ in (("dof", system.dof), ("stress", stress), ("mises", mises),
                     ("nodal", nodal)):
        check(bool(torch.isfinite(t_).all()), f"{name} not finite")
    check(np.isfinite(energy) and energy > 0.0, f"energy {energy}")

    # the assembled operator against the analytic f64 one
    values = system._assemble_values()
    err = float(np.abs(values.cpu().numpy() - full_ref).max()
                / np.abs(full_ref).max())
    check(err <= 1e-12, f"assembled operator vs analytic: {err:.3e}")
    res, bmax, ux_err = solution_checks(
        torch, system, mesh, lambda v, x: dia_spmv(v, system.dia.offsets, x))
    print(f"{preconditioner} slice checks: operator rel err {err:.3e}, "
          f"||Ax-b||_inf/||b||_inf {res / bmax:.3e} (cg_eps "
          f"{system.config.cg_eps}), prescribed ux off by {ux_err:.3e} "
          f"(||Ax-b||_inf {res:.3e}), max mises {float(mises.max()):.6g}, "
          f"energy {energy:.6g}", flush=True)
    del values

    t = time.perf_counter()
    system.solve(inp)
    torch.cuda.synchronize()
    warm = system.timer.summary()
    print(f"{preconditioner} slice warm solve on {card}: assembly+bc "
          f"{warm['assemble+bc']['steady_min']:.4f} s, {cg} "
          f"{system._last_cg_iters} iterations in "
          f"{warm['linear_solve']['steady_min']:.4f} s, solve "
          f"{time.perf_counter() - t:.4f} s", flush=True)
    del system
    torch.cuda.empty_cache()
    return launches, iters


def small_box_check(torch, dims, preconditioner: str):
    """The CG path on the card at cg_eps=1e-10 against the host direct
    solve, on a small box."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import box_tets

    small = box_tets(*dims)
    inp_s = boundary_model(small, 0.01)
    mat = LinearIsotropic(1000.0, 0.3)
    dofs = {}
    for solver, eps in (("direct", 1e-3), ("cg", 1e-10)):
        s = FEMSystem(small, mat, config=SolverConfig(
            linear_solver=solver, cg_eps=eps, preconditioner=preconditioner),
            device=DEVICE)
        check(s.solve(inp_s).success, f"small {solver} solve")
        dofs[solver] = s.dof.cpu().numpy()
    rel = float(np.abs(dofs["cg"] - dofs["direct"]).max()
                / np.abs(dofs["direct"]).max())
    check(rel <= 1e-7, f"small box {preconditioner} CG vs direct: {rel:.3e}")
    print(f"small box {dims}: {preconditioner} CG (cg_eps 1e-10) vs host "
          f"direct solve rel err {rel:.3e}", flush=True)


def clamp_bottom(mesh):
    fixed = np.zeros(mesh.n_dof, bool)
    bottom, _ = z_faces(mesh)
    for d in range(3):
        fixed[bottom * 3 + d] = True
    return fixed


def general_kernel_checks(torch, card, results):
    """Phase 7.  Returns the f64 host CSR operator of the ELL slice's
    mesh."""
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.assembly_host import assemble_csr_host
    from femcy_tpu_torch.bc import apply_dirichlet_linear
    from femcy_tpu_torch.kernels import ell_scatter as k_scat
    from femcy_tpu_torch.kernels import ell_spmv as k_ell
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import unstructured_box_tets
    from femcy_tpu_torch.solvers.cg import ell_spmv
    from femcy_tpu_torch.topology import build_pattern

    mat = LinearIsotropic(1000.0, 0.3)
    out = None
    for nx in UNSTRUCT:
        mesh = unstructured_box_tets(nx)
        t = time.perf_counter()
        pattern = build_pattern(mesh)
        t_pattern = time.perf_counter() - t
        t = time.perf_counter()
        K = assemble_csr_host(mesh, pattern, mat.C)
        t_host = time.perf_counter() - t
        t = time.perf_counter()
        plan = k_scat.build_scatter_plan(pattern, DEVICE)
        t_plan = time.perf_counter() - t
        print(f"general kernels: unstructured_box_tets({nx}): {mesh.n_elements} "
              f"elements, {mesh.n_dof} dofs, ELL width {pattern.width}; host "
              f"pattern {t_pattern:.3f} s, f64 host operator {t_host:.3f} s, "
              f"scatter map {t_plan:.3f} s", flush=True)
        fixed = torch.as_tensor(clamp_bottom(mesh), device=DEVICE)
        colidx = torch.as_tensor(pattern.colidx.astype(np.int64), device=DEVICE)
        diag_slot = torch.as_tensor(pattern.diag_slot, device=DEVICE)
        splan = k_ell.spmv_plan(pattern, DEVICE)
        x_np = np.random.default_rng(2).standard_normal(mesh.n_dof)
        f_np = np.random.default_rng(8).standard_normal(
            (mesh.n_elements, mesh.element.n_nodes, mesh.dm))
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            tol = TOL[name]

            def dev(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)

            nodes = dev(mesh.nodes)
            elements = torch.as_tensor(mesh.elements.astype(np.int64),
                                       device=DEVICE)
            dsdx, vol = assembly.gradients_and_volume(
                nodes, elements, dev(mesh.element.dshape_at_gp),
                dev(mesh.element.gauss_weights))
            Ke = assembly.element_stiffness(dsdx, vol, dev(mat.C))
            del dsdx, vol

            # M1: the deterministic scatter, bit for bit its plain
            # version on the CPU
            v_k, abs1 = m1_against_cpu_plain(torch, Ke, plan,
                                             f"unstructured ({nx}) {name}")
            v_np = v_k.double().cpu().numpy()
            check(not v_np[~pattern.valid].any(), "M1 left padding nonzero")
            rel1h = float(np.abs(v_np.reshape(-1)[pattern.csr_slots] - K.data).max()
                          / np.abs(K.data).max())
            # in float32 this reading is the f32 element math on jittered
            # tets (Ke is computed in the working dtype), not the scatter's
            if dtype == torch.float64:
                check(rel1h <= tol, f"M1 vs host operator {nx}: {rel1h:.3e}")
            del v_np

            # M2: the ELL SpMV on the eliminated operator
            vals, _ = apply_dirichlet_linear(
                v_k, colidx, diag_slot, torch.zeros(mesh.n_dof, dtype=dtype,
                                                    device=DEVICE),
                fixed, torch.zeros(mesh.n_dof, dtype=dtype, device=DEVICE))
            x = dev(x_np)
            vt = k_ell.prep_values(splan, vals)
            y_k = k_ell.spmv(splan, vt, x)
            y_p = ell_spmv(vals, colidx, x)
            torch.cuda.synchronize()
            abs2 = float((y_k - y_p).abs().max())
            rel2 = abs2 / float(y_p.abs().max())
            check(rel2 <= tol, f"M2 vs plain {nx} {name}: {rel2:.3e}")
            # M4: the internal-force scatter over the same plan, bit for
            # bit its plain version on the CPU
            f_e = dev(f_np)
            f_k, abs4 = m4_against_cpu_plain(torch, f_e, plan,
                                             f"unstructured ({nx}) {name}")
            if nx == UNSTRUCT[0]:
                m4_orphan_check(torch, f_e, plan, f"unstructured ({nx}) "
                                f"{name}")
            print(f"general kernels ({nx}) {name}: M1 bit-equal to the CPU "
                  f"plain version, {rel1h:.3e} vs host f64 (gated in float64 "
                  f"only), bit-identical rerun; M2 "
                  f"rel err {rel2:.3e} vs plain (tol {tol:.0e}); M4 bit-equal "
                  "to the CPU plain version, bit-identical rerun", flush=True)

            if nx == UNSTRUCT[-1]:
                # M1's yardstick: one index_add_ over the int64 dof-level
                # targets, built here, outside the timed window
                targets = k_scat.contribution_targets(plan)
                lib_out = torch.zeros(plan.out_shape, dtype=dtype,
                                      device=DEVICE).view(-1)
                ke_flat = Ke.view(-1)
                ms1, pms1, lms1 = in_turns(
                    lambda: k_scat.scatter_plain(Ke, plan),
                    lambda: k_scat.scatter(Ke, plan), 3, 10,
                    lambda: lib_out.index_add_(0, targets, ke_flat))
                del targets, lib_out
                isz = Ke.element_size()
                b1 = bound((Ke.numel() + v_k.numel()) * isz
                           + plan_bytes(plan), Ke.numel(), name)
                # M2's yardstick: cuSPARSE's CSR matvec of the valid slots
                n, W = vals.shape
                keep = (torch.arange(W, device=DEVICE)[None]
                        < splan.row_counts[:, None])
                nnz2 = int(keep.sum())
                lib2 = csr_matvec(keep, colidx, vals)
                del keep
                check(float((lib2(x) - y_p).abs().max()) <= tol * float(
                    y_p.abs().max()), "M2's CSR yardstick disagrees")
                ms2, pms2, lms2 = in_turns(
                    lambda: ell_spmv(vals, colidx, x),
                    lambda: k_ell.spmv(splan, vt, x), 20, 50,
                    lambda: lib2(x))
                del lib2
                b2 = bound(nnz2 * (isz + 4) + n * (4 + 2 * isz), 2 * nnz2,
                           name)
                print(f"timing unstructured_box_tets({nx}) {name} on {card}: "
                      f"M1 ell_scatter kernel {ms1:.4f} ms, plain {pms1:.4f} "
                      f"ms, index_add_ {lms1:.4f} ms, bound {b1[0]:.4f} ms "
                      f"({b1[1]}); M2 ell_spmv kernel {ms2:.4f} ms, plain "
                      f"{pms2:.4f} ms, CSR matvec (cuSPARSE, {nnz2} entries) "
                      f"{lms2:.4f} ms, bound {b2[0]:.4f} ms ({b2[1]})",
                      flush=True)
                results[name]["ell_scatter"] = row(abs1, ms1, pms1, lms1, b1)
                results[name]["ell_spmv"] = row(abs2, ms2, pms2, lms2, b2)
                results[name]["internal_force"] = m4_timing(
                    torch, card, f_e, f_k, abs4, plan, f"unstructured_box_tets"
                    f"({nx}) {name}")
                out = K
            del Ke, v_k, vals, vt, nodes, f_e, f_k
        del plan, splan, colidx, diag_slot
        torch.cuda.empty_cache()
    return out


def plan_on_cpu(torch, plan):
    """A copy of M1's (and M4's) plan with every tensor on the CPU."""
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).cpu() for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def m4_against_cpu_plain(torch, f_e, plan, what: str):
    """M4 on the card, checked bit for bit against its plain version run
    on the CPU on the same element forces and against its own rerun.
    Returns (forces, max abs difference to the CPU plain version)."""
    from femcy_tpu_torch.kernels import internal_force as k_force

    f_k = k_force.scatter_force(f_e, plan)
    ref = k_force.scatter_force_plain(f_e.cpu(), plan_on_cpu(torch, plan))
    got = f_k.cpu()
    abs_err = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"M4 {what}: not bit-equal to the CPU plain "
          f"version (max abs difference {abs_err:.3e})")
    check(torch.equal(f_k, k_force.scatter_force(f_e, plan)),
          f"M4 {what}: rerun not bit-identical")
    return f_k, abs_err


def m4_orphan_check(torch, f_e, plan, what: str) -> None:
    """M4 on ``plan`` with one more node, numbered 7, that no element
    names: bit for bit its CPU plain version, the node last in
    ``node_order`` and its forces 0."""
    from femcy_tpu_torch.kernels.ell_scatter import with_orphan_node

    orphan = with_orphan_node(plan, 7)
    check(int(orphan.node_order[-1]) == 7, f"M4 {what}: the orphan node is "
          "not last in node_order")
    f_k, _ = m4_against_cpu_plain(torch, f_e, orphan, f"{what}, orphan node")
    check(not f_k[7 * orphan.dm:8 * orphan.dm].any(),
          f"M4 {what}: the orphan node's forces are not 0")
    print(f"M4 {what} with an orphan node: bit-equal to the CPU plain "
          "version, bit-identical rerun, the orphan's forces 0", flush=True)


def m4_timing(torch, card, f_e, f_k, abs4, plan, what: str):
    """M4 timed in turns with its plain version and one ``index_add_`` of
    f_e over its int64 dof targets (built before the timing).  Returns its
    kernel-table row."""
    from femcy_tpu_torch.kernels import internal_force as k_force

    targets = k_force.force_targets(plan)
    lib_out = torch.zeros(plan.n_dof, dtype=f_e.dtype, device=DEVICE)
    f_flat = f_e.view(-1)
    lib_out.index_add_(0, targets, f_flat)
    name = str(f_e.dtype).split(".")[1]
    check(float((lib_out - f_k).abs().max()) <= TOL[name]
          * float(f_k.abs().max()), "M4's index_add_ yardstick disagrees")
    ms, pms, lms = in_turns(
        lambda: k_force.scatter_force_plain(f_e, plan),
        lambda: k_force.scatter_force(f_e, plan), 3, 20,
        lambda: lib_out.index_add_(0, targets, f_flat))
    isz = f_e.element_size()
    b = bound((f_e.numel() + plan.n_dof) * isz + plan.pairs.numel() * 4
              + plan.node_ptr.numel() * 8,
              f_e.numel(), name)
    sectors = k_force.m4_read_sectors(plan, isz)
    print(f"timing {what} on {card}: M4 internal_force kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, index_add_ {lms:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}); its reads at 32-byte sectors: " + ", ".join(
              f"{k} {v} bytes ({v / HBM_BYTES_PER_S * 1e3:.4f} ms)"
              for k, v in sectors.items()), flush=True)
    return row(abs4, ms, pms, lms, b)


def plan_bytes(plan) -> int:
    """The bytes of M1's plan that the kernel reads."""
    return sum(t.numel() * t.element_size()
               for t in (plan.node_ptr, plan.pairs, plan.positions,
                         plan.dia_columns) if t is not None)


def m1_against_cpu_plain(torch, Ke, plan, what: str):
    """M1 on the card, checked bit for bit against its plain version run
    on the CPU on the same Ke and against its own rerun.  Returns (values,
    max abs difference to the CPU plain version)."""
    from femcy_tpu_torch.kernels import ell_scatter as k_scat

    v_k = k_scat.scatter(Ke, plan)
    ref = k_scat.scatter_plain(Ke.cpu(), plan_on_cpu(torch, plan))
    got = v_k.cpu()
    abs_err = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"M1 {what}: not bit-equal to the CPU plain "
          f"version (max abs difference {abs_err:.3e})")
    check(torch.equal(v_k, k_scat.scatter(Ke, plan)),
          f"M1 {what}: rerun not bit-identical")
    return v_k, abs_err


def hub_meshes():
    """Meshes whose centre node's node-ELL row lies either side of the
    longest row M1 sums in shared memory (``SHARED_ROW_BYTES``): tet fans
    over an a x b grid of base nodes (3-D: 682 and 683 slots) and discs of
    triangles (2-D: 1536 and 1537 slots).  Returns {label: (mesh, slots of
    the centre's row)}."""
    from femcy_tpu_torch.mesh import FEMesh
    from femcy_tpu_torch.meshgen import box_tets, rect_tris

    out = {}
    for a, b in ((3, 227), (22, 31)):
        x, y = np.meshgrid(np.arange(a, dtype=float),
                           np.arange(b, dtype=float), indexing="ij")
        nodes = np.concatenate([
            np.stack([x.ravel(), y.ravel(), np.zeros(a * b)], 1),
            [[a / 2, b / 2, 1.0]]])
        g = np.arange(a * b).reshape(a, b)
        c00, c10 = g[:-1, :-1].ravel(), g[1:, :-1].ravel()
        c11, c01 = g[1:, 1:].ravel(), g[:-1, 1:].ravel()
        tris = np.concatenate([np.stack([c00, c10, c11], 1),
                               np.stack([c00, c11, c01], 1)])
        apex = np.full((tris.shape[0], 1), a * b)
        out[f"tet fan over {a} x {b}"] = (FEMesh(
            nodes, np.concatenate([tris, apex], 1),
            box_tets(1, 1, 1).element), a * b + 1)
    for n_ring in (1535, 1536):
        angle = np.linspace(0.0, 2.0 * np.pi, n_ring, endpoint=False)
        nodes = np.concatenate([[[0.0, 0.0]],
                                np.stack([np.cos(angle), np.sin(angle)], 1)])
        ring = np.arange(1, n_ring + 1)
        elements = np.stack([np.zeros(n_ring, np.int64), ring,
                             np.roll(ring, -1)], 1)
        out[f"triangle fan of {n_ring}"] = (FEMesh(
            nodes, elements, rect_tris(1, 1).element), n_ring + 1)
    return out


def scatter_route_checks(torch, card):
    """Phase 7, M1's other routes.  Returns the f64 row of its
    general-DIA route at HEX."""
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.kernels import ell_scatter as k_scat
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.mesh import FEMesh
    from femcy_tpu_torch.meshgen import (
        box_hexes,
        box_hexes20,
        box_wedges,
        rect_tris,
    )
    from femcy_tpu_torch.solvers.dia import build_dia_pattern
    from femcy_tpu_torch.topology import build_pattern

    def both_types(plan, Ke_np, what):
        for dtype in (torch.float32, torch.float64):
            m1_against_cpu_plain(torch, torch.as_tensor(
                Ke_np, dtype=dtype, device=DEVICE), plan, f"{what} {dtype}")

    collapsed = box_hexes(2, 2, 2)
    elements = collapsed.elements.copy()
    elements[0, 7] = elements[0, 6]  # the box's centre node, named twice
    collapsed = FEMesh(collapsed.nodes, elements, collapsed.element)
    # every instantiation of the kernel: dm 2 and 3, 1 to 6 rounds of 32
    # band values, and wide plans (2^15 + 1 DIA columns: int32 indices,
    # sums kept in the output)
    meshes = {"rect_tris(5, 4)": rect_tris(5, 4),
              "box_hexes(4, 3, 3)": box_hexes(4, 3, 3),
              "box_hexes20(2, 2, 1)": box_hexes20(2, 2, 1),
              "box_wedges(2, 2, 2)": box_wedges(2, 2, 2),
              "collapsed hex": collapsed}
    for label, mesh in meshes.items():
        pattern = build_pattern(mesh)
        edof = mesh.element.n_nodes * mesh.dm
        Ke_np = np.random.default_rng(4).standard_normal(
            (mesh.n_elements, edof, edof))
        for layout in ("ell", "dia", "wide dia"):
            dia = (build_dia_pattern(mesh, ell=pattern) if layout != "ell"
                   else None)
            check(layout == "ell" or dia is not None, f"{label}: no DIA layout")
            if layout == "wide dia":
                lo = min(dia.offsets)
                offsets = tuple(sorted(set(dia.offsets)
                                       | set(range(lo, lo + 2**15 + 1))))
                dia = dataclasses.replace(dia, offsets=offsets,
                                          diag_idx=offsets.index(0))
            plan = k_scat.build_scatter_plan(pattern, DEVICE, dia=dia)
            check(plan.wide == (layout == "wide dia"),
                  f"{label} {layout}: plan.wide is {plan.wide}")
            flagged = int((plan.pairs < 0).sum())
            check((flagged > 0) == (mesh is collapsed),
                  f"{label}: {flagged} pairs flagged as naming a node twice")
            both_types(plan, Ke_np, f"{label} {layout}")
            if layout == "ell":
                f_np = np.random.default_rng(9).standard_normal(
                    (mesh.n_elements, mesh.element.n_nodes, mesh.dm))
                for dtype in (torch.float32, torch.float64):
                    m4_against_cpu_plain(torch, torch.as_tensor(
                        f_np, dtype=dtype, device=DEVICE), plan,
                        f"{label} {dtype}")
                print(f"M4 on {label} (dm {mesh.dm}, {flagged} flagged "
                      "pairs): bit-equal to the CPU plain version in float32 "
                      "and float64, bit-identical reruns", flush=True)
            print(f"M1 on {label}, {layout} route ({plan.out_shape[1]} "
                  f"columns, {flagged} flagged pairs): bit-equal "
                  "to the CPU plain version in float32 and float64, "
                  "bit-identical reruns", flush=True)
            del plan

    # node rows either side of the longest one kept in shared memory
    for label, (mesh, slots) in hub_meshes().items():
        plan = k_scat.build_scatter_plan(build_pattern(mesh), DEVICE)
        wide = slots > k_scat.SHARED_ROW_BYTES // (8 * mesh.dm * mesh.dm)
        check(plan.node_width == slots and plan.wide == wide,
              f"{label}: node width {plan.node_width}, wide {plan.wide}")
        edof = mesh.element.n_nodes * mesh.dm
        both_types(plan, np.random.default_rng(5).standard_normal(
            (mesh.n_elements, edof, edof)), label)
        print(f"M1 on {label}, ell route (a {slots}-slot node row, "
              f"{'wide' if wide else 'in shared memory'}): bit-equal to the "
              "CPU plain version in float32 and float64, bit-identical "
              "reruns", flush=True)
        del plan

    mat = LinearIsotropic(1000.0, 0.3)
    mesh = box_hexes(*HEX)
    pattern = build_pattern(mesh)
    dia = build_dia_pattern(mesh, ell=pattern)
    check(dia is not None, f"box_hexes{HEX}: no DIA layout")
    plan = k_scat.build_scatter_plan(pattern, DEVICE, dia=dia)
    out = None
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)

        dsdx, vol = assembly.gradients_and_volume(
            dev(mesh.nodes), torch.as_tensor(mesh.elements.astype(np.int64),
                                             device=DEVICE),
            dev(mesh.element.dshape_at_gp), dev(mesh.element.gauss_weights))
        Ke = assembly.element_stiffness(dsdx, vol, dev(mat.C))
        del dsdx, vol
        v_k, abs1 = m1_against_cpu_plain(torch, Ke, plan,
                                         f"box_hexes{HEX} dia {name}")
        # the yardstick: one index_add_ over the int64 DIA targets, built
        # here, outside the timed window
        targets = k_scat.contribution_targets(plan)
        lib_out = torch.zeros(plan.out_shape, dtype=dtype,
                              device=DEVICE).view(-1)
        ke_flat = Ke.view(-1)
        lib_out.index_add_(0, targets, ke_flat)
        check(float((lib_out.view(plan.out_shape) - v_k).abs().max())
              <= TOL[name] * float(v_k.abs().max()),
              "M1's DIA index_add_ yardstick disagrees")
        ms, pms, lms = in_turns(
            lambda: k_scat.scatter_plain(Ke, plan),
            lambda: k_scat.scatter(Ke, plan), 3, 10,
            lambda: lib_out.index_add_(0, targets, ke_flat))
        del targets, lib_out
        b = bound((Ke.numel() + v_k.numel()) * Ke.element_size()
                  + plan_bytes(plan), Ke.numel(), name)
        print(f"timing box_hexes{HEX} {name} on {card}: M1 ell_scatter "
              f"kernel, general-DIA route (K = {dia.n_offsets}) {ms:.4f} ms, "
              f"plain {pms:.4f} ms, index_add_ {lms:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}), plan {plan_bytes(plan)} bytes",
              flush=True)
        if dtype == torch.float64:
            out = row(abs1, ms, pms, lms, b)
        del Ke, v_k
    del plan
    torch.cuda.empty_cache()
    return out


def solution_checks(torch, system, mesh, plain_spmv):
    """||A x - b||_inf against cg_eps * ||b||_inf with the plain SpMV of
    the layout, and the prescribed ux of the top face within the residual
    of its rows.  Returns (residual, ||b||_inf, ux error)."""
    fixed_d, sval_d = system._last_dirichlet
    values_bc, rhs_bc, _ = system._linear_system(
        torch.zeros_like(system.dof), fixed_d, sval_d)
    res = float((plain_spmv(values_bc, system.dof) - rhs_bc).abs().max())
    bmax = float(rhs_bc.abs().max())
    check(res <= system.config.cg_eps * bmax,
          f"||Ax-b||_inf {res:.3e} > cg_eps*||b||_inf "
          f"{system.config.cg_eps * bmax:.3e}")
    # Like femcy_tpu, the port leaves the eliminated rows (unit diagonal,
    # right-hand side 0.01) to the CG, so they hold 0.01 only to within the
    # CG's residual on those rows: |ux - 0.01| = |r_i| <= ||Ax-b||_inf.
    _, top = z_faces(mesh)
    check(bool((rhs_bc[top * 3] == 0.01).all()),
          "prescribed displacement not in the eliminated right-hand side")
    ux_err = float((system.dof[top * 3] - 0.01).abs().max())
    check(ux_err <= res, f"prescribed ux off by {ux_err:.3e} > ||Ax-b||_inf "
          f"{res:.3e}")
    return res, bmax, ux_err


def general_slice_run(torch, card, mesh, layout: str, host_K):
    """Phases 8 and 9: ``mesh`` through FEMSystem with the default config
    on the card, which must pick ``layout``.  Returns the launch counts and
    CG iterations."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic
    from femcy_tpu_torch.kernels import ell_scatter as k_scat
    from femcy_tpu_torch.solvers.cg import ell_spmv
    from femcy_tpu_torch.solvers.dia import dia_spmv

    mat = LinearIsotropic(1000.0, 0.3)
    etype = "C3D8" if mesh.element.n_nodes == 8 else "C3D4"
    inp = boundary_model(mesh, 0.01, etype)
    t = time.perf_counter()
    system = FEMSystem(mesh, mat, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in system._init_seconds.items())
    check(system.dtype == torch.float64, "default dtype is not float64")
    check((system.dia is not None) == (layout == "dia")
          and system.pattern is not None, f"layout is not {layout}")
    shape = (f"DIA, K = {system.dia.n_offsets}" if layout == "dia"
             else f"ELL, width {system.pattern.width}")
    print(f"{layout} slice: {mesh.n_elements} {etype} elements, {mesh.n_nodes} "
          f"nodes, {mesh.n_dof} dofs, {shape}; FEMSystem init {init_s:.3f} s "
          f"({phases})", flush=True)

    zero_launches()
    t = time.perf_counter()
    report = system.solve(inp)
    strain, stress, mises = system.compute_strain_stress()
    energy = system.elastic_energy()
    nodal = system.extrapolate(mises)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    launches = read_launches()
    iters = system._last_cg_iters
    timing = system.timer.summary()
    print(f"{layout} slice on {card}: first solve: assembly+bc "
          f"{timing['assemble+bc']['first']:.4f} s, CG {iters} iterations in "
          f"{timing['linear_solve']['first']:.4f} s, solve+post-processing "
          f"{total_s:.4f} s; launches {launches}", flush=True)

    E, G, npe = mesh.n_elements, mesh.element.n_gp, mesh.element.n_nodes
    check(report.success, "solve reported failure")
    check(iters > 0, "the CG path did not run")
    check(launches["ell_scatter"] == report.n_increments,
          f"M1 launched {launches['ell_scatter']} times for "
          f"{report.n_increments} assemblies")
    spmv_kernel = "dia_spmv" if layout == "dia" else "ell_spmv"
    other = "ell_spmv" if layout == "dia" else "dia_spmv"
    check(launches[spmv_kernel] == iters,
          f"{spmv_kernel} launched {launches[spmv_kernel]} times for {iters} "
          "CG iterations")
    check(launches[other] == launches["structured_accumulate"]
          == launches["structured_fused"] == 0,
          f"a kernel of another path launched: {launches}")
    check(tuple(system.dof.shape) == (mesh.n_dof,), "dof shape")
    check(tuple(stress.shape) == (E, G, 3, 3), "stress shape")
    check(tuple(strain.shape) == (E, G, 3, 3), "strain shape")
    check(tuple(mises.shape) == (E, G), "mises shape")
    check(tuple(nodal.shape) == (E, npe), "extrapolation shape")
    for name, t_ in (("dof", system.dof), ("stress", stress), ("mises", mises),
                     ("nodal", nodal)):
        check(bool(torch.isfinite(t_).all()), f"{name} not finite")
    check(np.isfinite(energy) and energy > 0.0, f"energy {energy}")

    # the operator against the f64 host operator, and M1 rerun bit for bit
    values = system._assemble_values()
    check(torch.equal(values, system._assemble_values()),
          "M1 rerun on the slice not bit-identical")
    v_np = values.cpu().numpy()
    if layout == "dia":
        diff = system.dia.to_scipy(v_np) - host_K
        err = float(abs(diff).max() / np.abs(host_K.data).max())
        plain = k_scat.scatter_plain(
            system._element_stiffness(), system._scatter_plan)
        err_plain = float((values - plain).abs().max() / plain.abs().max())
        check(err_plain <= TOL["float64"],
              f"M1 (DIA slots) vs plain: {err_plain:.3e}")
        extra = f", M1 vs plain {err_plain:.3e}"
        del plain

        def plain_spmv(v, x):
            return dia_spmv(v, system.dia.offsets, x)
    else:
        err = float(np.abs(v_np.reshape(-1)[system.pattern.csr_slots]
                           - host_K.data).max() / np.abs(host_K.data).max())
        extra = ""
        colidx = system._arrs["colidx"]

        def plain_spmv(v, x):
            return ell_spmv(v, colidx, x)
    check(err <= TOL["float64"], f"assembled operator vs host f64: {err:.3e}")
    del values, v_np
    res, bmax, ux_err = solution_checks(torch, system, mesh, plain_spmv)
    # the layout's SpMV kernel (P1 on DIA, M2 on ELL) on this slice's own
    # eliminated operator, against its plain version
    values_bc, _, _ = system._linear_system(
        torch.zeros_like(system.dof), *system._last_dirichlet)
    prep, apply_fn = system._spmv
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(mesh.n_dof),
                        dtype=values_bc.dtype, device=DEVICE)
    y_p = plain_spmv(values_bc, x)
    err_spmv = float((apply_fn(prep(values_bc), x) - y_p).abs().max()
                     / y_p.abs().max())
    check(err_spmv <= TOL["float64"],
          f"{spmv_kernel} vs plain on the slice's operator: {err_spmv:.3e}")
    del values_bc, x, y_p
    print(f"{layout} slice checks: operator rel err {err:.3e} vs the f64 host "
          f"operator{extra}, {spmv_kernel} kernel vs plain on the eliminated "
          f"operator {err_spmv:.3e} (tol {TOL['float64']:.0e}), M1 rerun "
          f"bit-identical, ||Ax-b||_inf/||b||_inf "
          f"{res / bmax:.3e} (cg_eps {system.config.cg_eps}), prescribed ux "
          f"off by {ux_err:.3e} (||Ax-b||_inf {res:.3e}), max mises "
          f"{float(mises.max()):.6g}, energy {energy:.6g}", flush=True)

    t = time.perf_counter()
    system.solve(inp)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    warm = system.timer.summary()
    print(f"{layout} slice warm solve on {card}: assembly+bc "
          f"{warm['assemble+bc']['steady_min']:.4f} s, CG "
          f"{system._last_cg_iters} iterations in "
          f"{warm['linear_solve']['steady_min']:.4f} s, solve {warm_s:.4f} s; "
          f"Timer {warm}", flush=True)
    del system
    torch.cuda.empty_cache()
    return launches, iters


def inp_text(mesh) -> str:
    """``mesh`` (C3D4) as an Abaqus .inp: z=0 clamped, ux=0.01 on z=1, a
    pressure of 2 on the x=max face through a *Surface of per-face-number
    element sets."""
    lines = ["*Heading", "chip_smoke general mesh", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(mesh.nodes)]
    lines.append("*Element, type=C3D4")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in conn)
              for e, conn in enumerate(mesh.elements)]
    x = mesh.nodes[:, 0]
    faces = {}
    for e, conn in enumerate(mesh.elements):
        for k, facets in enumerate(mesh.element.inp_surface_num):
            nodes = [int(conn[ln]) for f in facets for ln in f]
            if (x[nodes] > x.max() - 1e-9).all():
                faces.setdefault(k + 1, []).append(e + 1)
    bottom, top = z_faces(mesh)
    for name, ids in (("bot", bottom), ("top", top)):
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in ids)]
    for k, eles in faces.items():
        lines += [f"*Elset, elset=_x{k}, internal, instance=a",
                  ", ".join(str(e) for e in eles)]
    lines.append("*Surface, type=ELEMENT, name=xload")
    lines += [f"_x{k}, S{k}" for k in faces]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              "*Step, name=s, nlgeom=NO", "*Static", "1., 1., 1e-05, 1.",
              "*Boundary", "bot, 1, 1", "bot, 2, 2", "bot, 3, 3",
              "top, 1, 1, 0.01", "*Dsload", "xload, P, 2.", "*End Step"]
    return "\n".join(lines) + "\n"


def inp_run(torch):
    """Phase 10: the user's entry point on a general .inp model.  Returns
    the launch counts and iterations of its CG solve."""
    import tempfile

    from femcy_tpu_torch import (
        FEMesh,
        FEMSystem,
        SolverConfig,
        material_from_inp,
        read_inp,
    )
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/general.inp"
        with open(path, "w") as f:
            f.write(inp_text(unstructured_box_tets(INP_NX)))
        inp = read_inp(path)
    check(len(inp.neumann_bcs) == 1 and len(inp.neumann_bcs[0].face_set) > 0,
          ".inp model lost its *Dsload surface")
    mat = material_from_inp(inp.material_type, inp.material_params,
                            inp.element_type)
    mesh = FEMesh(inp.nodes, inp.elements, inp.element)
    dofs = {}
    for solver, eps in (("direct", 1e-3), ("cg", 1e-10)):
        s = FEMSystem(mesh, mat, inp.geometric_nonlinear, SolverConfig(
            linear_solver=solver, cg_eps=eps), device=DEVICE)
        check(s.dia is None, ".inp model did not take the ELL layout")
        zero_launches()
        check(s.solve(inp).success, f".inp {solver} solve")
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches["ell_scatter"] == 1, f".inp {solver}: M1 {launches}")
        check(launches["ell_spmv"] == s._last_cg_iters
              and (solver == "direct") == (s._last_cg_iters == 0),
              f".inp {solver}: M2 {launches}, {s._last_cg_iters} iterations")
        dofs[solver] = s.dof.cpu().numpy()
        iters, m2, cg_launches = s._last_cg_iters, launches["ell_spmv"], launches
    rel = float(np.abs(dofs["cg"] - dofs["direct"]).max()
                / np.abs(dofs["direct"]).max())
    check(rel <= 1e-7, f".inp CG vs direct: {rel:.3e}")
    print(f".inp model (unstructured_box_tets({INP_NX}), {mesh.n_elements} "
          f"C3D4, {mesh.n_dof} dofs, *Dsload on {len(inp.neumann_bcs[0].face_set)}"
          f" facets): CG (cg_eps 1e-10, {iters} iterations, M2 launched "
          f"{m2} times) vs host direct solve rel err {rel:.3e}", flush=True)
    return cg_launches, iters


def twist_model(mesh):
    """z=0 clamped; the z=1 face driven on all three dofs by ``*Boundary,
    user`` (the rotation hook, a twist about the box axis)."""
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel

    bottom, top = z_faces(mesh)
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={"bottom": bottom, "top": top}, ele_sets={}, face_sets={},
        dirichlet_bcs=bcs, neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=True,
        time_incs=dict(TWIST),
    )


def newton_run(torch, card, label: str, mesh, config: dict, force: str,
               tangent: str, warm: bool):
    """Phases 11-13: one geometric-nonlinear twist of ``mesh`` through
    FEMSystem.solve on the card, every launch counter zeroed just before
    and read just after.  Checks: success, the history against
    EXPECTED_NEWTON, the force kernel ``force`` (M5 or M4) and the tangent
    kernel ``tangent`` (P2 or M1) launched once per Newton evaluation, no
    kernel of another path, the f64 host residual (``internal_force_host``,
    BC rows zeroed) at the final dof within 1e-8 of the device's last
    reported residual (the rms, and the vector of a fresh evaluation),
    finite output of the expected shapes.  With ``warm``, a second solve
    must repeat the history.  Returns (launches, history)."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.assembly_host import internal_force_host
    from femcy_tpu_torch.user import make_rotation_dirichlet

    mat = LinearIsotropic(1000.0, 0.3)
    inp = twist_model(mesh)
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0))
    t = time.perf_counter()
    system = FEMSystem(mesh, mat, True, SolverConfig(**config), device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    check(system.dtype == torch.float64, "default dtype is not float64")

    def one_solve():
        n_rec, n_cg = len(system.timer.records), len(system._cg_iters_log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = system.solve(inp, user_dirichlet=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs = system.timer.records[n_rec:]
        split = {k: sum(r.seconds for r in recs if r.name == k)
                 for k in ("newton_eval", "linear_solve")}
        evals = sum(r.name == "newton_eval" for r in recs)
        history = [(r.newton_iters, r.converged) for r in report.increments]
        return report, wall, split, evals, history, system._cg_iters_log[n_cg:]

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    report, wall, split, evals, history, cg = one_solve()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    strain, stress, mises = system.compute_strain_stress()
    energy = system.elastic_energy()
    print(f"{label} on {card}: {mesh.n_elements} C3D4, {mesh.n_dof} dofs, "
          f"{config}; setup {setup_s:.3f} s; first solve {wall:.3f} s "
          f"(newton_eval {split['newton_eval']:.3f} s, linear_solve "
          f"{split['linear_solve']:.3f} s), {evals} evaluations, history "
          f"{history}, CG iterations per solve {cg}, peak memory "
          f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
    check(report.success, f"{label}: {report.message}")
    want = EXPECTED_NEWTON[label]
    check(history == want, f"{label}: history {history}, {want} expected")
    check(launches[force] == evals and launches[tangent] == evals,
          f"{label}: {force} launched {launches[force]} and {tangent} "
          f"{launches[tangent]} times for {evals} evaluations")
    spmv = ("dia_spmv" if system.dia is not None else "ell_spmv") if cg else None
    for name, n in launches.items():
        if name not in (force, tangent, spmv):
            check(n == 0, f"{label}: {name} launched {n} times")
    check(spmv is None or launches[spmv] > 0, f"{label}: no SpMV launched")
    E = mesh.n_elements
    for what, t_, shape in (("dof", system.dof, (mesh.n_dof,)),
                            ("strain", strain, (E, 1, 3, 3)),
                            ("stress", stress, (E, 1, 3, 3)),
                            ("mises", mises, (E, 1))):
        check(tuple(t_.shape) == shape, f"{label}: {what} shape")
        check(bool(torch.isfinite(t_).all()), f"{label}: {what} not finite")
    check(np.isfinite(energy) and energy > 0.0, f"{label}: energy {energy}")

    # the f64 host residual at the final dof against the device's
    fixed_d, sval_d = system._last_dirichlet
    fixed = fixed_d.cpu().numpy()
    t = time.perf_counter()
    r_host = internal_force_host(mesh, mat, system.dof.cpu().numpy())
    host_s = time.perf_counter() - t
    r_host[fixed] = 0.0
    rms_host = float(np.sqrt(np.mean(r_host * r_host)))
    rms_dev = report.increments[-1].residual
    rel_rms = abs(rms_dev - rms_host) / rms_host
    _, _, r_dev, _, _ = system._newton_eval(
        system.dof, torch.zeros_like(system.dof), fixed_d, sval_d)
    rel_vec = float(np.abs(r_dev.cpu().numpy() - r_host).max()
                    / np.abs(r_host).max())
    check(rel_rms <= 1e-8 and rel_vec <= 1e-8,
          f"{label}: device residual vs f64 host: rms {rel_rms:.3e}, vector "
          f"{rel_vec:.3e}")
    top = z_faces(mesh)[1]
    turned = float(np.abs(system.dof.cpu().numpy().reshape(-1, 3)[top]).max())
    print(f"{label} checks: last residual {rms_dev:.6e} (rms), f64 host "
          f"residual {rms_host:.6e} (rel {rel_rms:.3e}; vector rel "
          f"{rel_vec:.3e}; host {host_s:.2f} s), max top-face displacement "
          f"{turned:.6f}, max mises {float(mises.max()):.6g}, energy "
          f"{energy:.6g}", flush=True)
    del r_dev, strain, stress, mises
    if warm:
        report2, wall2, split2, evals2, history2, cg2 = one_solve()
        check(report2.success and history2 == history,
              f"{label}: warm solve history {history2} != {history}")
        print(f"{label} warm solve on {card}: {wall2:.3f} s (newton_eval "
              f"{split2['newton_eval']:.3f} s, linear_solve "
              f"{split2['linear_solve']:.3f} s), {evals2} evaluations, CG "
              f"iterations per solve {cg2}", flush=True)
    del system
    torch.cuda.empty_cache()
    return launches, history


def main() -> int:
    card = card_line()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from femcy_tpu_torch.kernels import _build

    t = time.perf_counter()
    _build.load_library()
    print(f"build: kernels built and loaded in {time.perf_counter() - t:.2f} s "
          f"({_build.library_path().name})", flush=True)

    results = {}
    full_ref = kernel_checks(torch, card, results)
    coarse_spmv_checks(torch)
    p2_launches = two_stage_run(torch, full_ref)
    box_force_checks(torch, card, results)
    iters = {}
    launches, iters["multigrid box"] = slice_run(torch, card, full_ref,
                                                 "multigrid")
    by_path = {"multigrid box": dict(launches)}
    small_box_check(torch, (8, 8, 8), "multigrid")
    by_path["jacobi box"], iters["jacobi box"] = slice_run(
        torch, card, full_ref, "jacobi")
    small_box_check(torch, SMALL, "jacobi")
    launches["structured_accumulate"] = p2_launches
    by_path["two-stage box assembly"] = {"structured_accumulate": p2_launches}
    del full_ref

    from femcy_tpu_torch.assembly_host import assemble_csr_host
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_hexes, box_tets, unstructured_box_tets
    from femcy_tpu_torch.topology import build_pattern

    host_K = general_kernel_checks(torch, card, results)
    m1_dia = scatter_route_checks(torch, card)
    ell, iters["ELL slice"] = general_slice_run(
        torch, card, unstructured_box_tets(UNSTRUCT[-1]), "ell", host_K)
    by_path["ELL slice"] = ell
    del host_K
    launches["ell_scatter"] = ell["ell_scatter"]
    launches["ell_spmv"] = ell["ell_spmv"]
    hexes = box_hexes(*HEX)
    t = time.perf_counter()
    hex_K = assemble_csr_host(hexes, build_pattern(hexes),
                              LinearIsotropic(1000.0, 0.3).C)
    print(f"general-DIA slice: f64 host operator of box_hexes{HEX} in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    by_path["general-DIA slice"], iters["general-DIA slice"] = (
        general_slice_run(torch, card, hexes, "dia", hex_K))
    del hex_K
    by_path[".inp model, CG"], iters[".inp model, CG"] = inp_run(torch)

    histories = {}
    by_path["box Newton"], histories["box Newton"] = newton_run(
        torch, card, "box Newton", box_tets(*FULL),
        dict(preconditioner="multigrid", linear_solver="cg"),
        "structured_force", "structured_accumulate", warm=True)
    by_path["ELL Newton"], histories["ELL Newton"] = newton_run(
        torch, card, "ELL Newton", unstructured_box_tets(UNSTRUCT[-1]), {},
        "internal_force", "ell_scatter", warm=True)
    small = unstructured_box_tets(INP_NX)
    by_path["consistent tangent"], histories["consistent tangent"] = (
        newton_run(torch, card, "consistent tangent", small,
                   dict(tangent="consistent"), "internal_force",
                   "ell_scatter", warm=False))
    by_path["Jacobian reuse"], histories["Jacobian reuse"] = newton_run(
        torch, card, "Jacobian reuse", small,
        dict(newton_jacobian_reuse="increment"), "internal_force",
        "ell_scatter", warm=False)
    by_path["box secant"], histories["box secant"] = newton_run(
        torch, card, "box secant", box_tets(16, 16, 16),
        dict(geometric_stiffness=False, preconditioner="multigrid",
             linear_solver="cg"), "structured_force", "structured_fused",
        warm=False)
    launches["structured_accumulate"] = by_path["box Newton"][
        "structured_accumulate"]
    launches["structured_force"] = by_path["box Newton"]["structured_force"]
    launches["internal_force"] = by_path["ELL Newton"]["internal_force"]
    print("launches per solve, by path: " + json.dumps(
        {path: {k: v for k, v in counts.items() if v}
         for path, counts in by_path.items()}), flush=True)
    print("CG iterations by path (expected): " + ", ".join(
        f"{path} {iters[path]} ({want})"
        for path, want in EXPECTED_CG_ITERS.items()), flush=True)
    for path, want in EXPECTED_CG_ITERS.items():
        check(iters[path] == want, f"{path}: {iters[path]} CG iterations, "
              f"{want} expected (a kernel changed its rounding)")
    print("Newton histories by path (expected): " + "; ".join(
        f"{path} {histories[path]} ({EXPECTED_NEWTON[path]})"
        for path in EXPECTED_NEWTON), flush=True)
    print(f"M1 on the general-DIA route at box_hexes{HEX}, float64: "
          + json.dumps(m1_dia), flush=True)

    source = {
        "dia_spmv": ("femcy_tpu_torch/csrc/dia_spmv.cu",
                     "femcy_tpu/kernels/dia_spmv.py:109"),
        "structured_accumulate": (
            "femcy_tpu_torch/csrc/structured_accumulate.cu",
            "femcy_tpu/kernels/structured_accumulate.py:176"),
        "structured_fused": (
            "femcy_tpu_torch/csrc/structured_fused.cu",
            "femcy_tpu/kernels/structured_fused.py:217"),
        # M1 and M2 replace XLA scatters and gathers, not Pallas kernels:
        # the JAX function each one takes the place of
        "ell_scatter": ("femcy_tpu_torch/csrc/ell_scatter.cu",
                        "femcy_tpu/assembly.py:167"),
        "ell_spmv": ("femcy_tpu_torch/csrc/ell_spmv.cu",
                     "femcy_tpu/solvers/cg.py:20"),
        "internal_force": ("femcy_tpu_torch/csrc/internal_force.cu",
                           "femcy_tpu/assembly.py:198"),
        "structured_force": ("femcy_tpu_torch/csrc/structured_force.cu",
                             "femcy_tpu/structured.py:476"),
    }
    rows = []
    for name, (src, replaces) in source.items():
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            **results["float64"][name],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
