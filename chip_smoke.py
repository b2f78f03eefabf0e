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
     rerun.
   Tolerances, relative to max|reference|: 1e-12 in float64, 1e-5 in
   float32.  At NX=56 the kernels and their plain versions are timed with
   CUDA events, in turns (plain, kernel, kernel, plain); P3 also against
   the two-stage path it replaces (isotropic prep + P2).
4. two-stage path: ``structured_assemble_coords(accumulate="pallas")`` on
   the NX=56 box in float64 against the analytic operator, with P2's
   launch counter zeroed just before and read just after.
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
7. print the kernel table as one JSON line (launches from the path that
   runs each kernel: P1 and P3 from the multigrid slice, P2 from the
   two-stage path), then the result line ``{"ok": true, "device": {...}}``
   last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

TOL = {"float32": 1e-5, "float64": 1e-12}
DEVICE = "cuda"
SMALL, FULL = (9, 7, 5), (56, 56, 56)


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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps_plain: int, reps_kernel: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps_plain)
    k1 = cuda_ms(kernel, reps_kernel)
    k2 = cuda_ms(kernel, reps_kernel)
    p2 = cuda_ms(plain, reps_plain)
    return (k1 + k2) / 2.0, (p1 + p2) / 2.0


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
            print(f"kernels {dims} {name}: P1 rel err {rel1:.3e}, P2 rel err "
                  f"{rel2:.3e} vs plain, {rel2a:.3e} vs analytic f64, P3 rel "
                  f"err {rel3:.3e} vs plain, {rel3a:.3e} vs analytic f64 "
                  f"(tol {tol:.0e})", flush=True)

            if dims == FULL:
                planes = stiffness_planes(
                    coords, mesh, dev(mesh.element.dshape_at_gp),
                    dev(mesh.element.gauss_weights), dev(mat.C),
                )
                ms1, pms1 = in_turns(
                    lambda: dia_spmv(vals, dia.offsets, x),
                    lambda: k_spmv.spmv(plan1, vt, x), 20, 50)
                ms2, pms2 = in_turns(
                    lambda: accumulate_planes(planes, plan),
                    lambda: k_acc.accumulate(planes, table), 3, 10)
                del planes
                lame = (fplan.lam, fplan.mu)
                dN = dev(mesh.element.dshape_at_gp)
                w = dev(mesh.element.gauss_weights)

                def two_stage():
                    return k_acc.accumulate(
                        stiffness_planes(coords, mesh, dN, w, None, lame=lame),
                        table)

                ms3, pms3 = in_turns(
                    lambda: fused_assemble_plain(coords, mesh, *lame, plan),
                    lambda: k_fused.fused_assemble(coords, fplan), 3, 10)
                ms3b, two_ms = in_turns(
                    two_stage, lambda: k_fused.fused_assemble(coords, fplan),
                    3, 10)
                print(f"timing {dims} {name} on {card}: P1 dia_spmv kernel "
                      f"{ms1:.4f} ms, plain {pms1:.4f} ms; P2 accumulate "
                      f"kernel {ms2:.4f} ms, plain {pms2:.4f} ms; P3 fused "
                      f"kernel {ms3:.4f} ms, plain {pms3:.4f} ms; P3 "
                      f"{ms3b:.4f} ms against the two-stage path (isotropic "
                      f"prep + P2) {two_ms:.4f} ms", flush=True)
                results[name] = {
                    "dia_spmv": (abs1, ms1, pms1),
                    "structured_accumulate": (abs2, ms2, pms2),
                    "structured_fused": (abs3, ms3, pms3),
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


def boundary_model(mesh, ux: float):
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel

    bottom, top = z_faces(mesh)
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, ux))
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={"bottom": bottom, "top": top}, ele_sets={}, face_sets={},
        dirichlet_bcs=bcs, neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=False,
        time_incs={"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                   "max_inc": 1.0},
    )


def slice_run(torch, card, full_ref, preconditioner: str):
    """Phases 5 and 6: the path through FEMSystem with ``preconditioner``.
    Returns its launch counts."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.kernels import dia_spmv as k_spmv
    from femcy_tpu_torch.kernels import structured_accumulate as k_acc
    from femcy_tpu_torch.kernels import structured_fused as k_fused
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

    k_spmv.spmv.launches = 0
    k_acc.accumulate.launches = 0
    k_fused.fused_assemble.launches = 0
    t = time.perf_counter()
    report = system.solve(inp)
    strain, stress, mises = system.compute_strain_stress()
    energy = system.elastic_energy()
    nodal = system.extrapolate(mises)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    launches = {"dia_spmv": k_spmv.spmv.launches,
                "structured_accumulate": k_acc.accumulate.launches,
                "structured_fused": k_fused.fused_assemble.launches}
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
    # the solution against the eliminated system, with the plain SpMV
    fixed_d, sval_d = system._last_dirichlet
    values_bc, rhs_bc, _ = system._linear_system(
        torch.zeros_like(system.dof), fixed_d, sval_d)
    res = float((dia_spmv(values_bc, system.dia.offsets, system.dof)
                 - rhs_bc).abs().max())
    bmax = float(rhs_bc.abs().max())
    check(res <= system.config.cg_eps * bmax,
          f"||Ax-b||_inf {res:.3e} > cg_eps*||b||_inf "
          f"{system.config.cg_eps * bmax:.3e}")
    # The prescribed ux of the top face.  Like femcy_tpu, the port leaves
    # the eliminated rows (unit diagonal, right-hand side 0.01) to the CG,
    # so they hold 0.01 only to within the CG's residual on those rows:
    # |ux - 0.01| = |r_i| <= ||Ax-b||_inf, not bit for bit.
    _, top = z_faces(mesh)
    check(bool((rhs_bc[top * 3] == 0.01).all()),
          "prescribed displacement not in the eliminated right-hand side")
    ux_err = float((system.dof[top * 3] - 0.01).abs().max())
    check(ux_err <= res, f"prescribed ux off by {ux_err:.3e} > ||Ax-b||_inf "
          f"{res:.3e}")
    print(f"{preconditioner} slice checks: operator rel err {err:.3e}, "
          f"||Ax-b||_inf/||b||_inf {res / bmax:.3e} (cg_eps "
          f"{system.config.cg_eps}), prescribed ux off by {ux_err:.3e} "
          f"(||Ax-b||_inf {res:.3e}), max mises {float(mises.max()):.6g}, "
          f"energy {energy:.6g}", flush=True)
    del values, values_bc

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
    return launches


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
    launches = slice_run(torch, card, full_ref, "multigrid")
    small_box_check(torch, (8, 8, 8), "multigrid")
    slice_run(torch, card, full_ref, "jacobi")
    small_box_check(torch, SMALL, "jacobi")
    launches["structured_accumulate"] = p2_launches

    source = {
        "dia_spmv": ("femcy_tpu_torch/csrc/dia_spmv.cu",
                     "femcy_tpu/kernels/dia_spmv.py:109"),
        "structured_accumulate": (
            "femcy_tpu_torch/csrc/structured_accumulate.cu",
            "femcy_tpu/kernels/structured_accumulate.py:176"),
        "structured_fused": (
            "femcy_tpu_torch/csrc/structured_fused.cu",
            "femcy_tpu/kernels/structured_fused.py:217"),
    }
    rows = []
    for name, (src, replaces) in source.items():
        abs_err, ms, plain_ms = results["float64"][name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
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
