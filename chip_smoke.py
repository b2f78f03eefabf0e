#!/usr/bin/env python3
"""Drive femcy_tpu_torch's main paths once on one NVIDIA GPU and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero).  Phases 1-10
(with 10b), 22, 36 and 37 run first and alone: they time the kernels.
Then three lanes run at once on the one card: this process runs 11-13,
18, 21, 24-30, 33-35 and 39; a second process of this script
(``--lane cli``) runs the CLI phases 14, 14b, 15, 23, 20 and 16,
then 32's CLI and 38's banded arch rescue; a third (``--lane
nonlinear``) runs 31, 32's two blocks, 17, 19, 38's banded Newton and
22b.  Each extra lane's lines are printed when this process's lane has
ended; then 40.  The walls of the phases that ran in lanes include the
other lanes' share of the card and the host.

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
   Ke -> planes transpose of ``structured_dia_scatter`` (the box's way
   into P2 for element matrices M9 does not make) timed beside P2, with
   the call's peak memory.  Then M9, the box's Newton element kernel
   (kinematics, stress, element force and Ke + Kg straight into P2's
   planes), in float32 and float64 on box_tets(9, 7, 5), the two M5 edge
   boxes and (56, 56, 56), on the setup's gradients and a seeded
   displacement: planes, element forces and volumes within 1e-13 (f64) or
   1e-5 (f32) of the largest value of its plain version (the einsum chain,
   run on the CPU below NX=56 and on the card at NX=56), bit-identical on
   a rerun; at NX=56 timed in turns with the einsum chain it replaces,
   beside its bound (bytes over 3.35 TB/s or fembench's dense operation
   count over the peak) and share, its registers and spills and both
   calls' peak memory.
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
   and the Timer sections.
9. general-DIA slice: the same on box_hexes(48, 48, 48) (110,592 C3D8
   elements, 352,947 dofs, K = 99 offsets): M1 into the DIA slots, P1 in
   the CG; operator vs the host operator and vs M1's plain version, P1 vs
   the plain ``dia_spmv`` at these 99 mesh-derived offsets.
10. .inp entry point: an unstructured_box_tets(12) C3D4 model written as
   Abaqus text (node sets, *Boundary, a *Surface with a *Dsload
   pressure, *Elastic, *Static), read with read_inp, solved on the card
   with the CG at cg_eps=1e-10 (M1 and M2) against the host direct solve.
10b. AMG slice (the algebraic-multigrid main path, the twin of the JAX
   bench cells c3d4_1053k_unstructured_setup and _amg): the ELL slice's
   mesh and boundary model through FEMSystem with
   SolverConfig(preconditioner="amg", linear_solver="cg") in float64,
   every launch counter zeroed just before the solve and read just after.
   Checks: success, M1 once, M3 (block-ELL SpMV) launched (iterations +
   1) x 7 x (levels - 1) + iterations times (each non-coarsest level of a
   V-cycle: two smoothings of two applies, a residual, R and P; one
   V-cycle before the PCG loop and one per iteration, one fine apply per
   iteration), M2 and P1-P3 never, ||A x - b||_inf <= cg_eps * ||b||_inf
   with the plain ELL SpMV, the prescribed ux within the residual of its
   rows, finite output of the expected shapes, a warm solve on the kept
   hierarchy with the same iterations.  Prints the hierarchy beside
   femcy_tpu's recorded one, the setup split (``_init_seconds``,
   ``_amg_host_seconds``, ``setup_seconds``), the first and warm walls,
   one V-cycle and one AMG-PCG under torch.profiler (wall, device busy,
   device events per iteration), the peak memory, and the largest
   difference from the ELL slice's Jacobi x (not gated).  Then M3 in
   float32 and float64 vectors on every operand of that hierarchy (the
   fine level from the eliminated ELL values, each level's bf16 A, P and
   R) and of rect_tris(60, 40)'s (2 x 2, 2 x 3, 3 x 2 and 3 x 3 blocks)
   against the plain ``bell_spmv`` run on the CPU on the same tensors
   (1e-12 / 1e-5 relative to max|y|), bit-identical on a rerun; at the
   fine level timed in turns with its plain version and cuSPARSE's CSR
   matvec, M2 on the same operator timed before and after, with its
   bound.
11. Newton, box (a main path): FEMSystem(box_tets(56, 56, 56),
   LinearIsotropic(1000, 0.3), geometric_nonlinear=True,
   SolverConfig(preconditioner="multigrid", linear_solver="cg")) in
   float64, z=0 clamped and the z=1 face turned about the box axis by the
   rotation hook under ``*Boundary, user`` (``TWIST``: 3.6 degrees in five
   increments), every launch counter zeroed just before the solve and
   read just after.  Checks: success, the increment/Newton history
   against ``EXPECTED_NEWTON``, M9, M5 and P2 launched once per Newton
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
   current coordinates, and M5), the same checks without the warm solve;
   and unstructured_box_tets(12) with preconditioner="amg" and the CG
   (M4 and M1 once per evaluation, M3 in every solve, one hierarchy
   build for the whole solve).
14. CLI, ELL (the user's entry point): unstructured_box_tets(56) written
   as a C3D4 .inp (``inp_text``, with numpy: z=0 clamped, ux=0.01 on
   z=1, a pressure of 2 on the x=max face) and run in this process by
   ``femcy_tpu_torch.cli.main([path, "--stress", "2", "--save-vtk",
   ..., "--save-html", ...])`` with stdout captured and every launch
   counter zeroed just before and read just after.  Checks: rc 0; M1
   launched once and M2 once per CG iteration, no other kernel; the
   printed model line and observables equal to the strings formatted
   from a FEMSystem built here from ``read_inp`` of the same file; the
   VTK's POINTS and CELLS counts and cell types (10), the largest
   |value| of its displacement block equal to the printed max |dof| at
   the printed precision; the HTML payload's triangle count equal to the
   mesh's surface triangles.  Prints the walls of writing the .inp and
   of the CLI's stages (read: the routing scan, ``read_inp_multi`` and
   ``read_inp``; setup; solve; post: stress, extrapolation and the host
   copies; vtk; html), each beside the card's name and power limit.
14b. CLI, AMG: the .inp model of phase 10 through ``cli.main([path,
   "--preconditioner", "amg", "--solver", "cg"])``: rc 0, the printed
   lines equal to a FEMSystem solve's with the same config, M1 once and
   M3 launched, no other kernel.
15. CLI, general DIA: the same for box_hexes(48, 48, 48) as a C3D8 .inp
   (M1 once, P1 once per CG iteration, cell type 12), the CLI run inside
   ``utils.timing.device_trace``: the trace file must exist and name
   P1's kernel, ``dia_spmv_kernel``.
16. CLI, nonlinear: an nlgeom .inp on unstructured_box_tets(12) (z=0
   clamped, uz = -0.1 on z=1 in four increments), run plain and with
   ``--stabilize 2e-4``: rc 0, the pinned increment count from the
   printed solve line, M4 and M1 launched equally often, at least once
   per increment, and no other kernel (direct solves).
17. Stabilized Newton at full width: the ELL twist of phase 12 and the
   box secant twist of phase 13 with ``stabilize_factor=2e-4``, held as
   those are (pinned histories, M4 and M1, or M5 and P3, once per
   evaluation), with the dissipated energy finite and positive and the
   f64 host residual extended by the last increment's viscous force.
18. two-material ELL box (multi-block, slice H): the ELL slice's mesh in
   two C3D4 blocks by centroid z (z < 0.5 LinearIsotropic(1000, 0.3),
   the rest (4000, 0.3)) through MultiBlockSystem on the card, the
   slices' boundary model.  Checks: each block's M1 output bit for bit
   its plain version run on the CPU and M4 the same on seeded element
   forces; the union operator (the blocks' M1 outputs summed in block
   order) within 1e-12 of the f64 host twin (``union_values_host``); a
   Jacobi CG solve (M1 once per block, M2 once per iteration, no other
   kernel), then on the same system ``preconditioner="amg"`` (M1 once per
   block, M3 as the V-cycle predicts), each with ||A x - b||_inf <=
   cg_eps * ||b||_inf, finite per-block stress, Mises and energy, a warm
   solve with the same iterations and the pinned CG counts.  Prints the
   union width, the setup split, the AMG host split, the levels, the
   first and warm walls and the peak memory.
19. hex + wedge box: box_hexes(48)'s grid, the cells with i < 24 C3D8
   LinearIsotropic(1000, 0.3), the others two C3D6 each as box_wedges
   splits them, NeoHookean(C1=192.3, D1=288.5) (352,947 dofs): the
   phase 18 checks with a Jacobi CG (M1 for npe 8 and 6), then the
   ``TWIST`` through ``solve_nonlinear`` (the z=1 face turned by the
   rotation hook): the pinned history, M4 and M1 once per block per
   evaluation, M2 once per CG iteration, the f64 host residual (each
   block's ``internal_force_host``, summed) within 1e-8 of the device's.
20. CLI, multi-block: phase 19's mesh as a two-*Solid Section .inp (the
   wedges ``*Hyperelastic, neo hooke``) with a pressure on x = 1 through
   ``cli.main`` with ``--stress 2 --save-vtk --save-html``: rc 0, the
   printed lines equal to those formatted from a ``system_from_model
   (read_inp_multi(...))`` solve, M1 once per block and M2 once per CG
   iteration, the VTK's mixed cell types (12, 13), the HTML's triangles;
   then the same box at n = 6 as an nlgeom .inp (uz = -0.1 on z=1 in
   four increments), plain and with ``--stabilize 2e-4`` (warned about
   and ignored: the same lines), M4 = M1, two per evaluation.
21. B31 lattice: a 16 x 16 x 16-bay frame (4,913 nodes, 29,478 dofs,
   13,872 members, a 6.95 GB dense operator), the base ENCASTRE, seeded
   loads on the top nodes, through ``solve_beam`` on the card twice:
   bit-identical, the free-dof residual <= 1e-10 of max|f|, the
   reactions balancing the loads within 1e-9, no counted kernel (the
   dense Cholesky is a library call); one- and ten-element cantilevers
   against the Timoshenko closed form (1e-9); the CLI's B31 route on a
   2 x 2 x 2-bay .inp, rc 0.  Prints the assembly, Cholesky, solve and
   recovery walls and the peak memory.
22. mixed beam + continuum box (slice H, second half): box_tets(56, 56,
   56) in LinearIsotropic(1000, 0.3) under a grid of B31 members on its
   z = 1 face (every x- and y-line of that face's nodes: 6,384 members,
   3,249 beam nodes; RECT 0.02 x 0.02, E 2e5, nu 0.3), z = 0's
   translations clamped, an x *Cload of total 1 over the z = 1 nodes
   (1,111,158 dofs) through MixedSystem on the card in float64 with the
   default config (Jacobi CG, M2).  First M6, the mixed scatter, on the
   system's own element matrices in float32 and float64: bit for bit its
   plain version run on the CPU and bit-identical on a rerun; the union
   values, read through the pattern, within 1e-12 of the f64 host twin
   summed over dof pairs without pattern or plan
   (``mixed.union_operator_host``), every padding slot 0; timed in turns
   with its plain version and one ``index_add_`` over the int64 targets,
   in float64 and float32, each with its bound, beside its registers,
   warps a block and resident blocks an SM and its plan's bytes.  Then
   the solve, every launch counter
   zeroed just before and read just after: M6 once, M2 once per CG
   iteration, no other kernel, ||A x - b||_inf <= cg_eps * ||b||_inf with
   the plain SpMV, M2 against its plain version on the eliminated
   operator, finite results of the expected shapes and a warm solve with
   the same iterations.  Prints the setup phases, the walls and the peak
   memory.
22b. M6's other routes: a radial strut hub (box_tets(16), the z = 1
   face's centre joined by B31 members to that face's other 288 nodes;
   union width 1,746) through MixedSystem on the card: its plan is wide
   (every row summed in the output, int32 starts), and M6 on its own
   element matrices is bit for bit its CPU plain version in float32 and
   float64, bit-identical on a rerun, within 1e-12 of the f64 host twin
   with every padding slot 0, each launch counted on the wide route; then
   a C3D8 bar under a B31 spine (M6's generic kind), plain and with a
   collapsed hex, on its plan and on that plan built wide, on seeded
   element matrices: bit for bit the CPU plain version in float32 and
   float64, bit-identical reruns.  Prints its wall.
23. CLI, mixed: the same grid on box_tets(12) as a .inp with a *Dsload on
   its z = 1 faces through ``cli.main``: rc 0, the lines of a
   ``solve_mixed(read_mixed_inp(...))`` on the card, M6 once and no other
   kernel (a direct solve).
24. Riks: ``riks_solve`` on the box Newton cell's mesh and system
   (box_tets(56), nlgeom, the multigrid CG), z = 0 clamped, a pressure of
   20 on the z = 1 face, lam_target 1: success, no limit point, the step
   history against ``EXPECTED_RIKS``, M9, M5 and P2 once per evaluation, P1
   in the solves, no other kernel, the f64 host residual at the final
   state within the Riks tolerance and the dof within 1e-6 of a
   load-controlled ``FEMSystem.solve`` of the same load.
25. refinement, box: the NX=56 box of phase 5 in float32
   (``FEMCY_TPU_X64=0`` for this phase only) with the multigrid CG and
   ``mixed_precision_refine=True``: P3 once and P1 in the inner MG-CG
   solves, in float32, no other kernel; the outer iterations against
   ``EXPECTED_REFINE_OUTER``; the certificate ||b - K64 x||_inf /
   ||b||_inf of the f64 state on the f64 host CSR operator <= 1e-6 (the
   line at which femcy_tpu warns "stalled"), printed beside the plain
   float32 solve's and both solutions' distance to phase 5's float64
   MG-CG solution; the host twin's build time and a warm solve.
26. refinement, near-incompressible: box_tets(16) at nu = 0.4999 in
   float32, the Jacobi CG capped above any solve's count: the refined
   f64 state within 1e-6 relative (inf-norm) of the f64 host direct
   solve, P1 once per CG iteration; the plain float32 error beside it.
27. Newton refinement: the pinned twist on unstructured_box_tets(12) in
   float32 with refinement: the history against ``EXPECTED_NEWTON``, M4
   once per evaluation, M1 also in the refinement's consistent tangents,
   rms(r64)/rms(f) of ``dof_refined`` (f64 host internal force) < 1e-9,
   beside the unrefined run's.
28. dense CG: unstructured_box_tets(20) (27,783 dofs, a 6.18 GB float64
   operator) and box_tets(12), linear, ``dense_operator_max_dof=30000``,
   cg_eps 1e-10: within 1e-8 of the sparse Jacobi CG of the layout (M2 or
   P1 once per iteration there, no SpMV kernel in the dense solve, whose
   product is cuBLAS's), the counts against ``EXPECTED_CG_ITERS``; ms an
   iteration beside the operator's bytes over 3.35 TB/s, and the product
   alone.
29. fused Newton: the pinned twist with ``fused_newton=True`` on the ELL
   slice's mesh (M4, M1 and M2: the "ELL Newton" history, as the same
   Jacobi CG runs on the same operator) and on box_tets(16) (M9, M5, P2
   and P1), through ``newton_run``.
30. device loop: the pinned twist on the ELL slice's mesh with
   ``device_loop=True``: the records against ``EXPECTED_NEWTON``, M1 once
   per full evaluation, M4 also once per residual probe, M2 in the CG
   solves, the f64 host residual at the final state within 1e-8; then a
   device loop with ``stabilize_factor`` raises ValueError and launches
   nothing.
31. rescue, single block: femcy_tpu's snap-through arch (its
   tests/test_dynamic_rescue.py fixture) at 512 x 8 CPE4 (9,234 dofs),
   the consistent tangent, f64: with ``dynamic_rescue`` it snaps through
   (success, time0 == 1, the apex below -2 rise) with the rescue's
   (t_resc, Newmark steps) against ``EXPECTED_RESCUE``, M4 and M1 once
   per evaluation and once for the rescue's stiffness probe (the host
   direct solve, no other kernel) and the rescue's warnings; the static
   control, resumed without the rescue at that run's last attempt before
   the rescue (its last converged state and the dt of the attempt that
   failed there), aborts "WITHIN the increment" at the same time; a
   static resume moves dof by <= 1e-9.  Prints the Newmark steps, h/h0 at the
   end, the evaluations and the consistent tangent's ms an evaluation.
32. rescue, the CLI and two blocks: ``cli.main`` with
   ``--dynamic-rescue`` on the arch at the fixture's 64 x 2 as an .inp
   (exit 0, the rescue's two warning lines; its solve's records recorded:
   the rescue's (t_resc, Newmark steps) against
   ``EXPECTED_RESCUE_FIXTURE``); phase 31's arch in two ElementBlocks (the
   lower and upper half of its thickness) through
   ``MultiBlockSystem.solve_nonlinear`` (success, min uy within 1e-6
   relative of phase 31's, M4 and M1 once per block and evaluation).
33. slab, linear: the NX=56 box of phase 5 with ``sharding="slab"`` in 4
   slabs of 14 cell planes on the one card, with the multigrid and with
   the Jacobi CG at cg_eps 1e-10: dof within 1e-7 (inf-norm, relative) of
   the single-device FEMSystem at the same cg_eps; P1's windowed entry
   point launched, P2 4 times an assembly (P1 in the inner multigrid), no
   P3; the CG iterations (18 and 1,075, as the single device) against
   ``EXPECTED_CG_ITERS``, the warm walls and peak memory beside the single
   device's.
   (P1's windowed entry point is held against its plain version in
   float32 and float64 at this slab shape after phase 3, and timed there
   beside the plain P1 on the same rows and cuSPARSE's CSR matvec.)
34. slab, Newton: the pinned twist on the NX=56 box in 4 slabs with the
   multigrid CG: the history of "box Newton" (``EXPECTED_NEWTON``), dof
   and elastic energy within 1e-6 of phase 11's single-device run, M5 and
   P2 4 times an evaluation, the windowed P1 in the solves; then one
   consistent-tangent slab evaluation at the final state against the
   single-device one (tangent values within 1e-12 relative).
35. sharded ELL: ``ShardedLinearSolver`` on the ELL slice's mesh in 4
   shards on the one card: at cg_eps 1e-3 its CG iterations (pinned,
   beside the single device's 312), M1 once a shard (M7), M2 once a shard
   an iteration; at cg_eps 1e-10 x within 1e-8 of the single-device ELL
   solve and its f64 host residual below 1e-8; one ``ShardedNewtonStep``
   against the single-device evaluation and CG: rms 1e-10, and the step's
   residual on the single device's tangent below 1e-8, as the single
   device's own CG's.
36. M7 and M8 alone at the full-width shard shapes, f32 and f64: M1 and
   M4 on shard 0's plan of the ELL slice's mesh, M8's stiffness and force
   plans of shard 0 of the banded cell, each bit for bit its plain
   version run on the CPU and its rerun; timed in f64 beside its plain
   version, one ``index_add_`` and its bound.
37. banded cell: BANDED_SWEEP.json's cantilever_tets(400, 20) (530,523
   dofs, its axial loading) through ``BandedShardedSolver`` in 4 shards,
   twolevel, cg_eps 1e-5: B 1328, nbl 100, M8 once a shard, its
   iterations (pinned, beside the JAX CPU sweep's 48), the setup,
   assembly, factor and CG walls, peak memory, one Thomas sweep and one
   SpMV, the f64 host residual below 1e-4.
38. banded Newton: tests/test_banded.py's nlgeom cantilever at
   cantilever_tets(100, 8) (24,543 dofs), secant and consistent, through
   ``FEMSystem(sharding="banded", sharding_devices=4)`` and the
   single-device ELL FEMSystem, both at cg_eps 1e-10: the same history
   (pinned), dof 1e-8, energy 1e-10, M8 twice a shard an evaluation; then
   the arch of phase 31 at its fixture's 64 x 2 with the rescue in 2
   banded shards, resumed at the last attempt before the rescue of phase
   32's CLI run (the single-device reference): the same records from
   there, min uy within 1e-6.
39. slice J, femcy_tpu's remaining public functions, at full width in
   float64: on the NX=56 box ``structured_assemble`` against
   ``structured_dia_scatter`` of all element stiffnesses (1e-13, both
   through P2) and the analytic operator (1e-12), P2 launched once a call
   and nothing else, its peak memory; ``analytic_dia_values_device`` on
   the card against the host elimination of the analytic operator with a
   seeded 20% ``fixed`` mask (1e-12 of max); on the ELL slice's operator
   (kept from phase 8) the public ``solvers.pcg_solve`` with no ``spmv``:
   312 iterations (pinned as "slice J, pcg_solve"), M2 once an iteration
   and nothing else, ||A x - b||_inf <= cg_eps * ||b||_inf with the plain
   gather; the public ``solvers.ell_spmv`` on that x against the plain
   gather (1e-12), each timed in turns; ``assembly.internal_force`` on
   seeded stresses of that mesh against M4 (1e-12).  Each check's wall.
40. print the launch counts and the CG iterations of every path, each
   beside the count that the deterministic kernels have always given, and
   fail on another count (a kernel changed its rounding), and the Newton
   histories beside the pinned ones; then the kernel table as one JSON
   line: per kernel, its f64 time and its plain version's, the library
   call's (null for P3, which no single PyTorch call computes from
   coordinates), its bound (the larger of its bytes over 3.35 TB/s and its
   operations over the f64 peak, from this run's shapes) and the launches
   of the path that runs it (P1 and P3 from the multigrid slice, P2, M5
   and M9 from the box Newton path, M1 and M2 from the ELL slice, M4 from the
   ELL Newton path, M3 from the AMG slice, M6 from the mixed box, P1's
   windowed entry point from the multigrid slab of phase 33, M7 from the
   sharded ELL solve, M8 from the banded cell); then
   the result line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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
#: M9 against its plain version, relative to the largest value: the same
#: terms summed in another order, with FMAs (a few ulps in f64; f32's
#: Green strain F^T F - I loses ~1e-7 over the strain to cancellation)
M9_TOL = {"float32": 1e-5, "float64": 1e-13}
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
#: rounding (the CLI's models are the slices' meshes with a pressure added
#: on the x=max face, hence their other counts)
EXPECTED_CG_ITERS = {"multigrid box": 6, "jacobi box": 257, "ELL slice": 312,
                     "general-DIA slice": 163, ".inp model, CG": 260,
                     "CLI, ELL": 306, "CLI, general DIA": 166,
                     "AMG slice": 8, "CLI, AMG": 5,
                     "two-material ELL": 314, "two-material AMG": 7,
                     "hex+wedge": 188, "CLI, multi-block": 188,
                     "mixed box": 1125, "dense CG, ELL": 438,
                     "dense CG, box": 250, "slab, multigrid": 18,
                     "slab, jacobi": 1075, "sharded ELL": 314,
                     "banded cell": 48, "slice J, pcg_solve": 312}
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
                   "box secant": [(1, True)] * 5,
                   "ELL Newton, stabilized": [(2, True)] * 5,
                   "box secant, stabilized": [(1, True)] * 5,
                   "Newton, AMG": [(1, True)] * 5,
                   "hex+wedge Newton": [(4, True)] * 5,
                   "Newton refinement": [(1, True)] * 5,
                   "ELL Newton, fused": [(2, True)] * 5,
                   "box fused": [(1, True)] * 5,
                   "device loop": [(2, True)] * 5,
                   "slab Newton": [(2, True)] * 5,
                   "banded Newton, secant": [(14, True), (12, True)],
                   "banded Newton, consistent": [(18, True), (11, True)]}
#: the dissipated-energy fraction of the stabilized cases (the CLI's
#: ``--stabilize`` and ``SolverConfig.stabilize_factor``)
STABILIZE = 2e-4
#: the geometric-nonlinear .inp model of the CLI: unstructured_box_tets(12),
#: z=0 clamped, the z=1 face pushed down by 0.1 in four increments (with
#: 0.2 the CPU run cut back; 0.1 converges in every increment)
NL_NX, NL_UZ, NL_STATIC = 12, -0.1, "0.25, 1., 1e-05, 0.25"
EXPECTED_CLI_INCREMENTS = {"CLI nonlinear": 4, "CLI nonlinear, stabilized": 4,
                           "CLI multi-block nonlinear": 4}
#: the hex + wedge box of the multi-block phases (box_hexes(MB_N)'s grid;
#: 55,296 C3D8 + 110,592 C3D6, 352,947 dofs) and the wedges' neo-Hookean
#: constants (mu = 2 C1 and lambda = 2 D1 those of E 1000, nu 0.3); the
#: small nlgeom model of the CLI phase
MB_N, MB_C1, MB_D1, MB_NL_N = 48, 192.3, 288.5, 6
#: the slabs of the many-section assembly timing (phase 18)
MB_SLABS = 10
#: bays per side of the B31 lattice: 4,913 nodes, 29,478 dofs, 13,872
#: members, a 6.95 GB dense f64 operator
BEAM_N = 16
#: the frame-stiffened box of the mixed phases (``mixed_model``): its grid
#: members' square RECT side, E and nu; the box of the CLI's mixed .inp and
#: the pressure on its z = 1 face
MIXED_SECTION, MIXED_E, MIXED_NU = 0.02, 2.0e5, 0.3
MIXED_CLI_N, MIXED_PRESSURE = 12, 1.0
#: the hub of M6's wide route (``hub_model``): box_tets(16), its z = 1
#: face's centre joined to the other 288 nodes of that face
MIXED_HUB_N = 16
#: the Riks phase: the pressure on the z = 1 face of the NX=56 box, and the
#: (lambda, Newton iterations) of each arc-length step, as the card has
#: given them since the phase was added (lambda within 1e-6 relative)
RIKS_PRESSURE = 20.0
EXPECTED_RIKS = [(0.10030737271675544, 2), (0.2519212172804087, 3),
                 (0.48194578134763744, 4), (0.8328704462678769, 4),
                 (1.3726049370483355, 5)]
#: the refinement phases: the outer iterations of the float32 refinement
#: on the NX=56 box, as the card has given them since the phase was added,
#: and the iteration cap of the nu = 0.4999 box's Jacobi CG (above any
#: solve's count, so each inner solve reaches cg_eps)
EXPECTED_REFINE_OUTER = 4
REFINE_CG_CAP = 100_000
#: the dense CG phase: unstructured_box_tets(DENSE_NX) (27,783 dofs, a 6.2
#: GB float64 operator) and box_tets(DENSE_BOX), dense below DENSE_MAX_DOF
DENSE_NX, DENSE_BOX, DENSE_MAX_DOF = 20, 12, 30_000
#: the rescue phases: femcy_tpu's snap-through arch (rise ARCH_RISE) at
#: ARCH_FINE (CPE4 across the span x through the thickness) and at its
#: test fixture's ARCH_FIXTURE (the CLI's .inp); the rescue's record
#: (t_resc to 9 digits, Newmark steps) as the card has given it since the
#: phase was added
ARCH_RISE, ARCH_FINE, ARCH_FIXTURE = 8.0, (512, 8), (64, 2)
EXPECTED_RESCUE = (0.062129448, 64)
#: the rescue's record at ARCH_FIXTURE (the banded rescue's reference
#: run) as the card and the CPU have given it
EXPECTED_RESCUE_FIXTURE = (0.077881736, 63)
#: the slab phases' shard count: four slabs of 14 cell planes of the NX=56
#: box, all on the one card
SLABS = 4
#: the sharded and banded phases' shard count, all on the one card; the
#: banded arch rescue's (its tiny shards' launches bound its wall)
SHARDS, RESCUE_SHARDS = 4, 2
#: the banded phases: BANDED_SWEEP.json's largest cell (530,523 dofs) and
#: the iterations its JAX CPU sweep took at 4 devices; the nlgeom
#: cantilever of the banded Newton phase (24,543 dofs)
BANDED_CELL, BANDED_SWEEP_ITERS = (400, 20), 48
#: its block size and row blocks a shard at SHARDS shards
BANDED_CELL_BLOCKS = (1328, 100)
BANDED_NL = (100, 8)


#: the argument that runs an extra lane (``run_lane``) in place of
#: ``main``, and the prefix of its result line
LANE_ARG = "--lane"
LANE_RESULT = "lane result: "
#: the script's start; the extra lanes are stopped 1,150 s after it
T_START = time.perf_counter()
LANE_DEADLINE_S = 1150.0


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


def csr_matvec(keep, cols, values, n_cols=None):
    """The library yardstick of an SpMV: a CSR tensor (int32 indices) of
    the entries of ``values`` where ``keep`` holds, (rows, ``n_cols``;
    square by default), and its matvec."""
    import warnings

    import torch

    n = keep.shape[0]
    crow = torch.zeros(n + 1, dtype=torch.int32, device=keep.device)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        A = torch.sparse_csr_tensor(crow, cols[keep].int(), values[keep],
                                    size=(n, n if n_cols is None else n_cols),
                                    check_invariants=False)
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
        bell_spmv,
        btd_scatter,
        dia_spmv,
        ell_scatter,
        ell_spmv,
        internal_force,
        mixed_scatter,
        newton_element,
        structured_accumulate,
        structured_force,
        structured_fused,
    )

    return {"dia_spmv": dia_spmv.spmv,
            "dia_spmv_window": dia_spmv.spmv_window,
            "structured_accumulate": structured_accumulate.accumulate,
            "structured_fused": structured_fused.fused_assemble,
            "ell_scatter": ell_scatter.scatter,
            "ell_spmv": ell_spmv.spmv,
            "internal_force": internal_force.scatter_force,
            "structured_force": structured_force.force_scatter,
            "newton_element": newton_element.evaluate,
            "bell_spmv": bell_spmv.spmv,
            "mixed_scatter": mixed_scatter.scatter,
            "btd_scatter": btd_scatter.scatter}


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
    at NX=56, the Ke -> planes transpose of ``structured_dia_scatter`` (the
    way into P2 of the element matrices M9 does not make) timed beside P2
    on the box's element stiffnesses, with the call's peak memory."""
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

    # structured_dia_scatter's Ke -> planes transpose beside P2
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


def newton_element_checks(torch, card, results):
    """Phase 4c: M9, the box's Newton element kernel, in float32 and
    float64 on box_tets(9, 7, 5), (5, 6, 19), (2, 3, 1) and (56, 56, 56),
    on the setup's gradients and a seeded displacement (a few hundredths
    of a cell): its planes, element forces and volumes against its plain
    version (the einsum chain and the Ke -> planes transpose) run on the
    CPU below NX=56 and on the card at NX=56, within 1e-13 (f64) or 1e-5
    (f32) of the largest value, and bit-identical on a rerun.  At NX=56
    the kernel and the einsum chain it replaces are timed in turns, with
    the bound (bytes over 3.35 TB/s or the dense operations over the f64
    or f32 peak), the kernel's registers and spills, and each call's peak
    memory."""
    from fembench.harness.roofline import C3D4_EVAL_FLOPS
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.kernels import newton_element as k_ne
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
    from femcy_tpu_torch.structured import (
        build_structured_plan,
        newton_element_plain,
    )

    mat = LinearIsotropic(1000.0, 0.3)
    for dims in (SMALL,) + M5_EDGE_BOXES + (FULL,):
        mesh = box_tets(*dims)
        plan = build_structured_plan(mesh, build_structured_dia_pattern(mesh))
        u_np = (np.random.default_rng(20).standard_normal(mesh.n_dof)
                * 0.05 / max(dims))
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]

            def dev(a, dt=dtype):
                return torch.as_tensor(np.asarray(a), dtype=dt, device=DEVICE)

            nodes, u = dev(mesh.nodes), dev(u_np)
            dsdX0, _ = assembly.gradients_and_volume(
                nodes, dev(mesh.elements, torch.int64),
                dev(mesh.element.dshape_at_gp),
                dev(mesh.element.gauss_weights))
            args = (nodes, u, dsdX0, mat, plan, mesh)
            got = k_ne.evaluate(*args)
            if dims == FULL:
                want = newton_element_plain(nodes, u, dsdX0, mat, mesh)
            else:
                want = newton_element_plain(nodes.cpu(), u.cpu(),
                                            dsdX0.cpu(), mat, mesh)
            rels = []
            for what, g, w in zip(("planes", "f_elem", "vol"), got, want):
                w = w.to(DEVICE)
                check(g.shape == w.shape, f"M9 {dims} {name}: {what} shape")
                rel = float((g - w).abs().max() / w.abs().max())
                rels.append(rel)
                check(rel <= M9_TOL[name],
                      f"M9 {dims} {name}: {what} {rel:.3e} from the plain "
                      "version")
            again = k_ne.evaluate(*args)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"M9 {dims} {name}: rerun not bit-identical")
            print(f"newton element kernel {dims} {name}: M9 against the "
                  f"plain version ({'card' if dims == FULL else 'CPU'}): "
                  f"planes {rels[0]:.3e}, f_elem {rels[1]:.3e}, vol "
                  f"{rels[2]:.3e} of the largest value; bit-identical rerun",
                  flush=True)
            del got, want, again
            if dims != FULL:
                continue
            torch.cuda.empty_cache()
            peaks = []
            for fn in (lambda: newton_element_plain(nodes, u, dsdX0, mat,
                                                    mesh),
                       lambda: k_ne.evaluate(*args)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = fn()
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated() - base)
                del out
            ms, pms, _ = in_turns(
                lambda: newton_element_plain(nodes, u, dsdX0, mat, mesh),
                lambda: k_ne.evaluate(*args), 3, 20)
            E, n_nodes = mesh.n_elements, mesh.n_nodes
            item = nodes.element_size()
            # written: the planes, f_elem, vol; read: dsdX0, nodes and u
            n_bytes = (6 * 144 * (E // 6) + 12 * E + E + 12 * E
                       + 6 * n_nodes) * item
            b = bound(n_bytes, E * C3D4_EVAL_FLOPS, name)
            attrs = k_ne.kernel_attributes(dtype)
            print(f"timing box_tets{dims} {name} on {card}: M9 "
                  f"newton_element kernel {ms:.4f} ms, the einsum chain "
                  f"(plain version) {pms:.4f} ms, bound {b[0]:.4f} ms "
                  f"({b[1]}; {n_bytes / 1e6:.0f} MB), share "
                  f"{100.0 * b[0] / ms:.1f}%; {attrs['registers']} registers "
                  f"and {attrs['local_bytes']} local bytes a thread; peak "
                  f"memory above the inputs: plain {peaks[0] / 1e9:.3f} GB, "
                  f"M9 {peaks[1] / 1e9:.3f} GB", flush=True)
            results[name]["newton_element"] = row(max(rels), ms, pms, None, b)
            del nodes, u, dsdX0, args
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


def slice_run(torch, card, full_ref, preconditioner: str, keep=None):
    """Phases 5 and 6: the path through FEMSystem with ``preconditioner``.
    Returns its launch counts and CG iterations; with ``keep``, stores the
    solution there (numpy, "dof")."""
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
    if keep is not None:
        keep["dof"] = system.dof.cpu().numpy()

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
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain
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
            y_p = ell_spmv_plain(vals, colidx, x)
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
                    lambda: ell_spmv_plain(vals, colidx, x),
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


def plan_to(torch, plan, device):
    """A copy of a kernel's plan (M1's and M4's, M6's) with every tensor on
    ``device``."""
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).to(device)
        for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def m4_against_cpu_plain(torch, f_e, plan, what: str):
    """M4 on the card, checked bit for bit against its plain version run
    on the CPU on the same element forces and against its own rerun.
    Returns (forces, max abs difference to the CPU plain version)."""
    from femcy_tpu_torch.kernels import internal_force as k_force

    f_k = k_force.scatter_force(f_e, plan)
    ref = k_force.scatter_force_plain(f_e.cpu(), plan_to(torch, plan, "cpu"))
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
    ref = k_scat.scatter_plain(Ke.cpu(), plan_to(torch, plan, "cpu"))
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


def general_slice_run(torch, card, mesh, layout: str, host_K, keep=None):
    """Phases 8 and 9: ``mesh`` through FEMSystem with the default config
    on the card, which must pick ``layout``.  Returns the launch counts and
    CG iterations; with a ``keep`` dict, its "dof" is the solution."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic
    from femcy_tpu_torch.kernels import ell_scatter as k_scat
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain
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
            return ell_spmv_plain(v, colidx, x)
    check(err <= TOL["float64"], f"assembled operator vs host f64: {err:.3e}")
    del values, v_np
    res, bmax, ux_err = solution_checks(torch, system, mesh, plain_spmv)
    # the layout's SpMV kernel (P1 on DIA, M2 on ELL) on this slice's own
    # eliminated operator, against its plain version
    values_bc, rhs_bc, _ = system._linear_system(
        torch.zeros_like(system.dof), *system._last_dirichlet)
    prep, apply_fn = system._spmv
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(mesh.n_dof),
                        dtype=values_bc.dtype, device=DEVICE)
    y_p = plain_spmv(values_bc, x)
    err_spmv = float((apply_fn(prep(values_bc), x) - y_p).abs().max()
                     / y_p.abs().max())
    check(err_spmv <= TOL["float64"],
          f"{spmv_kernel} vs plain on the slice's operator: {err_spmv:.3e}")
    if keep is not None and layout == "ell":
        # phase 39's operator and mesh data, held on the host meanwhile
        a = system._arrs
        keep["operator"] = dict(
            values=values_bc.cpu(), rhs=rhs_bc.cpu(),
            colidx=a["colidx"].cpu(), diag_slot=a["diag_slot"].cpu(),
            elements=a["elements"].cpu(), dsdx=a["dsdX0"].cpu(),
            vol=a["vol0"].cpu(),
            plan=plan_to(torch, system._scatter_plan, "cpu"),
            cg_eps=system.config.cg_eps,
            cg_max_iters=system.config.cg_max_iters)
    del values_bc, rhs_bc, x, y_p
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
    if keep is not None:
        keep["dof"] = system.dof.cpu().numpy()
    del system
    torch.cuda.empty_cache()
    return launches, iters


def inp_text(mesh, etype: str = "C3D4",
             top=("top, 1, 1, 0.01",), pressure: float | None = 2.0,
             nlgeom: bool = False, static: str = "1., 1., 1e-05, 1.") -> str:
    """``mesh`` as an Abaqus .inp of element type ``etype``: z=0 clamped,
    the ``top`` *Boundary lines on the z=max node set (ux=0.01 by
    default), and unless ``pressure`` is None a pressure on the x=max face
    through a *Surface of per-face-number element sets.  Written with
    numpy, a few seconds at 1M elements."""
    import io

    x = mesh.nodes[:, 0]
    buf = io.StringIO()
    buf.write("*Heading\nchip_smoke general mesh\n*Node\n")
    ids = np.arange(1, mesh.n_nodes + 1)[:, None]
    np.savetxt(buf, np.hstack([ids, mesh.nodes]),
               fmt=["%d"] + ["%.17g"] * mesh.nodes.shape[1], delimiter=", ")
    buf.write(f"*Element, type={etype}\n")
    conn = mesh.elements.astype(np.int64) + 1
    np.savetxt(buf, np.hstack([np.arange(1, mesh.n_elements + 1)[:, None],
                               conn]), fmt="%d", delimiter=", ")
    lines = []
    bottom, top_nodes = z_faces(mesh)
    for name, nodes in (("bot", bottom), ("top", top_nodes)):
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in nodes)]
    load = []
    if pressure is not None:
        faces = {}
        for k, facets in enumerate(mesh.element.inp_surface_num):
            local = [ln for f in facets for ln in f]
            on = (x[mesh.elements[:, local]] > x.max() - 1e-9).all(axis=1)
            if on.any():
                faces[k + 1] = np.nonzero(on)[0] + 1
        for k, eles in faces.items():
            lines += [f"*Elset, elset=_x{k}, internal, instance=a",
                      ", ".join(str(e) for e in eles)]
        lines.append("*Surface, type=ELEMENT, name=xload")
        lines += [f"_x{k}, S{k}" for k in faces]
        load = ["*Dsload", f"xload, P, {pressure!r}"]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              f"*Step, name=s, nlgeom={'YES' if nlgeom else 'NO'}",
              "*Static", static, "*Boundary", "bot, 1, 1", "bot, 2, 2",
              "bot, 3, 3", *top, *load, "*End Step"]
    buf.write("\n".join(lines) + "\n")
    return buf.getvalue()


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
               tangent: str, warm: bool, keep=None):
    """Phases 11-13: one geometric-nonlinear twist of ``mesh`` through
    FEMSystem.solve on the card, every launch counter zeroed just before
    and read just after.  Checks: success, the history against
    EXPECTED_NEWTON, the force kernel ``force`` (M5 or M4) and the tangent
    kernel ``tangent`` (P2 or M1) launched once per Newton evaluation, and
    with M5 and P2 (the box's secant + Kg route) the Newton element kernel
    M9 too, no kernel of another path, the f64 host residual (``internal_force_host``,
    BC rows zeroed) at the final dof within 1e-8 of the device's last
    reported residual (the rms, and the vector of a fresh evaluation),
    finite output of the expected shapes.  With ``warm``, a second solve
    must repeat the history.  With ``keep``, stores the final dof (numpy,
    "dof") and energy ("energy") there.  Returns (launches, history)."""
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

    builds = []
    if config.get("preconditioner") == "amg":
        # count hierarchy builds: one for the whole solve while the mask
        # holds
        ensure = system._ensure_amg

        def counted(fixed, values=None):
            before = system._amg
            ensure(fixed, values)
            builds.append(system._amg is not before)

        system._ensure_amg = counted

    def one_solve():
        n_rec, n_cg = len(system.timer.records), len(system._cg_iters_log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = system.solve(inp, user_dirichlet=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs = system.timer.records[n_rec:]
        split = {k: sum(r.seconds for r in recs if r.name == k)
                 for k in ("newton_eval", "linear_solve", "fused_step")}
        # a fused step is an evaluation and its CG
        evals = sum(r.name in ("newton_eval", "fused_step") for r in recs)
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
          f"{split['linear_solve']:.3f} s, fused_step "
          f"{split['fused_step']:.3f} s), {evals} evaluations, history "
          f"{history}, CG iterations per solve {cg}, peak memory "
          f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
    check(report.success, f"{label}: {report.message}")
    want = EXPECTED_NEWTON[label]
    check(history == want, f"{label}: history {history}, {want} expected")
    check(launches[force] == evals and launches[tangent] == evals,
          f"{label}: {force} launched {launches[force]} and {tangent} "
          f"{launches[tangent]} times for {evals} evaluations")
    # the box's secant + Kg route makes its element work in M9
    element = ("newton_element"
               if (force, tangent) == ("structured_force",
                                       "structured_accumulate") else None)
    check(element is None or launches[element] == evals,
          f"{label}: M9 launched {launches['newton_element']} times for "
          f"{evals} evaluations")
    if not cg:
        spmv = None
    elif builds:
        spmv = "bell_spmv"
        check(sum(builds) == 1 and len(builds) == len(cg),
              f"{label}: {sum(builds)} hierarchy builds for {len(cg)} solves")
    else:
        spmv = "dia_spmv" if system.dia is not None else "ell_spmv"
    for name, n in launches.items():
        if name not in (force, tangent, spmv, element):
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
    stab = config.get("stabilize_factor", 0.0) > 0.0
    e_stab = report.stabilization_energy
    check(not stab or (np.isfinite(e_stab) and e_stab > 0.0),
          f"{label}: stabilization energy {e_stab}")

    # the f64 host residual at the final dof against the device's, with
    # the viscous force of the last increment when stabilized
    fixed_d, sval_d = system._last_dirichlet
    fixed = fixed_d.cpu().numpy()
    t = time.perf_counter()
    r_host = internal_force_host(mesh, mat, system.dof.cpu().numpy())
    host_s = time.perf_counter() - t
    if stab:
        r_host += (system._stab_scale * system._stab_diag
                   * (system.dof - system._stab_ref)).cpu().numpy()
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
          f"{energy:.6g}" + (f", stabilization energy {e_stab:.6e}"
                             if stab else ""), flush=True)
    del r_dev, strain, stress, mises
    if keep is not None:
        keep["dof"], keep["energy"] = system.dof.cpu().numpy(), energy
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


class _StageWalls:
    """Collects the CLI's "stage <name>: <s> s" log records (its INFO
    records on the femcy_tpu_torch.cli logger) while installed."""

    def __init__(self):
        import logging

        self.walls = {}
        self._log = logging.getLogger("femcy_tpu_torch.cli")
        self._handler = logging.Handler(logging.INFO)
        self._handler.emit = self._emit

    def _emit(self, record):
        if record.msg.startswith("stage "):
            self.walls[record.args[0]] = record.args[1]

    def __enter__(self):
        import logging

        self._level = self._log.level
        self._log.setLevel(logging.INFO)
        self._log.addHandler(self._handler)
        return self.walls

    def __exit__(self, *exc):
        self._log.removeHandler(self._handler)
        self._log.setLevel(self._level)


def run_cli(argv):
    """``femcy_tpu_torch.cli.main(argv)`` in this process, every launch
    counter zeroed just before and read just after.  Returns (rc, stdout,
    launches, stage walls, wall)."""
    import contextlib
    import io

    import torch

    from femcy_tpu_torch import cli

    out = io.StringIO()
    zero_launches()
    t = time.perf_counter()
    with _StageWalls() as walls, contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return rc, out.getvalue(), read_launches(), walls, wall


def cli_linear_run(torch, card, label: str, mesh, etype: str, spmv: str,
                   trace: bool):
    """Phases 14 and 15: ``mesh`` written as an ``etype`` .inp (the
    boundary model of ``inp_text``) and run through the CLI on the card
    with ``--stress 2 --save-vtk --save-html`` (with ``trace``, inside
    ``device_trace``).  Checks: rc 0, M1 launched once and the layout's
    SpMV ``spmv`` once per CG iteration, no other kernel; the printed lines
    equal to those formatted from a FEMSystem built here from a
    ``read_inp`` of the same file (the kernels are bit-reproducible); the
    VTK header counts and cell types, its displacement block's largest
    |value| equal to the printed max |dof|; the HTML's triangle count
    equal to the mesh's surface triangles; with ``trace``, a Chrome trace
    that names P1's kernel.  Returns (launches, CG iterations)."""
    import json as _json
    import re
    import tempfile

    from femcy_tpu_torch import (
        FEMesh,
        FEMSystem,
        SolverConfig,
        material_from_inp,
        read_inp,
    )
    from femcy_tpu_torch.io.export import _VTK_CELL
    from femcy_tpu_torch.utils.timing import device_trace

    with tempfile.TemporaryDirectory() as tmp:
        path, vtk, html = f"{tmp}/model.inp", f"{tmp}/out.vtk", f"{tmp}/out.html"
        t = time.perf_counter()
        with open(path, "w") as f:
            f.write(inp_text(mesh, etype))
        write_s = time.perf_counter() - t
        argv = [path, "--stress", "2", "--save-vtk", vtk, "--save-html", html]
        trace_dir = f"{tmp}/trace" if trace else None
        with device_trace(trace_dir):
            rc, out, launches, walls, cli_s = run_cli(argv)
        check(rc == 0, f"{label}: exit code {rc}")
        print(f"{label}: {mesh.n_elements} {etype}, {mesh.n_dof} dofs; "
              f"stdout of the CLI:\n{out}", end="", flush=True)

        # the same model through FEMSystem, formatted as the CLI formats it
        t = time.perf_counter()
        inp = read_inp(path)
        read_s = time.perf_counter() - t
        mat = material_from_inp(inp.material_type, inp.material_params,
                                inp.element_type)
        mesh_r = FEMesh(inp.nodes, inp.elements, inp.element)
        system = FEMSystem(mesh_r, mat, inp.geometric_nonlinear,
                           SolverConfig(), device=DEVICE)
        check((system.dia is not None) == (spmv == "dia_spmv"),
              f"{label}: layout")
        report = system.solve(inp)
        check(report.success, f"{label}: direct FEMSystem solve")
        iters = system._last_cg_iters
        energy = system.elastic_energy()
        _, stress, mises = system.compute_strain_stress()
        comp = stress[:, :, 2, 2]
        want = [
            f"model: {mesh_r.n_elements} {etype} elements, {mesh_r.n_nodes} "
            f"nodes, {mesh_r.n_dof} dofs, geometric_nonlinear=False",
            f"total elastic energy = {energy:.6g}",
            "max Mises stress at integration points = "
            f"{float(mises.max()):.6g}",
            "max nodal (extrapolated) Mises stress = "
            f"{float(system.extrapolate(mises).max()):.6g}",
            f"max |dof| (displacement) = {float(system.dof.abs().max()):.6g}",
            "max |stress[22]| at integration points = "
            f"{float(comp.abs().max()):.6g}",
            f"max nodal stress[22] = {float(system.extrapolate(comp).max()):.6g}",
        ]
        del stress, mises, comp, system
        torch.cuda.empty_cache()
        got = [ln for ln in out.splitlines()
               if ln.startswith("model:") or " = " in ln]
        check(got == want, f"{label}: CLI printed {got}, FEMSystem gives {want}")
        check(launches["ell_scatter"] == 1 and launches[spmv] == iters > 0,
              f"{label}: launches {launches} for {iters} CG iterations")
        for name, n in launches.items():
            if name not in ("ell_scatter", spmv):
                check(n == 0, f"{label}: {name} launched {n} times")

        # the files
        E, N = mesh_r.n_elements, mesh_r.n_nodes
        npe = mesh_r.element.n_nodes
        with open(vtk) as f:
            text = f.read()
        vtk_mb = len(text) / 1e6
        check(f"\nPOINTS {N} double\n" in text, f"{label}: VTK POINTS")
        check(f"\nCELLS {E} {E * (npe + 1)}\n" in text, f"{label}: VTK CELLS")
        types = text.split(f"CELL_TYPES {E}\n")[1].split("\n", E)[:E]
        check(set(types) == {str(_VTK_CELL[mesh_r.element.name])},
              f"{label}: VTK cell types {set(types)}")
        disp = text.split("VECTORS displacement double\n")[1].split("\n", N)[:N]
        vmax = float(np.abs(np.array(" ".join(disp).split(), float)).max())
        del text, types, disp
        printed = float(want[4].split(" = ")[1])
        check(abs(vmax - printed) <= 5e-6 * printed,
              f"{label}: VTK max |displacement| {vmax!r}, printed {printed!r}")
        with open(html) as f:
            payload = _json.loads(re.search(r"const D=(\{.*?\});",
                                            f.read()).group(1))
        n_tri = len(payload["tri"]) // 3
        del payload
        check(n_tri == mesh_r.surface_triangles[0].shape[0],
              f"{label}: HTML triangles {n_tri}")
        trace_note = ""
        if trace:
            files = sorted(pathlib.Path(trace_dir).iterdir())
            check(len(files) == 1, f"{label}: trace files {files}")
            trace_text = files[0].read_text()
            check("dia_spmv_kernel" in trace_text,
                  f"{label}: the trace does not name dia_spmv_kernel")
            trace_note = (f"; device trace {len(trace_text) / 1e6:.1f} MB, "
                          "names dia_spmv_kernel")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"{label} on {card}: rc 0, observables equal to FEMSystem's, CG "
          f"{iters} iterations, launches M1 {launches['ell_scatter']} "
          f"{spmv} {launches[spmv]}; walls: write .inp {write_s:.3f} s, CLI "
          f"{cli_s:.3f} s ({stages}); read_inp alone {read_s:.3f} s; VTK "
          f"{vtk_mb:.1f} MB, POINTS {N}, CELLS {E}, max |displacement| "
          f"{vmax:.9g}; HTML {n_tri} triangles{trace_note}", flush=True)
    return launches, iters


def cli_nonlinear_run(torch, card, label: str, extra):
    """Phase 16: the geometric-nonlinear .inp model (``NL_NX``: z=0
    clamped, uz ``NL_UZ`` on z=1 in ``NL_STATIC``'s increments) through
    the CLI on the card with ``extra`` flags.  Checks: rc 0, converged in
    the pinned number of increments (``EXPECTED_CLI_INCREMENTS``), M4 and
    M1 launched equally often and at least once per increment, no other
    kernel (the solves are direct).  Returns (launches, increments)."""
    import re
    import tempfile

    from femcy_tpu_torch.meshgen import unstructured_box_tets

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/nonlinear.inp"
        with open(path, "w") as f:
            f.write(inp_text(unstructured_box_tets(NL_NX),
                             top=(f"top, 3, 3, {NL_UZ!r}",), pressure=None,
                             nlgeom=True, static=NL_STATIC))
        rc, out, launches, walls, wall = run_cli([path, *extra])
    print(f"{label}: stdout of the CLI:\n{out}", end="", flush=True)
    check(rc == 0, f"{label}: exit code {rc}")
    solve = re.search(r"solve: converged in (\d+) increment", out)
    n_inc = int(solve.group(1)) if solve else -1
    want = EXPECTED_CLI_INCREMENTS[label]
    check(n_inc == want, f"{label}: {n_inc} increments, {want} expected")
    check(launches["internal_force"] == launches["ell_scatter"] >= n_inc,
          f"{label}: M4 {launches['internal_force']}, M1 "
          f"{launches['ell_scatter']}")
    for name, n in launches.items():
        if name not in ("internal_force", "ell_scatter"):
            check(n == 0, f"{label}: {name} launched {n} times")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"{label} on {card}: {n_inc} increments, M4 = M1 = "
          f"{launches['internal_force']} evaluations; CLI {wall:.3f} s "
          f"({stages})", flush=True)
    return launches, n_inc


# --------------------------------------------------------------------------- #
# the algebraic multigrid (phases 10b, 13 and 14b)
# --------------------------------------------------------------------------- #
def cycle_launches(amg) -> int:
    """M3 launches of one V-cycle: per non-coarsest level two smoothings
    of ``smooth_steps`` applies, one residual, R and P; at an oversized
    coarsest level 4 * smooth_steps applies of smoothing."""
    s = amg.smooth_steps
    return ((2 * s + 3) * (amg.n_levels - 1)
            + (4 * s if amg._coarse_smooth_only else 0))


def device_profile(torch, fn):
    """(wall s, device busy ms, device events) of ``fn()`` under
    torch.profiler, synchronised; busy time is the union of the CUDA
    events' intervals."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    intervals = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in intervals:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return wall, busy_us / 1e3, len(intervals)


def bell_operands(system, values_bc):
    """(label, BellOperand) of every M3 operand of the system's AMG: the
    fine level from the eliminated operator, then each level's A, P, R."""
    from femcy_tpu_torch.kernels import bell_spmv as k_bell

    ops = [("fine", k_bell.from_ell(system._bell_fine, values_bc))]
    for li, lv in enumerate(system._amg.levels):
        for what, op in (("A", lv.A), ("P", lv.P), ("R", lv.R)):
            if op is not None:
                ops.append((f"{what}{li}", op))
    return ops


def bell_checks(torch, label: str, system, values_bc, timed=False) -> list:
    """M3 on every operand of ``system``'s hierarchy, with float32 and
    float64 vectors (the fine level in the vector's type, the hierarchy in
    bf16), against the plain ``bell_spmv`` run on the CPU on the same
    tensors (the fine level through ``bell_from_ell``), and bit-identical
    on a rerun; with ``timed``, each operand's float64 kernel time.
    Returns the shapes checked."""
    from femcy_tpu_torch.kernels import bell_spmv as k_bell
    from femcy_tpu_torch.solvers.bell import bell_from_ell, bell_spmv

    shapes = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for what, op in bell_operands(system, values_bc.to(dtype)):
            rng = np.random.default_rng(len(shapes))
            x = torch.as_tensor(rng.standard_normal(op.n_cols * op.bc),
                                dtype=dtype, device=DEVICE)
            y = k_bell.spmv(op, x)
            y2 = k_bell.spmv(op, x)
            torch.cuda.synchronize()
            check(torch.equal(y, y2), f"M3 {label} {what} {name}: rerun "
                  "not bit-identical")
            if what == "fine":
                bv = bell_from_ell(values_bc.to(dtype).cpu(), system._bell_plan)
            else:
                bv = op.bvalues.cpu()
            y_p = bell_spmv(bv, op.ncol.cpu(), x.cpu())
            rel = float((y.cpu() - y_p).abs().max() / y_p.abs().max())
            check(rel <= tol, f"M3 {label} {what} {name}: {rel:.3e} vs plain")
            shape = (op.n_blocks, op.values_t.shape[0], op.br, op.bc,
                     str(op.values_t.dtype).split(".")[1], name)
            if timed and dtype == torch.float64:
                ms = cuda_ms(lambda: k_bell.spmv(op, x), 20)
                shape += (f"{ms:.4f} ms",)
            shapes.append((what, shape, rel))
    print(f"M3 kernel checks, {label}: " + "; ".join(
        f"{what} {shape} rel {rel:.2e}" for what, shape, rel in shapes)
        + " (tol 1e-5 in float32, 1e-12 in float64, bit-identical reruns)",
        flush=True)
    return shapes


def bell_fine_timing(torch, card, system, values_bc):
    """M3 at the fine level of the AMG slice, float64, timed in turns with
    its plain version (on the bell_from_ell blocks) and cuSPARSE's CSR
    matvec of the valid slots, M2 on the same eliminated operator timed
    before and after them.  Returns the kernel table's row."""
    from femcy_tpu_torch.kernels import bell_spmv as k_bell
    from femcy_tpu_torch.kernels import ell_spmv as k_ell
    from femcy_tpu_torch.solvers.bell import bell_from_ell, bell_spmv

    plan = system._bell_plan
    op = k_bell.from_ell(system._bell_fine, values_bc)
    bv = bell_from_ell(values_bc, plan)
    ncol = op.ncol
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(op.n_cols * op.bc),
                        dtype=values_bc.dtype, device=DEVICE)
    y_k = k_bell.spmv(op, x)
    y_p = bell_spmv(bv, ncol, x)
    abs3 = float((y_k - y_p).abs().max())
    n, W = values_bc.shape
    splan = k_ell.spmv_plan(system.pattern, DEVICE)
    vt = k_ell.prep_values(splan, values_bc)
    colidx = system._arrs["colidx"]
    keep = torch.arange(W, device=DEVICE)[None] < splan.row_counts[:, None]
    lib = csr_matvec(keep, colidx, values_bc)
    del keep
    check(float((lib(x) - y_p).abs().max()) <= TOL["float64"] * float(
        y_p.abs().max()), "M3's CSR yardstick disagrees")
    check(float((k_ell.spmv(splan, vt, x) - y_p).abs().max())
          <= TOL["float64"] * float(y_p.abs().max()), "M2 vs M3 disagree")
    m2a = cuda_ms(lambda: k_ell.spmv(splan, vt, x), 50)
    ms, pms, lms = in_turns(lambda: bell_spmv(bv, ncol, x),
                            lambda: k_bell.spmv(op, x), 5, 50, lambda: lib(x))
    m2b = cuda_ms(lambda: k_ell.spmv(splan, vt, x), 50)
    blocks = int(plan.valid.sum())
    isz = values_bc.element_size()
    b3 = bound(blocks * (op.br * op.bc * isz + 4) + op.n_blocks * 4
               + op.n_cols * op.bc * isz + n * isz,
               2 * blocks * op.br * op.bc, "float64")
    print(f"timing M3 at the AMG slice's fine level (float64, {op.n_blocks} "
          f"block rows, K = {op.values_t.shape[0]}, {blocks} valid 3 x 3 "
          f"blocks) on {card}: bell_spmv kernel {ms:.4f} ms, plain (einsum "
          f"on the blocks) {pms:.4f} ms, CSR matvec (cuSPARSE) {lms:.4f} ms, "
          f"M2 ell_spmv on the same operator {m2a:.4f} / {m2b:.4f} ms, bound "
          f"{b3[0]:.4f} ms ({b3[1]}); M3 kernel vs plain abs err {abs3:.3e}",
          flush=True)
    return row(abs3, ms, pms, lms, b3)


def amg_slice_run(torch, card, mesh, jacobi_dof, results):
    """Phase 10b: FEMSystem(unstructured_box_tets(56), LinearIsotropic(1000,
    0.3), SolverConfig(preconditioner="amg", linear_solver="cg")) in
    float64 on the ELL slice's boundary model, every launch counter zeroed
    just before the solve and read just after.  Checks: success, M1 once,
    M3 as the V-cycle predicts, M2 and P1-P3 never, ||A x - b||_inf <=
    cg_eps * ||b||_inf with the plain ELL SpMV, the prescribed ux within
    the residual of its rows, finite output of the expected shapes.
    Prints the hierarchy beside femcy_tpu's recorded one, the setup split,
    the first and warm solve walls, one V-cycle and one PCG under the
    profiler, and the peak memory; then checks M3 on every operand of the
    hierarchy and times it at the fine level.  Returns the
    launch counts and CG iterations."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.kernels import bell_spmv as k_bell
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain

    t_phase = time.perf_counter()
    inp = boundary_model(mesh, 0.01)
    t = time.perf_counter()
    system = FEMSystem(mesh, LinearIsotropic(1000.0, 0.3), config=SolverConfig(
        preconditioner="amg", linear_solver="cg"), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    check(system.dtype == torch.float64, "default dtype is not float64")
    check(system.dia is None and system.pattern is not None,
          "the AMG slice is not on the ELL layout")

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    report = system.solve(inp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    strain, stress, mises = system.compute_strain_stress()
    energy = system.elastic_energy()
    nodal = system.extrapolate(mises)
    amg = system._amg
    iters = system._last_cg_iters
    timing = system.timer.summary()
    sizes = [lv.n_dof for lv in amg.levels]
    print(f"AMG slice: {mesh.n_elements} C3D4 elements, {mesh.n_dof} dofs, ELL "
          f"width {system.pattern.width}; hierarchy {sizes} dofs, complexity "
          f"{amg.complexity:.4f}, coarsest {'smoothed' if amg._coarse_smooth_only else 'dense inverse'} "
          "(femcy_tpu's recorded hierarchy at this size: 555579 / 42438 / "
          "2628 / 228, complexity 1.92, 18 AMG-PCG iterations)", flush=True)
    print(f"AMG slice setup on {card}: FEMSystem init {init_s:.3f} s "
          f"({system._init_seconds}); hierarchy host phases "
          f"{system._amg_host_seconds}; AlgebraicMultigrid setup "
          f"{amg.setup_seconds}", flush=True)
    print(f"AMG slice on {card}: first solve {first_s:.4f} s: assembly+bc "
          f"{timing['assemble+bc']['first']:.4f} s, hierarchy build + AMG-PCG "
          f"{iters} iterations {timing['linear_solve']['first']:.4f} s; peak "
          f"memory {peak / 1e9:.3f} GB; launches {launches}", flush=True)

    E = mesh.n_elements
    check(report.success, "AMG slice: solve reported failure")
    check(iters > 0, "AMG slice: the CG did not run")
    check(launches["ell_scatter"] == 1, f"AMG slice: M1 {launches}")
    expect = (iters + 1) * cycle_launches(amg) + iters
    check(launches["bell_spmv"] == expect,
          f"AMG slice: M3 launched {launches['bell_spmv']} times, the "
          f"{amg.n_levels}-level cycle predicts {expect} for {iters} "
          "iterations")
    for name in ("ell_spmv", "dia_spmv", "structured_accumulate",
                 "structured_fused", "internal_force", "structured_force"):
        check(launches[name] == 0, f"AMG slice: {name} launched")
    check(tuple(system.dof.shape) == (mesh.n_dof,), "dof shape")
    for what, t_, shape in (("strain", strain, (E, 1, 3, 3)),
                            ("stress", stress, (E, 1, 3, 3)),
                            ("mises", mises, (E, 1)), ("nodal", nodal, (E, 4)),
                            ("dof", system.dof, (mesh.n_dof,))):
        check(tuple(t_.shape) == shape, f"AMG slice: {what} shape")
        check(bool(torch.isfinite(t_).all()), f"AMG slice: {what} not finite")
    check(np.isfinite(energy) and energy > 0.0, f"energy {energy}")
    del strain, stress, nodal
    colidx = system._arrs["colidx"]
    res, bmax, ux_err = solution_checks(
        torch, system, mesh, lambda v, x: ell_spmv_plain(v, colidx, x))
    dof = system.dof.cpu().numpy()
    jac = float(np.abs(dof - jacobi_dof).max() / np.abs(jacobi_dof).max())
    print(f"AMG slice checks: ||Ax-b||_inf/||b||_inf {res / bmax:.3e} (cg_eps "
          f"{system.config.cg_eps}), prescribed ux off by {ux_err:.3e}, max "
          f"mises {float(mises.max()):.6g}, energy {energy:.6g}; largest "
          f"difference from the ELL slice's Jacobi x {jac:.3e} of max|x| "
          "(both stop at cg_eps 1e-3; not gated)", flush=True)
    del mises

    t = time.perf_counter()
    system.solve(inp)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    warm = system.timer.summary()
    check(system._amg is amg, "AMG slice: the warm solve rebuilt the hierarchy")
    check(system._last_cg_iters == iters, "AMG slice: warm solve iterations")
    print(f"AMG slice warm solve on {card}: {warm_s:.4f} s: assembly+bc "
          f"{warm['assemble+bc']['steady_min']:.4f} s, AMG-PCG {iters} "
          f"iterations {warm['linear_solve']['steady_min']:.4f} s (hierarchy "
          "kept)", flush=True)

    # one V-cycle and one PCG under the profiler
    values_bc, rhs_bc, _ = system._linear_system(
        torch.zeros_like(system.dof), *system._last_dirichlet)
    fine = k_bell.from_ell(system._bell_fine, values_bc)

    def apply0(v):
        return k_bell.spmv(fine, v)

    r = torch.as_tensor(np.random.default_rng(4).standard_normal(mesh.n_dof),
                        dtype=torch.float64, device=DEVICE)
    amg.precondition(r, apply0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        amg.precondition(r, apply0)
    torch.cuda.synchronize()
    cycle_s = (time.perf_counter() - t) / 5
    wall_c, busy_c, ev_c = device_profile(
        torch, lambda: amg.precondition(r, apply0))
    out = {}
    wall_p, busy_p, ev_p = device_profile(torch, lambda: out.setdefault(
        "pcg", amg.pcg_solve(rhs_bc, apply0, eps=system.config.cg_eps,
                             max_iters=mesh.n_dof)))
    check(out["pcg"][1] == iters, "AMG slice: profiled PCG iterations")
    print(f"AMG slice profile on {card}: one V-cycle {cycle_s * 1e3:.3f} ms of "
          f"wall ({wall_c * 1e3:.3f} ms under the profiler, device busy "
          f"{busy_c:.3f} ms, {busy_c / (wall_c * 1e3):.1%}, {ev_c} device "
          f"events, {cycle_launches(amg)} of them M3); one AMG-PCG of {iters} "
          f"iterations {wall_p * 1e3:.3f} ms under the profiler, device busy "
          f"{busy_p:.3f} ms ({busy_p / (wall_p * 1e3):.1%}), {ev_p} device "
          f"events, {ev_p / iters:.1f} per iteration", flush=True)
    del out, r

    t = time.perf_counter()
    bell_checks(torch, "AMG slice hierarchy", system, values_bc, timed=True)
    results["float64"]["bell_spmv"] = bell_fine_timing(
        torch, card, system, values_bc)
    print(f"AMG slice: M3 checks and timing {time.perf_counter() - t:.1f} s; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    del system, values_bc, fine, amg
    torch.cuda.empty_cache()
    return launches, iters


def amg_2d_checks(torch):
    """Phase 10b, 2-D: M3's 2-D blocks (2 x 2 fine, 2 x 3 P, 3 x 2 R, 3 x 3
    coarse) on the hierarchy of rect_tris(60, 40), x=0 clamped, built on
    the card through FEMSystem._ensure_amg."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropicPlaneStress, SolverConfig
    from femcy_tpu_torch.meshgen import rect_tris

    t = time.perf_counter()
    mesh = rect_tris(60, 40, 1.5, 1.0)
    fixed = np.zeros(mesh.n_dof, bool)
    left = np.nonzero(mesh.nodes[:, 0] < 1e-9)[0]
    fixed[left * 2] = fixed[left * 2 + 1] = True
    system = FEMSystem(mesh, LinearIsotropicPlaneStress(1000.0, 0.3),
                       config=SolverConfig(preconditioner="amg",
                                           linear_solver="cg"), device=DEVICE)
    fixed_d = torch.as_tensor(fixed, device=DEVICE)
    zeros = torch.zeros(mesh.n_dof, dtype=system.dtype, device=DEVICE)
    values_bc, _, _ = system._linear_system(zeros, fixed_d, zeros)
    system._ensure_amg(fixed_d, values=values_bc)
    check(system._amg.n_levels >= 2, "2-D hierarchy has one level")
    shapes = bell_checks(torch, f"rect_tris(60, 40), {mesh.n_dof} dofs",
                         system, values_bc)
    blocks = {(s[2], s[3]) for _, s, _ in shapes}
    check({(2, 2), (2, 3), (3, 2)} <= blocks, f"2-D block shapes {blocks}")
    print(f"M3 2-D checks: phase wall {time.perf_counter() - t:.1f} s",
          flush=True)


def cli_amg_run(torch, card):
    """Phase 14b: the .inp model of phase 10 through the CLI with
    ``--preconditioner amg --solver cg``.  Checks: rc 0; the printed model
    line and observables equal to the strings formatted from a FEMSystem
    built here from ``read_inp`` of the same file with the same config;
    M1 once, M3 launched, no M2 or P1-P3.  Returns (launches, CG
    iterations)."""
    import tempfile

    from femcy_tpu_torch import (
        FEMesh,
        FEMSystem,
        SolverConfig,
        material_from_inp,
        read_inp,
    )
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/amg.inp"
        with open(path, "w") as f:
            f.write(inp_text(unstructured_box_tets(INP_NX)))
        rc, out, launches, walls, cli_s = run_cli(
            [path, "--preconditioner", "amg", "--solver", "cg"])
        check(rc == 0, f"CLI, AMG: exit code {rc}")
        print(f"CLI, AMG: stdout of the CLI:\n{out}", end="", flush=True)
        inp = read_inp(path)
    mat = material_from_inp(inp.material_type, inp.material_params,
                            inp.element_type)
    mesh = FEMesh(inp.nodes, inp.elements, inp.element)
    system = FEMSystem(mesh, mat, inp.geometric_nonlinear, SolverConfig(
        preconditioner="amg", linear_solver="cg"), device=DEVICE)
    check(system.solve(inp).success, "CLI, AMG: FEMSystem solve")
    iters = system._last_cg_iters
    _, _, mises = system.compute_strain_stress()
    want = [
        f"model: {mesh.n_elements} C3D4 elements, {mesh.n_nodes} nodes, "
        f"{mesh.n_dof} dofs, geometric_nonlinear=False",
        f"total elastic energy = {system.elastic_energy():.6g}",
        f"max Mises stress at integration points = {float(mises.max()):.6g}",
        "max nodal (extrapolated) Mises stress = "
        f"{float(system.extrapolate(mises).max()):.6g}",
        f"max |dof| (displacement) = {float(system.dof.abs().max()):.6g}",
    ]
    got = [ln for ln in out.splitlines()
           if ln.startswith("model:") or " = " in ln]
    check(got == want, f"CLI, AMG: CLI printed {got}, FEMSystem gives {want}")
    check(launches["ell_scatter"] == 1 and launches["bell_spmv"] > 0,
          f"CLI, AMG: launches {launches}")
    for name, n in launches.items():
        if name not in ("ell_scatter", "bell_spmv"):
            check(n == 0, f"CLI, AMG: {name} launched {n} times")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"CLI, AMG on {card}: rc 0, observables equal to FEMSystem's, "
          f"AMG-PCG {iters} iterations, launches M1 {launches['ell_scatter']} "
          f"M3 {launches['bell_spmv']}; CLI {cli_s:.3f} s ({stages}); phase "
          f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    del system
    torch.cuda.empty_cache()
    return launches, iters


# --------------------------------------------------------------------------- #
# multi-block models and B31 beams (phases 18-21)
# --------------------------------------------------------------------------- #
def hex_wedge_box(n: int):
    """box_hexes(n, n, n)'s node grid: the cells with i < n // 2 as C3D8,
    the others split into two C3D6 each as box_wedges splits them (its
    first wedges, then its second ones), conforming on x = 0.5.  Returns
    (nodes, hexes, wedges)."""
    from femcy_tpu_torch.meshgen import box_hexes, box_wedges

    hexes, wedges = box_hexes(n, n, n), box_wedges(n, n, n)
    cells = n ** 3
    left = np.arange(cells) // (n * n) < n // 2
    w = wedges.elements
    return (hexes.nodes, hexes.elements[left],
            np.concatenate([w[:cells][~left], w[cells:][~left]]))


def hex_wedge_blocks(n: int):
    """(nodes, blocks) of the hex + wedge box: C3D8 LinearIsotropic(1000,
    0.3) and C3D6 NeoHookean(C1=192.3, D1=288.5), which linearises to the
    same E and nu (mu = 2 C1, lambda = 2 D1)."""
    from femcy_tpu_torch import ElementBlock, LinearIsotropic, NeoHookean
    from femcy_tpu_torch.elements import HEX8, WEDGE6

    nodes, hexes, wedges = hex_wedge_box(n)
    return nodes, [
        ElementBlock(hexes, HEX8, LinearIsotropic(1000.0, 0.3), "hexes"),
        ElementBlock(wedges, WEDGE6, NeoHookean(C1=MB_C1, D1=MB_D1),
                     "wedges")]


def two_material_blocks(mesh):
    """The elements of ``mesh`` in two blocks by centroid z: z < 0.5 soft
    LinearIsotropic(1000, 0.3), the rest stiff LinearIsotropic(4000, 0.3)."""
    from femcy_tpu_torch import ElementBlock, LinearIsotropic

    low = mesh.nodes[mesh.elements].mean(axis=1)[:, 2] < 0.5
    return [ElementBlock(mesh.elements[low], mesh.element,
                         LinearIsotropic(1000.0, 0.3), "soft"),
            ElementBlock(mesh.elements[~low], mesh.element,
                         LinearIsotropic(4000.0, 0.3), "stiff")]


def boundary_arrays(nodes):
    """(rhs, fixed, sval) of the slices' boundary model: z=0 clamped, ux =
    0.01 on z=1, no load."""
    bottom = np.nonzero(nodes[:, 2] < 1e-9)[0]
    top = np.nonzero(nodes[:, 2] > nodes[:, 2].max() - 1e-9)[0]
    n_dof = nodes.size
    fixed = np.zeros(n_dof, bool)
    sval = np.zeros(n_dof)
    fixed[bottom[:, None] * 3 + np.arange(3)] = True
    fixed[top * 3] = True
    sval[top * 3] = 0.01
    return np.zeros(n_dof), fixed, sval


def multiblock_kernel_checks(torch, system, label: str):
    """Each block's M1 output on the card bit for bit its plain version run
    on the CPU (rows the block does not touch among them: zero), and M4 on
    seeded element forces the same; the union operator (the blocks' M1
    outputs summed in block order) against the f64 host twin
    (``union_values_host``) within 1e-12 relative."""
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.multiblock import union_values_host

    values = None
    rng = np.random.default_rng(11)
    for bi, (blk, ba) in enumerate(zip(system.blocks, system._block_arrs)):
        Ke = assembly.element_stiffness(ba["dsdX0"], ba["vol0"], ba["C"])
        v, _ = m1_against_cpu_plain(torch, Ke, system._plans[bi],
                                    f"{label} block {bi}")
        del Ke
        values = v if values is None else values + v
        f_e = torch.as_tensor(rng.standard_normal(
            (blk.elements.shape[0], blk.element.n_nodes, 3)),
            dtype=torch.float64, device=DEVICE)
        m4_against_cpu_plain(torch, f_e, system._plans[bi],
                             f"{label} block {bi}")
    t = time.perf_counter()
    host = union_values_host(system.nodes, system.blocks,
                             system._block_targets, system.pattern)
    host_s = time.perf_counter() - t
    err = float(np.abs(values.cpu().numpy() - host).max() / np.abs(host).max())
    check(err <= TOL["float64"], f"{label}: union operator vs the f64 host "
          f"twin {err:.3e}")
    print(f"{label} kernel checks: M1 and M4 of each of the "
          f"{len(system.blocks)} blocks bit-equal to their CPU plain "
          f"versions, bit-identical reruns; union operator vs the f64 host "
          f"twin {err:.3e} (tol {TOL['float64']:.0e}; twin {host_s:.2f} s)",
          flush=True)


def m2_union_check(torch, system, values_bc, label: str):
    """M2 on the union pattern's eliminated operator, in float32 and
    float64, against the plain ``ell_spmv_plain`` run on the CPU on the same
    values, and bit-identical on a rerun."""
    from femcy_tpu_torch.kernels import ell_spmv as k_ell
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain

    splan = k_ell.spmv_plan(system.pattern, DEVICE)
    colidx = system._arrs["colidx"].cpu()
    x_np = np.random.default_rng(12).standard_normal(system.n_dof)
    rels = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        vals = values_bc.to(dtype)
        x = torch.as_tensor(x_np, dtype=dtype, device=DEVICE)
        vt = k_ell.prep_values(splan, vals)
        y = k_ell.spmv(splan, vt, x)
        y2 = k_ell.spmv(splan, vt, x)
        torch.cuda.synchronize()
        check(torch.equal(y, y2), f"M2 {label} {name}: rerun not "
              "bit-identical")
        y_p = ell_spmv_plain(vals.cpu(), colidx, x.cpu())
        rel = float((y.cpu() - y_p).abs().max() / y_p.abs().max())
        check(rel <= TOL[name], f"M2 {label} {name}: {rel:.3e} vs plain")
        rels.append(f"{name} rel {rel:.2e}")
        del vals, vt
    print(f"M2 kernel checks, {label} (union ELL width "
          f"{system.pattern.width}): " + "; ".join(rels)
          + " vs the plain ell_spmv_plain on the CPU (tol 1e-5 in float32, "
          "1e-12 in float64), bit-identical reruns", flush=True)


def multiblock_solve(torch, card, system, label: str, bcs):
    """One linear solve of ``system`` on the card, every launch counter
    zeroed just before and read just after; checks success, M1 once per
    block, the solver's SpMV (M2 once per CG iteration, or M3 as the
    V-cycle predicts), no other kernel, ||A x - b||_inf <= cg_eps *
    ||b||_inf with the plain ELL SpMV, finite stresses, Mises and energy;
    then the solver's kernel against its plain version on this system's
    eliminated operator (M2 on the union pattern, or M3 on every operand
    of the hierarchy), and a warm solve with the same iterations.  Returns
    (launches, CG iterations)."""
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain

    rhs, fixed, sval = bcs
    amg = system.config.preconditioner == "amg"
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    system.solve(rhs, fixed, sval)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    iters = system._last_cg_iters
    n_blocks = len(system.blocks)
    check(iters > 0, f"{label}: the CG did not run")
    check(launches["ell_scatter"] == n_blocks,
          f"{label}: M1 launched {launches['ell_scatter']} times for "
          f"{n_blocks} blocks")
    spmv = "bell_spmv" if amg else "ell_spmv"
    want = ((iters + 1) * cycle_launches(system._amg) + iters) if amg else iters
    check(launches[spmv] == want, f"{label}: {spmv} launched "
          f"{launches[spmv]} times, {want} expected for {iters} iterations")
    for name, n in launches.items():
        if name not in ("ell_scatter", spmv):
            check(n == 0, f"{label}: {name} launched {n} times")
    fixed_t = torch.as_tensor(fixed, device=DEVICE)
    values_bc, b = system._linear_system(
        torch.as_tensor(rhs, device=DEVICE), fixed_t,
        torch.as_tensor(sval, device=DEVICE))
    res = float((ell_spmv_plain(values_bc, system._arrs["colidx"],
                                system.dof) - b).abs().max())
    bmax = float(b.abs().max())
    check(res <= system.config.cg_eps * bmax,
          f"{label}: ||Ax-b||_inf {res:.3e} > cg_eps*||b||_inf")
    if amg:
        bell_checks(torch, label, system, values_bc)
    else:
        m2_union_check(torch, system, values_bc, label)
    del values_bc, b
    max_mises = 0.0
    for bi, blk in enumerate(system.blocks):
        strain, stress, mises = system.block_stress(bi)
        nodal = system.extrapolate_block(bi, mises)
        E, G = blk.elements.shape[0], blk.element.n_gp
        for what, t_, shape in (("stress", stress, (E, G, 3, 3)),
                                ("mises", mises, (E, G)),
                                ("nodal", nodal, (E, blk.element.n_nodes))):
            check(tuple(t_.shape) == shape, f"{label}: block {bi} {what} shape")
            check(bool(torch.isfinite(t_).all()),
                  f"{label}: block {bi} {what} not finite")
        max_mises = max(max_mises, float(mises.max()))
        del strain, stress, mises, nodal
    energy = system.elastic_energy()
    check(np.isfinite(energy) and energy > 0.0, f"{label}: energy {energy}")
    first = system._amg
    t = time.perf_counter()
    system.solve(rhs, fixed, sval)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    check(system._last_cg_iters == iters, f"{label}: warm solve iterations")
    check(system._amg is first, f"{label}: the warm solve rebuilt the AMG")
    extra = ""
    if amg:
        extra = (f"; hierarchy {[lv.n_dof for lv in first.levels]} dofs, "
                 f"host phases {system._amg_host_seconds}, AlgebraicMultigrid "
                 f"setup {first.setup_seconds}")
    print(f"{label} on {card}: first solve {first_s:.4f} s, warm "
          f"{warm_s:.4f} s, {iters} CG iterations, ||Ax-b||_inf/||b||_inf "
          f"{res / bmax:.3e}, max mises {max_mises:.6g}, energy {energy:.6g}, "
          f"peak memory {peak / 1e9:.3f} GB; launches {launches}{extra}",
          flush=True)
    return launches, iters


def multiblock_setup(torch, card, label: str, nodes, blocks, **config):
    from femcy_tpu_torch import MultiBlockSystem, SolverConfig

    t = time.perf_counter()
    system = MultiBlockSystem(nodes, blocks, SolverConfig(**config),
                              device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    check(system.dtype == torch.float64, "default dtype is not float64")
    sizes = ", ".join(f"{b.elements.shape[0]} {b.element.name} [{b.name}]"
                      for b in system.blocks)
    print(f"{label}: {sizes}; {system.n_dof} dofs; union ELL width "
          f"{system.pattern.width} (node width {system.pattern.node_width}); "
          f"MultiBlockSystem init {init_s:.3f} s "
          f"({', '.join(f'{k} {v:.3f} s' for k, v in system._init_seconds.items())})",
          flush=True)
    return system


def assembly_ms(torch, system, bcs, reps: int = 5):
    """Median wall (ms, synchronised) of ``system``'s warm assembly + linear
    Dirichlet elimination, its M1 launches in one of them, and the peak
    memory (GB) that one assembly adds to what is allocated before it."""
    args = [torch.as_tensor(a, device=DEVICE) for a in bcs]
    system._linear_system(*args)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        system._linear_system(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out = system._linear_system(*args)
    torch.cuda.synchronize()
    m1 = read_launches()["ell_scatter"]
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(all(bool(torch.isfinite(t_).all()) for t_ in out),
          "many-block assembly not finite")
    del out
    return float(np.median(walls)), m1, peak


def many_block_timing(torch, card, mesh, two, bcs):
    """The cost of many sections: the ELL slice's mesh cut into
    ``MB_SLABS`` slabs by centroid z, one LinearIsotropic each (E from
    1000 to 4000), beside the two-block ``two`` on the same mesh and
    loads: setup, the warm assembly + Dirichlet wall, M1 launches (one a
    block, gated) and the memory an assembly adds."""
    from femcy_tpu_torch import ElementBlock, LinearIsotropic
    from femcy_tpu_torch import MultiBlockSystem, SolverConfig

    z = mesh.nodes[mesh.elements].mean(axis=1)[:, 2]
    slab = np.minimum((z * MB_SLABS).astype(np.int64), MB_SLABS - 1)
    blocks = [ElementBlock(mesh.elements[slab == i], mesh.element,
                           LinearIsotropic(1000.0 + 3000.0 * i / (MB_SLABS - 1),
                                           0.3), f"slab{i}")
              for i in range(MB_SLABS)]
    t = time.perf_counter()
    many = MultiBlockSystem(mesh.nodes, blocks, SolverConfig(
        linear_solver="cg"), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    check(np.array_equal(many.pattern.colidx, two.pattern.colidx),
          "the slabs' union pattern is not the two blocks' one")
    ms2, m1_2, peak2 = assembly_ms(torch, two, bcs)
    ms_n, m1_n, peak_n = assembly_ms(torch, many, bcs)
    check(m1_2 == 2 and m1_n == MB_SLABS, f"many blocks: M1 launched "
          f"{m1_2} and {m1_n} times for 2 and {MB_SLABS} blocks")
    print(f"many blocks on {card}: {MB_SLABS} slabs of {mesh.n_elements} "
          f"C3D4, MultiBlockSystem init {init_s:.3f} s "
          f"({', '.join(f'{k} {v:.3f} s' for k, v in many._init_seconds.items())}); "
          f"warm assembly+bc {ms_n:.3f} ms against {ms2:.3f} ms for 2 blocks "
          f"(median of 5; M1 {m1_n} and {m1_2} launches); memory an "
          f"assembly adds {peak_n:.3f} GB against {peak2:.3f} GB",
          flush=True)
    del many


def two_material_run(torch, card):
    """Phase 18: the ELL slice's mesh in two materials through
    MultiBlockSystem, Jacobi CG (M1 x 2 + M2), then on the same system
    preconditioner="amg" (M1 x 2 + M3, the hierarchy from the f64 host
    twin).  Returns {path: (launches, iterations)}."""
    from femcy_tpu_torch import SolverConfig
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    t_phase = time.perf_counter()
    mesh = unstructured_box_tets(UNSTRUCT[-1])
    system = multiblock_setup(torch, card, "two-material ELL", mesh.nodes,
                              two_material_blocks(mesh), linear_solver="cg")
    multiblock_kernel_checks(torch, system, "two-material ELL")
    bcs = boundary_arrays(mesh.nodes)
    out = {"two-material ELL": multiblock_solve(
        torch, card, system, "two-material ELL", bcs)}
    system.config = SolverConfig(linear_solver="cg", preconditioner="amg")
    out["two-material AMG"] = multiblock_solve(
        torch, card, system, "two-material AMG", bcs)
    system._amg = None
    many_block_timing(torch, card, mesh, system, bcs)
    del system
    torch.cuda.empty_cache()
    print(f"two-material phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def hex_wedge_run(torch, card):
    """Phase 19: the hex + wedge box (``MB_N``) through MultiBlockSystem:
    the linear solve (Jacobi CG, M1 for npe 8 and 6, M2), then the Newton
    twist of ``TWIST`` through solve_nonlinear.  Returns (linear
    (launches, iterations), Newton (launches, history))."""
    from femcy_tpu_torch.assembly_host import internal_force_host
    from femcy_tpu_torch.bc import build_dirichlet_arrays
    from femcy_tpu_torch.io.inp import DirichletBC
    from femcy_tpu_torch.mesh import FEMesh
    from femcy_tpu_torch.user import make_rotation_dirichlet

    t_phase = time.perf_counter()
    nodes, blocks = hex_wedge_blocks(MB_N)
    system = multiblock_setup(torch, card, "hex+wedge", nodes, blocks,
                              linear_solver="cg")
    multiblock_kernel_checks(torch, system, "hex+wedge")
    linear = multiblock_solve(torch, card, system, "hex+wedge",
                              boundary_arrays(nodes))

    label = "hex+wedge Newton"
    bottom = np.nonzero(nodes[:, 2] < 1e-9)[0]
    top = np.nonzero(nodes[:, 2] > 1 - 1e-9)[0]
    model = dataclasses.make_dataclass(
        "TwistModel", ["dirichlet_bcs", "neumann_bcs", "time_incs"])(
        [DirichletBC(bottom, d, 0.0) for d in range(3)]
        + [DirichletBC(top, d, 0.0, True) for d in range(3)], [], dict(TWIST))
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0))
    walls = {"eval": 0.0, "solve": 0.0, "evals": 0}
    evaluate, lin_solve = system._newton_eval, system._solve_values

    def timed(key, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - t0
            walls["evals"] += key == "eval"
            return out
        return run

    system._newton_eval = timed("eval", evaluate)
    system._solve_values = timed("solve", lin_solve)
    n_cg = len(system._cg_iters_log)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    report = system.solve_nonlinear(model, user_dirichlet=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    system._newton_eval, system._solve_values = evaluate, lin_solve
    history = [(r.newton_iters, r.converged) for r in report.increments]
    evals, cg = walls["evals"], system._cg_iters_log[n_cg:]
    print(f"{label} on {card}: {system.n_dof} dofs; solve {wall:.3f} s "
          f"(evaluations {walls['eval']:.3f} s, {evals} of them, "
          f"{walls['eval'] / max(evals, 1) * 1e3:.2f} ms each; linear solves "
          f"{walls['solve']:.3f} s), history {history}, CG iterations per "
          f"solve {cg}, peak memory {peak / 1e9:.3f} GB; launches {launches}",
          flush=True)
    check(report.success, f"{label}: {report.message}")
    want = EXPECTED_NEWTON[label]
    check(history == want, f"{label}: history {history}, {want} expected")
    n_blocks = len(blocks)
    check(launches["internal_force"] == launches["ell_scatter"]
          == n_blocks * evals > 0,
          f"{label}: M4 {launches['internal_force']} and M1 "
          f"{launches['ell_scatter']} for {evals} evaluations of {n_blocks} "
          "blocks")
    check(launches["ell_spmv"] == sum(cg) > 0, f"{label}: M2 {launches}")
    for name, n in launches.items():
        if name not in ("internal_force", "ell_scatter", "ell_spmv"):
            check(n == 0, f"{label}: {name} launched {n} times")
    # the f64 host residual (each block's internal_force_host, summed in
    # block order) at the final dof against the device's
    view = dataclasses.make_dataclass("View", ["n_dof", "dm", "nodes"])(
        system.n_dof, 3, nodes)
    fixed, sval = build_dirichlet_arrays(model.dirichlet_bcs, view,
                                         system.time1, 1.0, hook)
    dof = system.dof.cpu().numpy()
    t = time.perf_counter()
    r_host = sum(internal_force_host(FEMesh(nodes, b.elements, b.element),
                                     b.material, dof) for b in blocks)
    host_s = time.perf_counter() - t
    r_host[fixed] = 0.0
    rms_host = float(np.sqrt(np.mean(r_host * r_host)))
    rms_dev = report.increments[-1].residual
    rel_rms = abs(rms_dev - rms_host) / rms_host
    _, _, r_dev, _ = system._newton_eval(
        system.dof, torch.zeros_like(system.dof),
        torch.as_tensor(fixed, device=DEVICE),
        torch.as_tensor(sval, device=DEVICE))
    rel_vec = float(np.abs(r_dev.cpu().numpy() - r_host).max()
                    / np.abs(r_host).max())
    check(rel_rms <= 1e-8 and rel_vec <= 1e-8,
          f"{label}: device residual vs f64 host: rms {rel_rms:.3e}, vector "
          f"{rel_vec:.3e}")
    energy = system.elastic_energy()
    check(np.isfinite(energy) and energy > 0.0, f"{label}: energy {energy}")
    turned = float(np.abs(dof.reshape(-1, 3)[top]).max())
    print(f"{label} checks: last residual {rms_dev:.6e} (rms), f64 host "
          f"residual {rms_host:.6e} (rel {rel_rms:.3e}; vector rel "
          f"{rel_vec:.3e}; host {host_s:.2f} s), max top-face displacement "
          f"{turned:.6f}, energy {energy:.6g}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del system, r_dev
    torch.cuda.empty_cache()
    return linear, (launches, history)


def multiblock_inp_text(nodes, blocks, nlgeom: bool = False,
                        top=("top, 1, 1, 0.01",), pressure=2.0,
                        static: str = "1., 1., 1e-05, 1.") -> str:
    """Hex + wedge ``blocks`` over ``nodes`` as an Abaqus .inp: one
    ``*Element`` block and ``*Solid Section`` per block (the hexes linear
    elastic, the wedges ``*Hyperelastic, neo hooke``), z=0 clamped, the
    ``top`` *Boundary lines on the z=max node set and, unless ``pressure``
    is None, a pressure on the x=max faces through a *Surface of
    per-block, per-face-number element sets."""
    import io

    x = nodes[:, 0]
    buf = io.StringIO()
    buf.write("*Heading\nchip_smoke multi-block model\n*Node\n")
    np.savetxt(buf, np.hstack([np.arange(1, nodes.shape[0] + 1)[:, None],
                               nodes]),
               fmt=["%d"] + ["%.17g"] * 3, delimiter=", ")
    start, faces = 1, {}
    etypes = {"hex8": "C3D8", "wedge6": "C3D6"}
    for blk in blocks:
        E = blk.elements.shape[0]
        buf.write(f"*Element, type={etypes[blk.element.name]}, "
                  f"elset={blk.name}\n")
        np.savetxt(buf, np.hstack([np.arange(start, start + E)[:, None],
                                   blk.elements.astype(np.int64) + 1]),
                   fmt="%d", delimiter=", ")
        for k, facets in enumerate(blk.element.inp_surface_num):
            local = [ln for f in facets for ln in f]
            on = (x[blk.elements[:, local]] > x.max() - 1e-9).all(axis=1)
            if on.any():
                faces[f"_x{blk.name}{k + 1}", k + 1] = np.nonzero(on)[0] + start
        start += E
    lines = []
    z = nodes[:, 2]
    for name, sel in (("bot", z < 1e-9), ("top", z > z.max() - 1e-9)):
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in np.nonzero(sel)[0])]
    load = []
    if pressure is not None:
        for (name, _), eles in faces.items():
            lines += [f"*Elset, elset={name}, internal, instance=a",
                      ", ".join(str(e) for e in eles)]
        lines.append("*Surface, type=ELEMENT, name=xload")
        lines += [f"{name}, S{k}" for name, k in faces]
        load = ["*Dsload", f"xload, P, {pressure!r}"]
    lines += [f"*Solid Section, elset={blocks[0].name}, material=steel",
              f"*Solid Section, elset={blocks[1].name}, material=rubber",
              "*Material, name=steel", "*Elastic", "1000., 0.3",
              "*Material, name=rubber", "*Hyperelastic, neo hooke",
              f"{MB_C1!r}, {1.0 / MB_D1!r}",
              f"*Step, name=s, nlgeom={'YES' if nlgeom else 'NO'}",
              "*Static", static, "*Boundary", "bot, 1, 1", "bot, 2, 2",
              "bot, 3, 3", *top, *load, "*End Step"]
    buf.write("\n".join(lines) + "\n")
    return buf.getvalue()


def cli_multiblock_run(torch, card):
    """Phase 20: the hex + wedge box as a two-*Solid Section .inp with a
    *Dsload on x = 1 through the CLI on the card (``--stress 2 --save-vtk
    --save-html``): rc 0, M1 once per block and M2 once per CG iteration,
    no other kernel, the printed lines equal to those formatted from a
    ``system_from_model(read_inp_multi(...))`` solve, the VTK's mixed cell
    types and the HTML's triangles; then a small two-material nlgeom .inp,
    plain and with --stabilize (warned about and ignored: the same lines
    after the warning).  Returns {path: (launches, CG iterations or
    increments)}."""
    import json as _json
    import re
    import tempfile

    from femcy_tpu_torch import SolverConfig, read_inp_multi, system_from_model

    t_phase = time.perf_counter()
    nodes, blocks = hex_wedge_blocks(MB_N)
    out = {}
    label = "CLI, multi-block"
    with tempfile.TemporaryDirectory() as tmp:
        path, vtk, html = f"{tmp}/model.inp", f"{tmp}/out.vtk", f"{tmp}/out.html"
        with open(path, "w") as f:
            f.write(multiblock_inp_text(nodes, blocks))
        rc, text, launches, walls, cli_s = run_cli(
            [path, "--stress", "2", "--save-vtk", vtk, "--save-html", html])
        print(f"{label}: stdout of the CLI:\n{text}", end="", flush=True)
        check(rc == 0, f"{label}: exit code {rc}")
        model = read_inp_multi(path)
        system = system_from_model(model, SolverConfig(), device=DEVICE)
        system.solve_model(model)
        iters = system._last_cg_iters
        gp, nodal, comp, nodal_comp = [], [], [], []
        for bi in range(len(system.blocks)):
            _, stress, mises = system.block_stress(bi)
            gp.append(float(mises.max()))
            nodal.append(float(system.extrapolate_block(bi, mises).max()))
            c = stress[:, :, 2, 2]
            comp.append(float(c.abs().max()))
            nodal_comp.append(float(system.extrapolate_block(bi, c).max()))
            del stress, mises, c
        blocks_txt = ", ".join(
            f"{blk.elements.shape[0]} {etype}[{blk.name or bi}]"
            for bi, ((etype, _, _), blk) in enumerate(
                zip(model.element_blocks, system.blocks)))
        want = [
            f"model: {blocks_txt}; {model.nodes.shape[0]} nodes, "
            f"{system.n_dof} dofs, 2 material(s), geometric_nonlinear=False",
            f"total elastic energy = {system.elastic_energy():.6g}",
            f"max Mises stress at integration points = {max(gp):.6g}",
            f"max nodal (extrapolated) Mises stress = {max(nodal):.6g}",
            f"max |dof| (displacement) = {float(system.dof.abs().max()):.6g}",
            f"max |stress[22]| at integration points = {max(comp):.6g}",
            f"max nodal stress[22] = {max(nodal_comp):.6g}",
        ]
        n_tri = sum(system.block_mesh(bi).surface_triangles[0].shape[0]
                    for bi in range(len(system.blocks)))
        E = [b.elements.shape[0] for b in system.blocks]
        del system
        torch.cuda.empty_cache()
        got = [ln for ln in text.splitlines()
               if ln.startswith("model:") or " = " in ln]
        check(got == want, f"{label}: CLI printed {got}, the system gives "
              f"{want}")
        check(launches["ell_scatter"] == 2 and launches["ell_spmv"] == iters > 0,
              f"{label}: launches {launches} for {iters} CG iterations")
        for name, n in launches.items():
            if name not in ("ell_scatter", "ell_spmv"):
                check(n == 0, f"{label}: {name} launched {n} times")
        with open(vtk) as f:
            vtext = f.read()
        types = vtext.split(f"CELL_TYPES {sum(E)}\n")[1].split(
            "\n", sum(E))[:sum(E)]
        check(types == ["12"] * E[0] + ["13"] * E[1],
              f"{label}: VTK cell types")
        del vtext, types
        with open(html) as f:
            payload = _json.loads(re.search(r"const D=(\{.*?\});",
                                            f.read()).group(1))
        check(len(payload["tri"]) // 3 == n_tri, f"{label}: HTML triangles")
        del payload
    out[label] = (launches, iters)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"{label} on {card}: rc 0, lines equal to system_from_model's, CG "
          f"{iters} iterations, launches M1 {launches['ell_scatter']} M2 "
          f"{launches['ell_spmv']}; CLI {cli_s:.3f} s ({stages}); VTK cells "
          f"{E[0]} hex8 + {E[1]} wedge6, HTML {n_tri} triangles", flush=True)

    small_nodes, small_blocks = hex_wedge_blocks(MB_NL_N)
    lines = {}
    for label, extra in (("CLI multi-block nonlinear", []),
                         ("CLI multi-block nonlinear, --stabilize",
                          ["--stabilize", repr(STABILIZE)])):
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/nonlinear.inp"
            with open(path, "w") as f:
                f.write(multiblock_inp_text(
                    small_nodes, small_blocks, nlgeom=True,
                    top=(f"top, 3, 3, {NL_UZ!r}",), pressure=None,
                    static=NL_STATIC))
            rc, text, launches, walls, wall = run_cli([path, *extra])
        print(f"{label}: stdout of the CLI:\n{text}", end="", flush=True)
        check(rc == 0, f"{label}: exit code {rc}")
        solve = re.search(r"solve: converged in (\d+) increment", text)
        n_inc = int(solve.group(1)) if solve else -1
        want = EXPECTED_CLI_INCREMENTS["CLI multi-block nonlinear"]
        check(n_inc == want, f"{label}: {n_inc} increments, {want} expected")
        check(launches["internal_force"] == launches["ell_scatter"]
              >= 2 * n_inc and launches["internal_force"] % 2 == 0,
              f"{label}: M4 {launches['internal_force']}, M1 "
              f"{launches['ell_scatter']} for two blocks")
        for name, n in launches.items():
            if name not in ("internal_force", "ell_scatter"):
                check(n == 0, f"{label}: {name} launched {n} times")
        warned = text.startswith("warning: --stabilize is only supported")
        check(warned == bool(extra), f"{label}: the --stabilize warning")
        lines[label] = [ln for ln in text.splitlines()
                        if ln.startswith("model:") or " = " in ln]
        out[label] = (launches, n_inc)
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        print(f"{label} on {card}: {n_inc} increments, M4 = M1 = "
              f"{launches['internal_force']}; CLI {wall:.3f} s ({stages})",
              flush=True)
    check(len(set(map(tuple, lines.values()))) == 1,
          "--stabilize changed the multi-block nonlinear result")
    print(f"CLI multi-block phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def lattice(n: int, seed: int = 0):
    """A B31 frame of n x n x n unit bays (members along x, y and z between
    neighbouring grid nodes; RECT 0.05 x 0.08 steel), the z=0 nodes
    ENCASTRE, a seeded load of up to 1 kN along each axis on every z=n
    node."""
    from femcy_tpu_torch import BeamModel, BeamSection

    g = np.arange(n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float64)
    nid = np.arange(nodes.shape[0]).reshape(n + 1, n + 1, n + 1)
    members = [np.stack([nid[:-1].ravel(), nid[1:].ravel()], 1),
               np.stack([nid[:, :-1].ravel(), nid[:, 1:].ravel()], 1),
               np.stack([nid[:, :, :-1].ravel(), nid[:, :, 1:].ravel()], 1)]
    top = nid[:, :, n].ravel()
    loads = np.random.default_rng(seed).uniform(-1e3, 1e3, (top.size, 3))
    return BeamModel(
        nodes=nodes, elements=np.concatenate(members).astype(np.int32),
        section=BeamSection.rect(0.05, 0.08), E=210.0e9, nu=0.3,
        dirichlet=[(int(b), d, 0.0) for b in nid[:, :, 0].ravel()
                   for d in range(6)],
        loads=[(int(t), d, float(v)) for t, row in zip(top, loads)
               for d, v in enumerate(row)])


def beam_run(torch, card):
    """Phase 21: solve_beam on the card on the ``BEAM_N``-bay lattice,
    twice (bit-identical), every launch counter zeroed around it (the path
    runs no hand-written kernel: the dense Cholesky is a library call, as
    femcy_tpu's is XLA's).  Checks: the relative residual on the free
    dofs, the reactions against the loads, one- and ten-element tip-loaded
    cantilevers against the Timoshenko closed form; then the CLI's B31
    route on a small lattice .inp.  Returns the launch counts."""
    import tempfile

    from femcy_tpu_torch import BeamModel, BeamSection, solve_beam
    from femcy_tpu_torch.beam import _assemble

    t_phase = time.perf_counter()
    model = lattice(BEAM_N)
    n = model.n_dof
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    first = solve_beam(model, device=DEVICE)
    wall1 = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    second = solve_beam(model, device=DEVICE)
    wall2 = time.perf_counter() - t
    launches = read_launches()
    check(not any(launches.values()), f"beam lattice: a kernel launched "
          f"{launches}")
    for field in ("u", "reactions", "end_forces"):
        check(np.array_equal(getattr(first, field), getattr(second, field)),
              f"beam lattice: {field} differs between two solves")
    u = first.u.reshape(-1)
    check(bool(np.isfinite(u).all()), "beam lattice: u not finite")
    f = np.zeros(n)
    for node, dof, val in model.loads:
        f[6 * node + dof] += val
    free = np.ones(n, bool)
    free[[6 * node + dof for node, dof, _ in model.dirichlet]] = False
    K, _, _, _ = _assemble(model, torch.device(DEVICE), torch.float64)
    r = (K @ torch.as_tensor(u, device=DEVICE)).cpu().numpy() - f
    del K
    torch.cuda.empty_cache()
    res = float(np.abs(r[free]).max() / np.abs(f).max())
    check(res <= 1e-10, f"beam lattice: relative residual {res:.3e}")
    applied = f.reshape(-1, 6)[:, :3].sum(axis=0)
    balance = float(np.abs(first.reactions[:, :3].sum(axis=0) + applied).max()
                    / np.abs(f).sum())
    check(balance <= 1e-9, f"beam lattice: reactions off the loads by "
          f"{balance:.3e}")
    E_, nu = 210.0e9, 0.3
    G = E_ / (2 * (1 + nu))
    sec = BeamSection.rect(0.05, 0.08)
    tips = []
    for n_el in (1, 10):
        x = np.linspace(0.0, 2.0, n_el + 1)
        cant = BeamModel(
            np.stack([x, 0 * x, 0 * x], 1),
            np.stack([np.arange(n_el), np.arange(1, n_el + 1)], 1)
            .astype(np.int32), sec, E_, nu,
            [(0, d, 0.0) for d in range(6)], [(n_el, 1, 1000.0)])
        tip = solve_beam(cant, device=DEVICE).u[n_el, 1]
        exact = (1000.0 * 8.0 / (3 * E_ * sec.I11)
                 + 1000.0 * 2.0 / (G * sec.kappa2 * sec.A))
        tips.append(abs(tip / exact - 1.0))
        check(tips[-1] <= 1e-9, f"cantilever of {n_el} elements: tip "
              f"{tip!r}, Timoshenko {exact!r}")
    print(f"beam lattice on {card}: {BEAM_N}^3 bays, {model.nodes.shape[0]} "
          f"nodes, {n} dofs, {model.elements.shape[0]} B31; solve "
          f"{wall1:.3f} s ({', '.join(f'{k} {v:.4f} s' for k, v in first.seconds.items())}), "
          f"again {wall2:.3f} s ({', '.join(f'{k} {v:.4f} s' for k, v in second.seconds.items())}), "
          f"bit-identical; peak memory {peak / 1e9:.3f} GB (dense K "
          f"{n * n * 8 / 1e9:.3f} GB); free-dof residual {res:.3e}, reactions "
          f"vs loads {balance:.3e}; max |u| {np.abs(first.u[:, :3]).max():.6e}; "
          f"cantilevers of 1 and 10 elements vs Timoshenko "
          f"{tips[0]:.3e}, {tips[1]:.3e}", flush=True)

    small = lattice(2)
    base = sorted({node for node, _, _ in small.dirichlet})
    text = "\n".join(
        ["*Heading", "B31 lattice", "*Node"]
        + [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
           for i, p in enumerate(small.nodes)]
        + ["*Element, type=B31, elset=frame"]
        + [f"{e + 1}, {a + 1}, {b + 1}" for e, (a, b) in enumerate(small.elements)]
        + ["*Nset, nset=base", ", ".join(str(b + 1) for b in base),
           "*Beam Section, elset=frame, material=steel, section=RECT",
           "0.05, 0.08", "0., 0., -1.", "*Material, name=steel", "*Elastic",
           "210.e9, 0.3", "*Boundary", "base, ENCASTRE", "*Step", "*Static",
           "*Cload"]
        + [f"{node + 1}, {d + 1}, {v!r}" for node, d, v in small.loads]
        + ["*End Step"]) + "\n"
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/frame.inp"
        with open(path, "w") as fh:
            fh.write(text)
        rc, out, cli_launches, walls, wall = run_cli([path])
    print(f"CLI, B31: stdout of the CLI:\n{out}", end="", flush=True)
    check(rc == 0, f"CLI, B31: exit code {rc}")
    check(out.startswith("model: 54 B31 elements, 27 nodes, 162 dofs"),
          "CLI, B31: model line")
    print(f"beam phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def mixed_model(n: int):
    """The frame-stiffened box: box_tets(n, n, n) in LinearIsotropic(1000,
    0.3) under a grid of B31 members on its z = 1 face (every x-line and
    every y-line of that face's nodes, RECT ``MIXED_SECTION`` square, E
    ``MIXED_E``, nu ``MIXED_NU``), the z = 0 face's translations clamped,
    an x-direction *Cload of total 1.0 spread over the z = 1 nodes.
    Returns (mesh, MixedModel)."""
    from femcy_tpu_torch import (BeamBlock, BeamSection, ElementBlock,
                                 LinearIsotropic, MixedModel)
    from femcy_tpu_torch.meshgen import box_tets

    mesh = box_tets(n, n, n)
    bottom, top = z_faces(mesh)
    grid = np.empty((n + 1, n + 1), dtype=np.int64)
    ij = np.rint(mesh.nodes[top, :2] * n).astype(np.int64)
    grid[ij[:, 0], ij[:, 1]] = top
    members = np.concatenate([
        np.stack([grid[:-1].ravel(), grid[1:].ravel()], 1),
        np.stack([grid[:, :-1].ravel(), grid[:, 1:].ravel()], 1)])
    model = MixedModel(
        nodes=mesh.nodes,
        solid_blocks=[ElementBlock(mesh.elements, mesh.element,
                                   LinearIsotropic(1000.0, 0.3), "solid")],
        beam_blocks=[BeamBlock(members.astype(np.int32),
                               BeamSection.rect(MIXED_SECTION, MIXED_SECTION),
                               MIXED_E, MIXED_NU, "grid")],
        dirichlet=[(int(b), d, 0.0) for b in bottom for d in range(3)],
        cloads=[(int(t), 0, 1.0 / top.size) for t in top],
        neumann_bcs=[])
    return mesh, model


def m6_checks(torch, system, label: str):
    """M6 on the card on ``system``'s own element matrices (its continuum
    Ke, its beams' k_glob), in float32 and float64: bit for bit its plain
    version run on the CPU on the same tensors (one indexed add per block
    into one accumulator) and bit-identical on a rerun; in float64 the
    union values, read through the pattern (``pattern.to_scipy``), within
    1e-12 of the f64 host twin summed over dof pairs without pattern or
    plan (``mixed.union_operator_host``), and every padding slot 0.
    Returns (float64 values, their max abs difference to the CPU plain
    version, the CPU targets, a summary)."""
    from femcy_tpu_torch.kernels import mixed_scatter as km6
    from femcy_tpu_torch.mixed import union_operator_host

    plan = system._plan
    t = time.perf_counter()
    targets = km6.contribution_targets(plan_to(torch, plan, "cpu"))
    targets_s = time.perf_counter() - t
    kes = system._element_matrices()
    values = None
    err64 = None
    reads = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        kd = [k.to(dtype) for k in kes]
        out = km6.scatter(kd, plan)
        out2 = km6.scatter(kd, plan)
        torch.cuda.synchronize()
        check(torch.equal(out, out2),
              f"M6 {label} {name}: rerun not bit-identical")
        t = time.perf_counter()
        flat = torch.zeros(plan.n_dof * plan.width, dtype=dtype)
        for k, tg in zip(kd, targets):
            flat.index_add_(0, tg, k.cpu().reshape(-1))
        plain_s = time.perf_counter() - t
        err = float((out.cpu().reshape(-1) - flat).abs().max())
        check(torch.equal(out.cpu().reshape(-1), flat),
              f"M6 {label} {name}: not bit-equal to its CPU plain version "
              f"({err:.3e})")
        reads.append(f"{name} bit-equal (CPU plain {plain_s:.2f} s)")
        del kd, out2, flat
        if dtype == torch.float64:
            values, err64 = out, err
        else:
            del out
    t = time.perf_counter()
    host = union_operator_host(system.nodes, system.solid_blocks,
                               system.beam_blocks)
    host_s = time.perf_counter() - t
    vals = values.cpu().numpy()
    check(not vals.reshape(-1)[~system.pattern.valid.reshape(-1)].any(),
          f"M6 {label}: a padding slot is not 0")
    rel = float(abs(system.pattern.to_scipy(vals) - host).max()
                / abs(host).max())
    check(rel <= TOL["float64"], f"M6 {label}: union values vs the f64 host "
          f"twin {rel:.3e}")
    summary = (f"M6 checks on {label} ({len(kes)} blocks: "
               f"{', '.join(str(tuple(k.shape)) for k in kes)}; union "
               f"{plan.n_dof} x {plan.width}, "
               f"{'wide' if plan.wide else 'shared'} route): "
               + "; ".join(reads) + f", bit-identical reruns; CPU targets "
               f"{targets_s:.2f} s; union values vs the f64 host twin "
               f"{rel:.3e} (tol {TOL['float64']:.0e}; twin {host_s:.2f} s), "
               "padding 0")
    return values, err64, targets, summary


def mixed_kernel_checks(torch, card, system, results):
    """M6 checked on the mixed box (``m6_checks``), then timed in turns
    with its plain version on the card and one ``index_add_`` over the
    int64 targets of all blocks, in float64 and float32, each with its
    bound: the element matrices read once, the values written once and the
    first design's plan (node_ptr, int32 pairs, four int16 starts a pair),
    whose bytes the current plan's are printed beside.  Prints the kernel
    instance's registers, warps a block and resident blocks an SM.
    Returns the float64 union values."""
    from femcy_tpu_torch.kernels import mixed_scatter as km6

    plan = system._plan
    values, err64, targets, summary = m6_checks(torch, system, "mixed box")
    print(summary, flush=True)
    kes64 = system._element_matrices()
    tcat = torch.cat([tg.to(DEVICE) for tg in targets])
    del targets
    size = plan.n_dof * plan.width
    n_pairs = plan.pairs.numel()
    first_plan = plan.node_ptr.numel() * 8 + n_pairs * 4 + n_pairs * 4 * 2
    plan_now = sum(t.numel() * t.element_size()
                   for t in (plan.node_ptr, plan.pairs, plan.positions))
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        kes = [k.to(dtype).contiguous() for k in kes64]
        kcat = torch.cat([k.reshape(-1) for k in kes])

        def library():
            return torch.zeros(size, dtype=dtype,
                               device=DEVICE).index_add_(0, tcat, kcat)

        ms, pms, lms = in_turns(lambda: km6.scatter_plain(kes, plan),
                                lambda: km6.scatter(kes, plan), 3, 20,
                                library)
        vb = kes[0].element_size()
        n_bytes = sum(k.numel() for k in kes) * vb + size * vb + first_plan
        b = bound(n_bytes, sum(k.numel() for k in kes), name)
        if dtype == torch.float64:
            results["float64"]["mixed_scatter"] = row(err64, ms, pms, lms, b)
        attr = km6.kernel_attributes(dtype, plan)
        print(f"timing mixed box {name} on {card}: M6 mixed_scatter kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, index_add_ {lms:.4f} ms "
              f"({lms / ms:.2f}x M6), bound {b[0]:.4f} ms ({b[1]}; "
              f"{n_bytes / 1e9:.3f} GB), {b[0] / ms:.1%} of it; plan "
              f"{plan_now / 1e9:.4f} GB (the first design's "
              f"{first_plan / 1e9:.4f} GB, in the bound); "
              f"{attr['registers']} registers a thread, "
              f"{attr['local_bytes']} local bytes, {attr['warps_per_block']} "
              f"warps a block, {attr['blocks_per_sm']} blocks "
              f"({attr['blocks_per_sm'] * attr['warps_per_block']} warps) "
              f"resident an SM, {attr['shared_bytes']} shared bytes a block",
              flush=True)
        del kes, kcat
    del tcat, kes64
    return values


def mixed_run(torch, card, results):
    """Phase 22: the frame-stiffened NX=56 box (``mixed_model``) through
    MixedSystem on the card in float64 with the default SolverConfig (the
    Jacobi CG through M2), M6 checked first (``mixed_kernel_checks``),
    every launch counter zeroed just before the solve and read just after.
    Checks: M6 launched once, M2 once per CG iteration, no other kernel,
    ||A x - b||_inf <= cg_eps * ||b||_inf with the plain ELL SpMV, M2
    against its plain version on the eliminated operator, finite results
    of the expected shapes, a warm solve with the same iterations.  Returns
    (launches, CG iterations)."""
    from femcy_tpu_torch import MixedSystem, SolverConfig
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain

    t_phase = time.perf_counter()
    mesh, model = mixed_model(FULL[0])
    t = time.perf_counter()
    system = MixedSystem(model.nodes, model.solid_blocks, model.beam_blocks,
                         SolverConfig(), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    check(system.dtype == torch.float64, "default dtype is not float64")
    n_beam = model.beam_blocks[0].elements.shape[0]
    print(f"mixed box: {mesh.n_elements} C3D4 + {n_beam} B31, "
          f"{system.n_nodes} nodes, {system.n_dof} dofs; union ELL width "
          f"{system.pattern.width}; MixedSystem init {init_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in system._init_seconds.items())
          + ")", flush=True)
    values = mixed_kernel_checks(torch, card, system, results)
    check(torch.equal(values, system._assemble()),
          "mixed: the system's assembly is not M6's output")
    del values

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = system.solve(model)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    iters = system._last_cg_iters
    check(iters > 0 and res.cg_iters == iters, "mixed: the CG did not run")
    check(launches["mixed_scatter"] == 1,
          f"mixed: M6 launched {launches['mixed_scatter']} times")
    check(launches["ell_spmv"] == iters, f"mixed: M2 launched "
          f"{launches['ell_spmv']} times for {iters} iterations")
    for name, n in launches.items():
        if name not in ("mixed_scatter", "ell_spmv"):
            check(n == 0, f"mixed: {name} launched {n} times")
    values_bc, b = system._linear_system(*system._model_arrays(model))
    r = float((ell_spmv_plain(values_bc, system._arrs["colidx"], system.dof)
               - b).abs().max())
    bmax = float(b.abs().max())
    check(r <= system.config.cg_eps * bmax,
          f"mixed: ||Ax-b||_inf {r:.3e} > cg_eps*||b||_inf")
    m2_union_check(torch, system, values_bc, "mixed box")
    del values_bc, b
    E, G = mesh.n_elements, mesh.element.n_gp
    for what, a, shape in (("u", res.u, (system.n_nodes, 6)),
                           ("stress", res.solid_stress[0], (E, G, 3, 3)),
                           ("mises", res.solid_mises[0], (E, G)),
                           ("end forces", res.beam_end_forces[0],
                            (n_beam, 12))):
        check(a.shape == shape, f"mixed: {what} shape {a.shape}")
        check(bool(np.isfinite(a).all()), f"mixed: {what} not finite")
    check(res.n_auto_fixed == 3 * (system.n_nodes - (FULL[0] + 1) ** 2),
          f"mixed: {res.n_auto_fixed} auto-fixed rotations")
    t = time.perf_counter()
    system.solve(model)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    check(system._last_cg_iters == iters, "mixed: warm solve iterations")
    print(f"mixed box on {card}: first solve {first_s:.4f} s, warm "
          f"{warm_s:.4f} s (each with recovery), {iters} CG iterations, "
          f"||Ax-b||_inf/||b||_inf {r / bmax:.3e}, max |u| "
          f"{np.abs(res.u[:, :3]).max():.6e}, max solid mises "
          f"{float(res.solid_mises[0].max()):.6g}, max beam axial force "
          f"{np.abs(res.beam_end_forces[0][:, [0, 6]]).max():.6e}, "
          f"{res.n_auto_fixed} auto-fixed rotations, peak memory "
          f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
    del system, res
    torch.cuda.empty_cache()
    print(f"mixed phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, iters


def hub_model(n: int):
    """A radial strut hub: box_tets(n, n, n) in the mixed box's material,
    the centre node of its z = 1 face joined by a B31 member of the mixed
    box's section to each of that face's other nodes, the z = 0 face's
    translations clamped.  Returns (mesh, MixedModel)."""
    from femcy_tpu_torch import (BeamBlock, BeamSection, ElementBlock,
                                 LinearIsotropic, MixedModel)
    from femcy_tpu_torch.meshgen import box_tets

    mesh = box_tets(n, n, n)
    bottom, top = z_faces(mesh)
    ij = np.rint(mesh.nodes[top, :2] * n).astype(np.int64)
    hub = top[(ij == n // 2).all(axis=1)][0]
    others = top[top != hub]
    members = np.stack([np.full_like(others, hub), others], 1)
    model = MixedModel(
        nodes=mesh.nodes,
        solid_blocks=[ElementBlock(mesh.elements, mesh.element,
                                   LinearIsotropic(1000.0, 0.3), "solid")],
        beam_blocks=[BeamBlock(members.astype(np.int32),
                               BeamSection.rect(MIXED_SECTION, MIXED_SECTION),
                               MIXED_E, MIXED_NU, "struts")],
        dirichlet=[(int(b), d, 0.0) for b in bottom for d in range(3)],
        cloads=[], neumann_bcs=[])
    return mesh, model


def hex_spine_blocks(collapse: bool):
    """box_hexes(8, 2, 2) over 8 x 1 x 1 in the mixed box's material under
    a B31 spine along its top edge (M6's generic kind beside B31), its
    first hex collapsed (node 7 named as node 6) if ``collapse``.  Returns
    (nodes, solid blocks, beam blocks)."""
    from femcy_tpu_torch import (BeamBlock, BeamSection, ElementBlock,
                                 LinearIsotropic)
    from femcy_tpu_torch.meshgen import box_hexes

    mesh = box_hexes(8, 2, 2, lx=8.0)
    y, z = mesh.nodes[:, 1], mesh.nodes[:, 2]
    edge = np.nonzero((y > y.max() - 1e-9) & (z > z.max() - 1e-9))[0]
    edge = edge[np.argsort(mesh.nodes[edge, 0])]
    elements = mesh.elements.copy()
    if collapse:
        elements[0, 7] = elements[0, 6]
    return mesh.nodes, [ElementBlock(elements, mesh.element,
                                     LinearIsotropic(1000.0, 0.3), "hexes")], [
        BeamBlock(np.stack([edge[:-1], edge[1:]], 1).astype(np.int32),
                  BeamSection.rect(MIXED_SECTION, MIXED_SECTION), MIXED_E,
                  MIXED_NU, "spine")]


def mixed_route_run(torch, card):
    """Phase 22b, M6's other routes.  The hub (``hub_model(MIXED_HUB_N)``)
    through MixedSystem on the card in float64: union ELL width above 1024,
    so a wide plan (int32 starts, every row summed in the output); M6 on
    its own element matrices checked by ``m6_checks`` (bit for bit its CPU
    plain version in float32 and float64, bit-identical reruns, within
    1e-12 of the f64 host twin, padding 0), and the wide-route counter
    moved on every one of those launches.  Then the generic kind
    (``hex_spine_blocks``, plain and with a collapsed hex) on its own plan
    and on that plan built wide, on seeded element matrices: bit for bit
    the CPU plain version in float32 and float64, bit-identical reruns.
    Prints the phase wall."""
    from femcy_tpu_torch import MixedSystem, SolverConfig
    from femcy_tpu_torch.kernels import mixed_scatter as km6

    t_phase = time.perf_counter()
    _, model = hub_model(MIXED_HUB_N)
    system = MixedSystem(model.nodes, model.solid_blocks, model.beam_blocks,
                         SolverConfig(), device=DEVICE)
    plan = system._plan
    check(plan.width > 1024 and plan.wide
          and plan.positions.dtype == torch.int32,
          f"hub: union width {plan.width}, wide {plan.wide}")
    wide0, all0 = km6.scatter.wide_launches, km6.scatter.launches
    _, _, _, summary = m6_checks(torch, system, "the hub")
    wide_n = km6.scatter.wide_launches - wide0
    check(wide_n == km6.scatter.launches - all0 and wide_n >= 4,
          f"hub: {wide_n} wide launches of {km6.scatter.launches - all0}")
    print(f"{summary}; {wide_n} launches, all on the wide route", flush=True)
    del system, plan

    for collapse in (False, True):
        nodes, solids, beams = hex_spine_blocks(collapse)
        system = MixedSystem(nodes, solids, beams, SolverConfig(),
                             device=DEVICE)
        plans = {"shared": system._plan}
        saved = km6.SHARED_ROW_BYTES
        km6.SHARED_ROW_BYTES = 3 * 8 * (system.pattern.width - 1)
        try:
            plans["wide"] = km6.build_mixed_plan(
                system.n_nodes, system.pattern.width,
                [b.elements for b in solids + beams], [3, 6],
                system._block_positions, DEVICE)
        finally:
            km6.SHARED_ROW_BYTES = saved
        rng = np.random.default_rng(11)
        kes_np = [rng.standard_normal(tuple(k.shape))
                  for k in system._element_matrices()]
        label = f"hex spine{', collapsed' if collapse else ''}"
        for route, plan in plans.items():
            check(plan.kinds == (km6.KIND_GENERIC, km6.KIND_BEAM)
                  and plan.wide == (route == "wide"),
                  f"M6 {label}: kinds {plan.kinds}, wide {plan.wide}")
            flagged = int((plan.pairs < 0).sum())
            check(flagged == (8 if collapse else 0),
                  f"M6 {label}: {flagged} flagged pairs")
            for dtype in (torch.float32, torch.float64):
                kes = [torch.as_tensor(k, dtype=dtype, device=DEVICE)
                       for k in kes_np]
                out = km6.scatter(kes, plan)
                ref = km6.scatter_plain([k.cpu() for k in kes],
                                        plan_to(torch, plan, "cpu"))
                check(torch.equal(out.cpu(), ref), f"M6 {label} {route} "
                      f"{dtype}: not bit-equal to its CPU plain version")
                check(torch.equal(out, km6.scatter(kes, plan)),
                      f"M6 {label} {route} {dtype}: rerun not bit-identical")
            print(f"M6 on {label}, {route} route (generic kind, union width "
                  f"{plan.width}, {flagged} flagged pairs): bit-equal to the "
                  "CPU plain version in float32 and float64, bit-identical "
                  "reruns", flush=True)
        del system, plans
    torch.cuda.empty_cache()
    print(f"M6 routes phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def mixed_inp_text(n: int) -> str:
    """``mixed_model(n)`` as an Abaqus .inp: the tets and the grid as two
    *Element blocks with a *Solid Section and a *Beam Section of one
    material, *Elastic 1000, 0.3 (the reader maps a block to a material
    through a *Solid Section or, with one material, to that one), the z = 0
    face's translations clamped, the x *Cload on every z = 1 node and a
    pressure of ``MIXED_PRESSURE`` on the z = 1 faces through a *Surface
    of per-face-number element sets."""
    import io

    mesh, model = mixed_model(n)
    beams = model.beam_blocks[0].elements
    E = mesh.n_elements
    buf = io.StringIO()
    buf.write("*Heading\nchip_smoke mixed model\n*Node\n")
    np.savetxt(buf, np.hstack([np.arange(1, mesh.n_nodes + 1)[:, None],
                               mesh.nodes]),
               fmt=["%d"] + ["%.17g"] * 3, delimiter=", ")
    buf.write("*Element, type=C3D4, elset=solid\n")
    np.savetxt(buf, np.hstack([np.arange(1, E + 1)[:, None],
                               mesh.elements.astype(np.int64) + 1]),
               fmt="%d", delimiter=", ")
    buf.write("*Element, type=B31, elset=grid\n")
    np.savetxt(buf, np.hstack([np.arange(E + 1, E + beams.shape[0] + 1)[:, None],
                               beams.astype(np.int64) + 1]),
               fmt="%d", delimiter=", ")
    z = mesh.nodes[:, 2]
    lines = []
    for name, sel in (("bot", z < 1e-9), ("top", z > z.max() - 1e-9)):
        lines += [f"*Nset, nset={name}",
                  ", ".join(str(i + 1) for i in np.nonzero(sel)[0])]
    faces = []
    for k, facets in enumerate(mesh.element.inp_surface_num):
        local = [ln for f in facets for ln in f]
        on = (z[mesh.elements[:, local]] > z.max() - 1e-9).all(axis=1)
        if on.any():
            faces.append(k + 1)
            lines += [f"*Elset, elset=_z{k + 1}",
                      ", ".join(str(e + 1) for e in np.nonzero(on)[0])]
    lines.append("*Surface, type=ELEMENT, name=zload")
    lines += [f"_z{k}, S{k}" for k in faces]
    top = int((z > z.max() - 1e-9).sum())
    lines += ["*Solid Section, elset=solid, material=m",
              "*Beam Section, elset=grid, material=m, section=RECT",
              f"{MIXED_SECTION!r}, {MIXED_SECTION!r}",
              "*Material, name=m", "*Elastic", "1000., 0.3",
              "*Step, name=s, nlgeom=NO",
              "*Static", "1., 1., 1e-05, 1.", "*Boundary", "bot, 1, 3",
              "*Cload", f"top, 1, {1.0 / top!r}",
              "*Dsload", f"zload, P, {MIXED_PRESSURE!r}", "*End Step"]
    buf.write("\n".join(lines) + "\n")
    return buf.getvalue()


def cli_mixed_run(torch, card):
    """Phase 23: ``mixed_inp_text(MIXED_CLI_N)`` through ``cli.main`` on the
    card: rc 0, the printed lines equal to those formatted from a
    ``solve_mixed(read_mixed_inp(...))`` on the card, M6 launched once and
    no other kernel (a direct solve).  Returns the launches."""
    import tempfile

    from femcy_tpu_torch import read_mixed_inp, solve_mixed

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mixed.inp"
        with open(path, "w") as fh:
            fh.write(mixed_inp_text(MIXED_CLI_N))
        rc, out, launches, walls, wall = run_cli([path])
        model = read_mixed_inp(path)
    print(f"CLI, mixed: stdout of the CLI:\n{out}", end="", flush=True)
    check(rc == 0, f"CLI, mixed: exit code {rc}")
    check(launches["mixed_scatter"] == 1,
          f"CLI, mixed: M6 launched {launches['mixed_scatter']} times")
    for name, n in launches.items():
        if name != "mixed_scatter":
            check(n == 0, f"CLI, mixed: {name} launched {n} times")
    check(len(model.neumann_bcs) == 1 and model.beam_blocks,
          "CLI, mixed: the model lost its *Dsload or its beams")
    res = solve_mixed(model, device=DEVICE)
    n_beam = model.beam_blocks[0].elements.shape[0]
    n_solid = model.solid_blocks[0].elements.shape[0]
    defl = np.linalg.norm(res.u[:, :3], axis=1)
    fe = res.beam_end_forces[0]
    want = [
        f"mixed model: {n_solid} continuum elements in 1 block(s) + "
        f"{n_beam} B31 elements, {model.nodes.shape[0]} nodes (6 dofs/node)",
        f"max deflection |u| = {defl.max():.6e} (node {defl.argmax()})",
        f"max solid Mises = {float(res.solid_mises[0].max()):.6e}",
        f"max beam axial force N = {np.abs(fe[:, [0, 6]]).max():.6e}",
        f"max beam bending moment = {np.abs(fe[:, [4, 5, 10, 11]]).max():.6e}",
        f"auto-constrained rotation dofs: {res.n_auto_fixed}"]
    lines = out.splitlines()
    check(lines[:-1] == want and lines[-1].startswith("solve time: "),
          f"CLI, mixed: printed lines {lines} differ from {want}")
    print(f"CLI, mixed on {card}: rc 0, the lines of solve_mixed on the same "
          f"model; wall {wall:.3f} s (stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"); launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def riks_run(torch, card):
    """Phase 24: riks_solve on the box Newton cell's mesh and system
    (box_tets(56), nlgeom, the multigrid CG), z = 0 clamped, a pressure of
    ``RIKS_PRESSURE`` on the z = 1 face, lam_target 1, every launch counter
    zeroed just before and read just after.  Checks: success, no limit
    point, the step history against ``EXPECTED_RIKS``, M5 and P2 once per
    Newton evaluation, P1 in the solves and no other kernel; the f64 host
    residual at the final state (``internal_force_host`` minus the load,
    BC rows zeroed) within the Riks tolerance; the dof against a
    load-controlled FEMSystem.solve of the same load (newton_rel_tol 1e-8)
    within 1e-6 relative.  Returns (launches, history)."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch import bc as bc_mod
    from femcy_tpu_torch.assembly_host import internal_force_host
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel, NeumannBC
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.riks import riks_solve

    t_phase = time.perf_counter()
    mesh = box_tets(*FULL)
    bottom, top = z_faces(mesh)
    t = time.perf_counter()
    on_top = set(top.tolist())
    faces = [f for f in mesh.boundary if all(v in on_top for v in f)]
    faces_s = time.perf_counter() - t
    inp = InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={"bottom": bottom, "top": top}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(bottom, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(faces, RIKS_PRESSURE, None)],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs={"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                   "max_inc": 1.0})
    mat = LinearIsotropic(1000.0, 0.3)
    config = dict(preconditioner="multigrid", linear_solver="cg")
    t = time.perf_counter()
    system = FEMSystem(mesh, mat, True, SolverConfig(**config), device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    evals = []
    newton_eval = system._newton_eval

    def counted(*args):
        evals.append(1)
        return newton_eval(*args)

    system._newton_eval = counted
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    report = riks_solve(system, inp, lam_target=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    history = [(s.lam, s.iters) for s in report.steps]
    print(f"Riks on {card}: {mesh.n_elements} C3D4, {mesh.n_dof} dofs, "
          f"{config}, pressure {RIKS_PRESSURE}; top facets {len(faces)} in "
          f"{faces_s:.2f} s; setup {setup_s:.3f} s; riks_solve {wall:.3f} s, "
          f"{len(evals)} evaluations, {len(system._cg_iters_log)} CG solves "
          f"({sum(system._cg_iters_log)} iterations), history "
          f"{[(repr(lam), n) for lam, n in history]}, stiffness "
          f"{[s.stiffness for s in report.steps]}, {report.message!r}, peak "
          f"memory {peak / 1e9:.3f} GB; launches {launches}", flush=True)
    check(report.success and not report.limit_point,
          f"Riks: success {report.success}, limit point "
          f"{report.limit_point}: {report.message}")
    check([n for _, n in history] == [n for _, n in EXPECTED_RIKS]
          and all(abs(lam - want) <= 1e-6 * want
                  for (lam, _), (want, _) in zip(history, EXPECTED_RIKS)),
          f"Riks: history {history}, {EXPECTED_RIKS} expected")
    n = len(evals)
    check(launches["structured_force"] == n
          and launches["structured_accumulate"] == n
          and launches["newton_element"] == n,
          f"Riks: M5 launched {launches['structured_force']}, P2 "
          f"{launches['structured_accumulate']} and M9 "
          f"{launches['newton_element']} times for {n} evaluations")
    check(launches["dia_spmv"] > 0, "Riks: P1 never launched")
    for name, k in launches.items():
        if name not in ("structured_force", "structured_accumulate",
                        "newton_element", "dia_spmv"):
            check(k == 0, f"Riks: {name} launched {k} times")
    patterns, tractions = bc_mod.build_neumann_patterns(mesh, inp.neumann_bcs)
    q = tractions @ patterns
    fixed = np.zeros(mesh.n_dof, bool)
    fixed[bottom[:, None] * 3 + np.arange(3)] = True
    q[fixed] = 0.0
    dof = system.dof.cpu().numpy()
    check(bool(np.isfinite(dof).all()), "Riks: dof not finite")
    r = internal_force_host(mesh, mat, dof) - q
    r[fixed] = 0.0
    rms, q_rms = (float(np.sqrt(np.mean(r * r))),
                  float(np.sqrt(np.mean(q * q))))
    check(rms <= 1e-6 * q_rms, f"Riks: f64 host residual {rms:.3e} > "
          f"1e-6 * {q_rms:.3e}")
    del system
    torch.cuda.empty_cache()
    newton = FEMSystem(mesh, mat, True, SolverConfig(newton_rel_tol=1e-8,
                                                     **config), device=DEVICE)
    t = time.perf_counter()
    nrep = newton.solve(inp)
    torch.cuda.synchronize()
    newton_s = time.perf_counter() - t
    check(nrep.success, f"Riks: the load-controlled solve: {nrep.message}")
    ref = newton.dof.cpu().numpy()
    rel = float(np.abs(dof - ref).max() / np.abs(ref).max())
    check(rel <= 1e-6, f"Riks: dof vs the load-controlled solve {rel:.3e}")
    del newton
    torch.cuda.empty_cache()
    print(f"Riks checks: f64 host residual {rms:.3e} (tol "
          f"{1e-6 * q_rms:.3e}); dof vs FEMSystem.solve of the same load "
          f"{rel:.3e} (its solve {newton_s:.3f} s, "
          f"{[(r_.newton_iters, r_.converged) for r_ in nrep.increments]}); "
          f"max |u| {np.abs(dof).max():.6e}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, history


class _F32:
    """FEMCY_TPU_X64=0 inside the block (systems built there run in
    float32), the previous value after it."""

    def __enter__(self):
        import os

        self.old = os.environ.get("FEMCY_TPU_X64")
        os.environ["FEMCY_TPU_X64"] = "0"

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop("FEMCY_TPU_X64", None)
        else:
            os.environ["FEMCY_TPU_X64"] = self.old


def certificate(system, x):
    """||b - K_64 x||_inf / ||b||_inf on the f64 host CSR operator the
    refinement built (``system._refine_K``), eliminated with the last
    increment's f64 host arrays (``system._host_bc``: the device's
    prescribed values are rounded to float32)."""
    from femcy_tpu_torch.assembly_host import dirichlet_csr_host

    K_bc, b = dirichlet_csr_host(system._refine_K, *system._host_bc)
    return float(np.abs(b - K_bc @ np.asarray(x, np.float64)).max()
                 / np.abs(b).max())


def refine_box_run(torch, card, mg_dof):
    """Phase 25: mixed-precision refinement on the NX=56 box in float32
    (the multigrid CG, P3 and P1 in float32) against the plain float32
    solve and the float64 MG-CG solution of phase 5 (``mg_dof``).  Returns
    (launches, outer iterations)."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import box_tets

    t_phase = time.perf_counter()
    mesh = box_tets(*FULL)
    mat = LinearIsotropic(1000.0, 0.3)
    inp = boundary_model(mesh, 0.01)
    cfg = dict(preconditioner="multigrid", linear_solver="cg")
    with _F32():
        system = FEMSystem(mesh, mat, config=SolverConfig(
            mixed_precision_refine=True, **cfg), device=DEVICE)
        plain = FEMSystem(mesh, mat, config=SolverConfig(**cfg),
                          device=DEVICE)
    check(system.dtype == plain.dtype == torch.float32,
          "refinement phase did not build float32 systems")
    zero_launches()
    t = time.perf_counter()
    report = system.solve(inp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_launches()
    outer, cg = system._refine_iters, list(system._cg_iters_log)
    check(report.success, "refined solve reported failure")
    check(launches["structured_fused"] == 1,
          f"refinement: P3 launched {launches['structured_fused']} times")
    check(launches["dia_spmv"] > 0 and len(cg) == outer > 0,
          f"refinement: P1 {launches['dia_spmv']}, {outer} outer iterations"
          f", inner solves {cg}")
    for name, n in launches.items():
        if name not in ("structured_fused", "dia_spmv"):
            check(n == 0, f"refinement: {name} launched {n} times")
    x = system.dof_refined
    check(x is not None and x.dtype == np.float64
          and bool(np.isfinite(x).all()), "refinement: no f64 state")
    cert = certificate(system, x)
    check(cert <= 1e-6, f"refinement certificate {cert:.3e} > 1e-6")
    t = time.perf_counter()
    check(plain.solve(inp).success, "plain float32 solve")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    x32 = plain.dof.cpu().numpy().astype(np.float64)
    cert32 = certificate(system, x32)
    scale = np.abs(mg_dof).max()
    d_ref = float(np.abs(x - mg_dof).max() / scale)
    d_plain = float(np.abs(x32 - mg_dof).max() / scale)
    t = time.perf_counter()
    check(system.solve(inp).success and system._refine_iters == outer,
          "warm refined solve")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    check(outer == EXPECTED_REFINE_OUTER,
          f"refinement: {outer} outer iterations, {EXPECTED_REFINE_OUTER} "
          "expected")
    print(f"refinement, box_tets{FULL} in float32 on {card}: {outer} outer "
          f"iterations (MG-CG iterations {cg}), first solve (f64 host "
          f"twin built in it) {first_s:.3f} s"
          f", warm {warm_s:.3f} s, plain float32 solve {plain_s:.3f} s; "
          f"||b - K64 x||/||b||: refined {cert:.3e}, plain float32 "
          f"{cert32:.3e}; max|x - x_MG64|/max|x_MG64| (phase 5's float64 "
          f"MG-CG at cg_eps 1e-3): refined {d_ref:.3e}, plain float32 "
          f"{d_plain:.3e}; launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del system, plain
    torch.cuda.empty_cache()
    return launches, outer


def refine_incompressible_run(torch, card):
    """Phase 26: refinement on box_tets(16) at nu = 0.4999 in float32 with
    the Jacobi CG (iterations uncapped up to REFINE_CG_CAP) against the
    float64 host direct solve."""
    import scipy.sparse.linalg as spla

    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.assembly_host import (assemble_csr_host,
                                               dirichlet_csr_host)
    from femcy_tpu_torch.bc import build_dirichlet_arrays
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.topology import build_pattern

    t_phase = time.perf_counter()
    mesh = box_tets(16, 16, 16)
    mat = LinearIsotropic(1000.0, 0.4999)
    inp = boundary_model(mesh, 0.01)
    fixed, sval = build_dirichlet_arrays(inp.dirichlet_bcs, mesh, 1.0, 1.0)
    K_bc, b = dirichlet_csr_host(
        assemble_csr_host(mesh, build_pattern(mesh), np.asarray(mat.C)),
        np.zeros(mesh.n_dof), fixed, sval)
    ref = spla.spsolve(K_bc.tocsc(), b)
    cfg = dict(linear_solver="cg", cg_max_iters=REFINE_CG_CAP)
    out = {}
    for refine in (True, False):
        with _F32():
            s = FEMSystem(mesh, mat, config=SolverConfig(
                mixed_precision_refine=refine, **cfg), device=DEVICE)
        zero_launches()
        t = time.perf_counter()
        check(s.solve(inp).success, f"nu=0.4999 solve, refine={refine}")
        torch.cuda.synchronize()
        x = s.dof_refined if refine else s.dof.cpu().numpy()
        out[refine] = (float(np.abs(x - ref).max() / np.abs(ref).max()),
                       time.perf_counter() - t, list(s._cg_iters_log),
                       s._refine_iters, read_launches())
    err, wall, cg, outer, launches = out[True]
    check(max(cg) < REFINE_CG_CAP, f"nu=0.4999: an inner CG hit its cap {cg}")
    check(launches["dia_spmv"] == sum(cg),
          f"nu=0.4999: P1 {launches['dia_spmv']} for CG iterations {cg}")
    check(err <= 1e-6, f"nu=0.4999 refined vs f64 direct: {err:.3e}")
    print(f"refinement, box_tets(16) at nu=0.4999 in float32 on {card}: "
          f"{outer} outer iterations, Jacobi CG iterations {cg}, {wall:.3f}"
          f" s; max|x - x64|/max|x64| refined {err:.3e}, plain float32 "
          f"{out[False][0]:.3e} ({out[False][2]} iterations); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def newton_refine_run(torch, card):
    """Phase 27: the pinned twist on unstructured_box_tets(INP_NX) in
    float32 with refinement: the equilibrium quality rms(r64)/rms(f) of
    ``dof_refined`` (f64 host internal force) below 1e-9, beside the
    unrefined run's.  Returns (launches, history)."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.assembly_host import internal_force_host
    from femcy_tpu_torch.meshgen import unstructured_box_tets
    from femcy_tpu_torch.user import make_rotation_dirichlet

    t_phase = time.perf_counter()
    mesh = unstructured_box_tets(INP_NX)
    mat = LinearIsotropic(1000.0, 0.3)
    inp = twist_model(mesh)
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0))

    def quality(system, dof):
        fixed = system._last_dirichlet[0].cpu().numpy()
        f = internal_force_host(mesh, mat, np.asarray(dof, np.float64))
        r = f.copy()
        r[fixed] = 0.0
        return float(np.sqrt(np.mean(r * r)) / np.sqrt(np.mean(f * f)))

    out = {}
    for refine in (True, False):
        with _F32():
            s = FEMSystem(mesh, mat, True, SolverConfig(
                mixed_precision_refine=refine), device=DEVICE)
        zero_launches()
        t = time.perf_counter()
        report = s.solve(inp, user_dirichlet=hook)
        torch.cuda.synchronize()
        check(report.success, f"Newton refinement={refine}: {report.message}")
        summary = s.timer.summary()
        out[refine] = dict(
            wall=time.perf_counter() - t, launches=read_launches(),
            history=[(r.newton_iters, r.converged) for r in report.increments],
            q=quality(s, s.dof_refined if refine
                      else s.dof.cpu().numpy()),
            refine_s=sum(rec.seconds for rec in s.timer.records
                         if rec.name == "newton_refine"),
            evals=summary["newton_eval"]["count"])
    r, p = out[True], out[False]
    check(r["q"] < 1e-9, f"Newton refinement quality {r['q']:.3e} >= 1e-9")
    check(r["launches"]["internal_force"] == r["evals"]
          and r["launches"]["ell_scatter"] > r["evals"],
          f"Newton refinement: M4 {r['launches']['internal_force']}, M1 "
          f"{r['launches']['ell_scatter']} for {r['evals']} evaluations")
    want = EXPECTED_NEWTON["Newton refinement"]
    check(r["history"] == want,
          f"Newton refinement: history {r['history']}, {want} expected")
    print(f"Newton refinement, unstructured_box_tets({INP_NX}) twist in "
          f"float32 on {card}: history {r['history']}, {r['evals']} "
          f"evaluations, solve {r['wall']:.3f} s ({r['refine_s']:.3f} s of "
          f"it refinement: consistent tangents, LUs, f64 host residuals); "
          f"rms(r64)/rms(f) refined {r['q']:.3e}, unrefined {p['q']:.3e} "
          f"(history {p['history']}, {p['wall']:.3f} s); launches "
          f"{r['launches']}; phase wall {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    return r["launches"], r["history"]


def dense_cg_run(torch, card):
    """Phase 28: the small-model dense CG at cg_eps 1e-10 against the
    sparse Jacobi CG of the same layout: unstructured_box_tets(DENSE_NX)
    (ELL, ell_to_dense) and box_tets(DENSE_BOX) (DIA,
    dia_to_dense_device).  Returns {label: (launches, iterations)}."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import box_tets, unstructured_box_tets
    from femcy_tpu_torch.solvers.cg import ell_to_dense

    t_phase = time.perf_counter()
    mat = LinearIsotropic(1000.0, 0.3)
    found = {}
    for label, mesh, spmv in (
            ("dense CG, ELL", unstructured_box_tets(DENSE_NX), "ell_spmv"),
            ("dense CG, box", box_tets(*(DENSE_BOX,) * 3), "dia_spmv")):
        inp = boundary_model(mesh, 0.01)
        dofs, runs = {}, {}
        for dense in (DENSE_MAX_DOF, 0):
            s = FEMSystem(mesh, mat, config=SolverConfig(
                linear_solver="cg", cg_eps=1e-10,
                dense_operator_max_dof=dense), device=DEVICE)
            check(s._use_dense_cg == bool(dense), f"{label}: dense route")
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            check(s.solve(inp).success, f"{label}: solve")
            torch.cuda.synchronize()
            launches = read_launches()
            iters = s._last_cg_iters
            solve_s = s.timer.summary()["linear_solve"]["first"]
            runs[dense] = (launches, iters, solve_s,
                           torch.cuda.max_memory_allocated())
            dofs[dense] = s.dof.cpu().numpy()
            check(launches[spmv] == (0 if dense else iters),
                  f"{label}: {spmv} {launches[spmv]} for {iters} iterations "
                  f"(dense={bool(dense)})")
            if dense and s.dia is None:
                # the dense product alone, timed on the solve's operator
                values, _, _ = s._linear_system(
                    torch.zeros_like(s.dof), *s._last_dirichlet)
                A = ell_to_dense(values, s._arrs["colidx"], mesh.n_dof)
                v = torch.ones_like(s.dof)
                mv_ms = cuda_ms(lambda: torch.mv(A, v), 10)
                del A, values
        rel = float(np.abs(dofs[DENSE_MAX_DOF] - dofs[0]).max()
                    / np.abs(dofs[0]).max())
        check(rel <= 1e-8, f"{label}: dense vs sparse CG {rel:.3e}")
        launches, iters, solve_s, peak = runs[DENSE_MAX_DOF]
        n = mesh.n_dof
        bound_ms = (n * n + 2 * n) * 8 / HBM_BYTES_PER_S * 1e3
        extra = (f", torch.mv alone {mv_ms:.4f} ms" if spmv == "ell_spmv"
                 else "")
        print(f"{label} on {card}: {mesh.n_elements} C3D4, {n} dofs, dense "
              f"operator {n * n * 8 / 1e9:.3f} GB, peak memory "
              f"{peak / 1e9:.3f} GB; dense CG {iters} iterations in "
              f"{solve_s:.3f} s ({solve_s / iters * 1e3:.4f} ms an iteration"
              f"{extra}; bound {bound_ms:.4f} ms: the operator over 3.35 "
              f"TB/s), sparse CG {runs[0][1]} iterations in "
              f"{runs[0][2]:.3f} s; max|dx|/max|x| {rel:.3e}; launches "
              f"{launches}", flush=True)
        found[label] = (launches, iters)
    print(f"dense CG phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return found


def device_loop_run(torch, card):
    """Phase 30: the pinned twist on unstructured_box_tets(56) through the
    device loop (config.device_loop): its records against EXPECTED_NEWTON,
    M1 once per full evaluation, M4 once per evaluation and per
    residual probe, M2 in the CG solves, the f64 host residual at the
    final state within 1e-8 of the last record's; then an unsupported
    configuration raises ValueError and launches nothing.  Returns
    (launches, history)."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.assembly_host import internal_force_host
    from femcy_tpu_torch.meshgen import unstructured_box_tets
    from femcy_tpu_torch.user import make_rotation_dirichlet

    t_phase = time.perf_counter()
    label = "device loop"
    mesh = unstructured_box_tets(UNSTRUCT[-1])
    mat = LinearIsotropic(1000.0, 0.3)
    inp = twist_model(mesh)
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0))
    system = FEMSystem(mesh, mat, True, SolverConfig(device_loop=True),
                       device=DEVICE)
    counts = {"eval": 0, "probe": 0}
    evaluate, probe = system._newton_eval, system._residual_rms

    def counted_eval(*a):
        counts["eval"] += 1
        return evaluate(*a)

    def counted_probe(*a):
        counts["probe"] += 1
        return probe(*a)

    system._newton_eval, system._residual_rms = counted_eval, counted_probe
    zero_launches()
    t = time.perf_counter()
    report = system.solve(inp, user_dirichlet=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    history = [(r.newton_iters, r.converged) for r in report.increments]
    check(report.success, f"{label}: {report.message}")
    check(launches["ell_scatter"] == counts["eval"]
          and launches["internal_force"] == counts["eval"] + counts["probe"],
          f"{label}: M1 {launches['ell_scatter']}, M4 "
          f"{launches['internal_force']} for {counts}")
    check(launches["ell_spmv"] == sum(system._cg_iters_log) > 0,
          f"{label}: M2 {launches['ell_spmv']} for CG iterations "
          f"{system._cg_iters_log}")
    for name, n in launches.items():
        if name not in ("ell_scatter", "internal_force", "ell_spmv"):
            check(n == 0, f"{label}: {name} launched {n} times")
    fixed = system._last_dirichlet[0].cpu().numpy()
    r = internal_force_host(mesh, mat, system.dof.cpu().numpy())
    r[fixed] = 0.0
    rms_host = float(np.sqrt(np.mean(r * r)))
    rel = abs(report.increments[-1].residual - rms_host) / rms_host
    check(rel <= 1e-8, f"{label}: last residual vs f64 host {rel:.3e}")
    want = EXPECTED_NEWTON[label]
    check(history == want, f"{label}: history {history}, {want} expected")
    records = [(round(r.time, 6), round(r.dt, 6), r.newton_iters,
                r.converged) for r in report.increments]
    print(f"{label} on {card}: {mesh.n_elements} C3D4; solve {wall:.3f} s, "
          f"{counts['eval']} evaluations and {counts['probe']} residual "
          f"probes, CG iterations {system._cg_iters_log}; records (time1, "
          f"dt after, iters, converged) {records}; f64 host residual rel "
          f"{rel:.3e}; launches {launches}", flush=True)
    del system
    torch.cuda.empty_cache()

    # an unsupported configuration raises on the card and runs nothing
    small = unstructured_box_tets(4)
    bad = FEMSystem(small, mat, True, SolverConfig(
        device_loop=True, stabilize_factor=2e-4), device=DEVICE)
    zero_launches()
    try:
        bad.solve(twist_model(small), user_dirichlet=hook)
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    check(raised.startswith("device_loop:"),
          f"device_loop with stabilize_factor did not raise ({raised!r})")
    check(not any(read_launches().values()) and not bad.timer.records,
          "the refused device loop launched work")
    print(f"{label}: stabilize_factor refused on the card ({raised!r}); "
          f"phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, history


def window_spmv_checks(torch, card, results):
    """P1's windowed entry point (the slab's halo SpMV) against its plain
    version, in float32 and float64, at the slab shape of the NX=56 box in
    4 slabs (14 cell planes a slab, ps = 3 * 57 * 57 rows a plane, K = 59,
    x the slab's rows with 2 planes of halo each side), on seeded values;
    in float64 timed in turns with the plain version, beside the plain P1
    on the same rows and cuSPARSE's CSR matvec of the window's entries.
    Fills results[dtype]["dia_spmv_window"]."""
    from femcy_tpu_torch.kernels import dia_spmv as k_spmv
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.parallel.structured import (
        HALO_PLANES,
        build_structured_shard_plan,
    )
    from femcy_tpu_torch.solvers.dia import dia_spmv_window

    plan = build_structured_shard_plan(box_tets(*FULL), SLABS)
    L, K, H = plan.local_rows, len(plan.offsets), HALO_PLANES * plan.ps
    rng = np.random.default_rng(5)
    v_np = rng.standard_normal((L, K))
    x_np = rng.standard_normal(L + 2 * H)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        vals = torch.as_tensor(v_np, dtype=dtype, device=DEVICE)
        x = torch.as_tensor(x_np, dtype=dtype, device=DEVICE)
        wplan = k_spmv.spmv_plan(L, plan.offsets, DEVICE)
        vt = k_spmv.prep_values(wplan, vals)
        y_k = k_spmv.spmv_window(wplan, vt, x, H)
        y_p = dia_spmv_window(vals, plan.offsets, x, H)
        torch.cuda.synchronize()
        abs_err = float((y_k - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        check(rel <= TOL[name], f"P1 window {name}: {rel:.3e}")
        check(torch.equal(y_k, k_spmv.spmv_window(wplan, vt, x, H)),
              f"P1 window {name}: rerun not bit-identical")
        # the same rows as a square operator through the plain P1 kernel
        xs = x[H:H + L].contiguous()
        y_sq = k_spmv.spmv(wplan, vt, xs)
        cols = (torch.arange(L, device=DEVICE)[:, None] + H
                + torch.as_tensor(plan.offsets, device=DEVICE)[None])
        keep = torch.ones_like(cols, dtype=torch.bool)
        lib = csr_matvec(keep, cols, vals, x.shape[0])
        check(float((lib(x) - y_p).abs().max()) <= TOL[name] * float(
            y_p.abs().max()), "P1 window's CSR yardstick disagrees")
        ms, pms, lms = in_turns(
            lambda: dia_spmv_window(vals, plan.offsets, x, H),
            lambda: k_spmv.spmv_window(wplan, vt, x, H), 20, 50,
            lambda: lib(x))
        sq_ms = cuda_ms(lambda: k_spmv.spmv(wplan, vt, xs), 50)
        isz = vals.element_size()
        b = bound((K * L + L + x.shape[0]) * isz + 4 * K, 2 * K * L, name)
        print(f"P1 window {name} on {card}: {L} rows, K {K}, x {x.shape[0]} "
              f"(base {H}); rel err {rel:.3e} (tol {TOL[name]:.0e}); kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, plain P1 on the same rows "
              f"{sq_ms:.4f} ms, CSR matvec (cuSPARSE) {lms:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]})", flush=True)
        del y_sq, lib, cols, keep
        results.setdefault(name, {})["dia_spmv_window"] = row(
            abs_err, ms, pms, lms, b)


def arch_model(nx: int, ny: int):
    """femcy_tpu's snap-through arch (its tests/test_dynamic_rescue.py
    fixture, at nx x ny CPE4): span 100, rise ARCH_RISE, thickness 0.8,
    the mid-thickness end nodes hinged, a pressure of 0.2 on the top
    faces, E 1000, nu 0.3, geometric nonlinearity; *Static 0.05, 1,
    1e-5, 0.1."""
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel, NeumannBC

    span, rise, thick = 100.0, ARCH_RISE, 0.8
    radius = (span / 2) ** 2 / (2 * rise) + rise / 2
    th0 = np.arcsin((span / 2) / radius)
    j, i = np.meshgrid(np.arange(ny + 1), np.arange(nx + 1), indexing="ij")
    r = radius - thick / 2 + thick * j / ny
    phi = -th0 + 2 * th0 * i / nx
    nodes = np.stack([r * np.sin(phi), r * np.cos(phi)], -1).reshape(-1, 2)

    def nid(i, j):
        return j * (nx + 1) + i

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    elems = np.stack([nid(ii, jj), nid(ii + 1, jj), nid(ii + 1, jj + 1),
                      nid(ii, jj + 1)], -1).astype(np.int32)
    ends = np.array([nid(0, ny // 2), nid(nx, ny // 2)])
    top = [tuple(sorted((nid(k, ny), nid(k + 1, ny)))) for k in range(nx)]
    return InpModel(
        nodes=nodes, elements=elems, element_type="CPE4", node_sets={},
        ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(ends, 0, 0.0), DirichletBC(ends, 1, 0.0)],
        neumann_bcs=[NeumannBC(face_set=top, traction=-0.2, direction=None)],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.05, max_time=1.0, min_inc=1e-5, max_inc=0.1),
    )


def arch_inp_text(model) -> str:
    """``arch_model``'s model as an Abaqus .inp (the hinge node set, the
    top faces as an element-based *Surface under a *Dsload P)."""
    from femcy_tpu_torch.elements import get_element

    elem = get_element("CPE4")
    lines = ["*Heading", "snap-through arch", "*Node"]
    lines += [f"{i + 1}, {x!r}, {y!r}" for i, (x, y) in
              enumerate(model.nodes.tolist())]
    lines.append("*Element, type=CPE4")
    lines += [f"{e + 1}, " + ", ".join(str(n + 1) for n in conn)
              for e, conn in enumerate(model.elements.tolist())]
    top = {n for face in model.neumann_bcs[0].face_set for n in face}
    faces = {}
    for e, conn in enumerate(model.elements.tolist()):
        for k, facets in enumerate(elem.inp_surface_num):
            if {conn[ln] for f in facets for ln in f} <= top:
                faces.setdefault(k + 1, []).append(e + 1)
    hinge = model.dirichlet_bcs[0].node_set
    lines += ["*Nset, nset=hinge, instance=a",
              ", ".join(str(n + 1) for n in hinge)]
    for k, eles in faces.items():
        lines += [f"*Elset, elset=_t{k}, internal, instance=a",
                  ", ".join(str(e) for e in eles)]
    lines.append("*Surface, type=ELEMENT, name=top")
    lines += [f"_t{k}, S{k}" for k in faces]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              "*Step, name=s, nlgeom=YES", "*Static", "0.05, 1., 1e-05, 0.1",
              "*Boundary", "hinge, 1, 1", "hinge, 2, 2", "*Dsload",
              "top, P, 0.2", "*End Step"]
    return "\n".join(lines) + "\n"


class _Warnings:
    """Collects the WARNING records of the femcy_tpu_torch logger while
    installed."""

    def __init__(self):
        import logging

        self.lines = []
        self._log = logging.getLogger("femcy_tpu_torch")
        self._handler = logging.Handler(logging.WARNING)
        self._handler.emit = lambda rec: self.lines.append(rec.getMessage())

    def __enter__(self):
        self._log.addHandler(self._handler)
        return self.lines

    def __exit__(self, *exc):
        self._log.removeHandler(self._handler)


class _Increments:
    """While installed, wraps ``FEMSystem.solve`` so that every call also
    records the (record, dof) pair of each converged increment, beside any
    ``on_increment`` of the caller; keeps the last call's system and
    report.  The arithmetic is the caller's own."""

    def __enter__(self):
        from femcy_tpu_torch.system import FEMSystem

        self.seen, self.system, self.report = [], None, None
        self._inner = inner = FEMSystem.solve

        def solve(system, inp, *args, on_increment=None, **kwargs):
            def tee(s_, r):
                self.seen.append((r, s_.dof.cpu().numpy()))
                if on_increment is not None:
                    on_increment(s_, r)

            self.seen.clear()
            self.system = system
            self.report = inner(system, inp, *args, on_increment=tee,
                                **kwargs)
            return self.report

        FEMSystem.solve = solve
        return self

    def __exit__(self, *exc):
        from femcy_tpu_torch.system import FEMSystem

        FEMSystem.solve = self._inner


def rescue_newmark_h(system):
    """Wraps ``system._advance_inc`` to record the Newmark step size of
    every rescue step (h = 1 / sqrt(beta * scale) from the inertia hook's
    scale, while the hook carries a nonzero one); returns the list."""
    hs = []
    gamma = system.config.dynamic_gamma
    beta = 0.25 * (gamma + 0.5) ** 2
    inner = system._advance_inc

    def advance(rhs, fixed, sval, on_newton=None):
        if system._stab_diag is not None and float(system._stab_scale) > 0.0:
            hs.append(1.0 / np.sqrt(beta * float(system._stab_scale)))
        return inner(rhs, fixed, sval, on_newton)

    system._advance_inc = advance
    return hs


def last_attempt(torch, system, recs, seen):
    """Sets ``system`` to resume a run at the last attempt of its cutback
    cascade before the rescue: the dof of the run's last converged record
    before the rescue's (from ``seen``, the (record, dof) pairs of its
    ``on_increment``), that record's time, and the dt of the attempt that
    took dt below min_inc (the dt stored with the record before the
    cascade's last failure).  The attempt is the same computation as in
    the run, and after it the same rescue.  Returns (index of the rescue's
    record, index of that converged record)."""
    k = next(j for j, r in enumerate(recs)
             if r.converged and r.residual == 0.0)
    i = [j for j in range(k) if recs[j].converged][-1]
    check(not recs[k - 1].converged and k - 2 >= i,
          f"rescue records before the rescue: {recs[i:k]}")
    system.dof = torch.as_tensor(next(d for r, d in seen if r is recs[i]),
                                 device=DEVICE)
    system.time0 = system.time1 = recs[i].time
    system.dt = recs[k - 2].dt
    return k, i


def rescue_run(torch, card):
    """Phase 31: the snap-through arch at ARCH_FINE through FEMSystem on
    the card, f64, the consistent tangent: with ``dynamic_rescue`` the
    analysis snaps through (success, time0 == 1, apex below -2 rise) with
    the rescue's (t_resc, Newmark steps) against EXPECTED_RESCUE, M4 and M1
    once per evaluation (and the rescue's stiffness probe) and no other
    kernel; the static control, resumed without the rescue at the last
    attempt of that run's cutback cascade (``last_attempt``), aborts
    "WITHIN the increment" at the same time; a static resume of the
    rescued state moves dof by <= 1e-9.  Prints the Newmark steps, h/h0
    at the end, the evaluations, the consistent tangent's ms an evaluation
    and the launches.  Returns (launches, min uy)."""
    from femcy_tpu_torch import FEMSystem, SolverConfig, material_from_inp
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.mesh import FEMesh

    t_phase = time.perf_counter()
    model = arch_model(*ARCH_FINE)
    mat = material_from_inp(model.material_type, model.material_params,
                            model.element_type)
    mesh = FEMesh(model.nodes, model.elements, model.element)

    def system(**cfg):
        return FEMSystem(mesh, mat, True,
                         SolverConfig(tangent="consistent", **cfg),
                         device=DEVICE)

    rescued = system(dynamic_rescue=True)
    hs = rescue_newmark_h(rescued)
    seen = []  # (record, dof at its end) of every converged increment
    zero_launches()
    with _Warnings() as warns:
        t = time.perf_counter()
        rep = rescued.solve(model, on_increment=lambda s_, r: seen.append(
            (r, s_.dof.cpu().numpy())))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = read_launches()
    evals = sum(r.name == "newton_eval" for r in rescued.timer.records)
    uy = rescued.dof.cpu().numpy().reshape(-1, 2)[:, 1]
    check(rep.success and rescued.time0 == 1.0,
          f"arch rescue: {rep.success}, time0 {rescued.time0}, "
          f"{rep.message}")
    check(uy.min() < -2 * ARCH_RISE, f"arch rescue: min uy {uy.min()}")

    static = system()
    k, i = last_attempt(torch, static, rep.increments, seen)
    t_fail = static.time0
    t = time.perf_counter()
    rep0 = static.solve(model, resume=True)
    static_s = time.perf_counter() - t
    check(not rep0.success and "WITHIN the increment" in rep0.message
          and static.time0 == t_fail,
          f"arch static control: {rep0.success} at t {static.time0}, "
          f"{rep0.message}")
    print(f"rescue, static control on {card}: {mesh.n_elements} CPE4, "
          f"{mesh.n_dof} dofs; resumed at t {t_fail:.6f} (record {i}) at "
          f"the dt of the rescue run's last attempt there "
          f"({rep.increments[k - 2].dt:.4g}), aborted after {len(rep0.increments)} records in {static_s:.2f} "
          f"s: {rep0.message}", flush=True)
    del static

    rec = [r for r in rep.increments if r.converged and r.residual == 0.0]
    check(len(rec) == 1 and rec[0].time > t_fail,
          f"arch rescue: rescue records {rec}")
    got = (round(rec[0].time, 9), rec[0].newton_iters)
    check(got == EXPECTED_RESCUE, f"arch rescue: (t_resc, Newmark steps) "
          f"{got}, {EXPECTED_RESCUE} expected")
    # the rescue's stiffness probe is one more evaluation, outside the
    # Newton loop's timer section
    check(launches["internal_force"] == evals + 1
          and launches["ell_scatter"] == evals + 1,
          f"arch rescue: M4 {launches['internal_force']}, M1 "
          f"{launches['ell_scatter']} for {evals} evaluations and the probe")
    for name, n in launches.items():
        if name not in ("internal_force", "ell_scatter"):
            check(n == 0, f"arch rescue: {name} launched {n} times")
    check(any("attempting implicit-dynamics traversal" in w for w in warns)
          and any(w.endswith("resuming statics") for w in warns),
          f"arch rescue warnings: {warns}")
    # the consistent tangent alone, at the final state
    a = rescued._arrs
    ms_ct = cuda_ms(lambda: assembly.consistent_tangent(
        rescued.dof, a["elements"], a["nodes"], a["dN"], a["w"], mat), 5)
    print(f"rescue on {card}: {wall:.2f} s, {len(rep.increments)} records, "
          f"{evals} evaluations (newton_eval "
          f"{sum(r.seconds for r in rescued.timer.records if r.name == 'newton_eval'):.2f} s, "
          f"linear_solve "
          f"{sum(r.seconds for r in rescued.timer.records if r.name == 'linear_solve'):.2f} s); "
          f"t_resc {rec[0].time:.9f}, {rec[0].newton_iters} Newmark steps, "
          f"h/h0 at the end {hs[-1] / hs[0]:.4g} ({len(hs)} step attempts); "
          f"consistent tangent {ms_ct:.3f} ms an evaluation; min uy "
          f"{uy.min():.9f}; launches {launches}; warnings {warns}",
          flush=True)
    dof_end = rescued.dof.clone()
    rescued.config = SolverConfig(tangent="consistent")
    del rescued._advance_inc  # the Newmark step probe
    rescued.dt = 0.05
    rep2 = rescued.solve(model, resume=True)
    moved = float((rescued.dof - dof_end).abs().max())
    check(rep2.success and moved <= 1e-9,
          f"arch rescue: static resume {rep2.success}, moved {moved:.3e}")
    print(f"rescue: the static resume moved dof by {moved:.3e}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del rescued
    torch.cuda.empty_cache()
    return launches, float(uy.min())


def rescue_cli_run(torch, card):
    """Phase 32, first half: ``cli.main`` with --dynamic-rescue on phase
    31's arch at femcy_tpu's fixture size ARCH_FIXTURE as an .inp (exit
    0, the rescue's two warning lines), its FEMSystem.solve recorded by
    ``_Increments``: success, one rescue record, against
    EXPECTED_RESCUE_FIXTURE.  This run is the single-device reference of
    the two-block and banded rescues (the CLI's model is ``arch_model``'s
    to the bit: the same records and dof on the CPU).  Returns (records,
    (record, dof) pairs, min uy)."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "arch.inp"
        path.write_text(arch_inp_text(arch_model(*ARCH_FIXTURE)))
        with _Warnings() as warns, _Increments() as run:
            rc, _, _, _, cli_s = run_cli([str(path), "--tangent",
                                          "consistent", "--dynamic-rescue"])
    resc = [w for w in warns if "rescue" in w]
    check(rc == 0 and len(resc) == 2
          and "attempting implicit-dynamics traversal" in resc[0]
          and resc[1].endswith("resuming statics"),
          f"CLI --dynamic-rescue: rc {rc}, warnings {warns}")
    recs = run.report.increments
    rec = [r for r in recs if r.converged and r.residual == 0.0]
    check(run.report.success and len(rec) == 1,
          f"arch rescue at {ARCH_FIXTURE}: {run.report.success}, records "
          f"{rec}")
    got = (round(rec[0].time, 9), rec[0].newton_iters)
    check(got == EXPECTED_RESCUE_FIXTURE, f"arch rescue at {ARCH_FIXTURE}: "
          f"(t_resc, Newmark steps) {got}, {EXPECTED_RESCUE_FIXTURE} "
          "expected")
    uy = float(run.system.dof.cpu().numpy().reshape(-1, 2)[:, 1].min())
    print(f"rescue, CLI on {card}: rc {rc} in {cli_s:.2f} s, "
          f"{len(recs)} records, the rescue's record {recs.index(rec[0])} "
          f"at t {rec[0].time:.9f} ({rec[0].newton_iters} Newmark steps), "
          f"min uy {uy:.9f}; warnings {resc}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    seen = list(run.seen)
    del run
    return recs, seen, uy


def rescue_blocks_run(torch, card, uy_ref):
    """Phase 32, second half: phase 31's arch at ARCH_FINE in two
    ElementBlocks (its elements in order, halved: the lower and the upper
    half of the thickness) through ``MultiBlockSystem.solve_nonlinear``
    with the rescue: success, min uy within 1e-6 relative of phase 31's
    (``uy_ref``), M4 and M1 once per block and evaluation.  Returns the
    launches."""
    from femcy_tpu_torch import (
        ElementBlock,
        MultiBlockSystem,
        SolverConfig,
        material_from_inp,
    )
    from femcy_tpu_torch.elements import get_element

    model = arch_model(*ARCH_FINE)
    mat = material_from_inp(model.material_type, model.material_params,
                            model.element_type)
    half = len(model.elements) // 2
    blocks = [ElementBlock(model.elements[:half], get_element("CPE4"), mat,
                           "l"),
              ElementBlock(model.elements[half:], get_element("CPE4"), mat,
                           "r")]
    system = MultiBlockSystem(
        model.nodes, blocks,
        SolverConfig(tangent="consistent", dynamic_rescue=True),
        device=DEVICE)
    evals = {"n": 0}
    inner = system._newton_eval

    def counted(*args):
        evals["n"] += 1
        return inner(*args)

    system._newton_eval = counted
    zero_launches()
    t = time.perf_counter()
    rep = system.solve_nonlinear(model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    uy = system.dof.cpu().numpy().reshape(-1, 2)[:, 1]
    rel = abs(uy.min() - uy_ref) / abs(uy_ref)
    check(rep.success and rel <= 1e-6,
          f"two-block rescue: {rep.success}, min uy {uy.min()} vs "
          f"{uy_ref} ({rel:.3e})")
    n = evals["n"]
    check(launches["internal_force"] == 2 * n
          and launches["ell_scatter"] == 2 * n,
          f"two-block rescue: M4 {launches['internal_force']}, M1 "
          f"{launches['ell_scatter']} for {n} evaluations of 2 blocks")
    steps = [r.newton_iters for r in rep.increments
             if r.converged and r.residual == 0.0]
    print(f"rescue, two blocks on {card}: {wall:.2f} s, "
          f"{n} evaluations, Newmark steps {steps}, min uy {uy.min():.9f} "
          f"(rel {rel:.3e} to one block); launches {launches}", flush=True)
    del system
    return launches


def slab_linear_run(torch, card):
    """Phase 33: box_tets(56) (z = 0 clamped, ux = 0.01 on z = 1) through
    FEMSystem(sharding="slab", sharding_devices=SLABS) with the multigrid
    and with the Jacobi CG at cg_eps 1e-10, each against the single-device
    FEMSystem at the same cg_eps: dof within 1e-7 relative (inf-norm); the
    windowed P1 launched, P2 SLABS times an assembly, P1 in the inner
    multigrid.  Prints the CG iterations beside the single-device ones,
    the warm solve walls and the peak memory.  Returns ({path: launches},
    {path: iterations})."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import box_tets

    t_phase = time.perf_counter()
    mesh = box_tets(*FULL)
    inp = boundary_model(mesh, 0.01)
    mat = LinearIsotropic(1000.0, 0.3)
    by_path, iters = {}, {}
    for prec in ("multigrid", "jacobi"):
        walls, dofs, its = {}, {}, {}
        for label, extra in (("single", {}),
                             ("slab", dict(sharding="slab",
                                           sharding_devices=SLABS))):
            system = FEMSystem(mesh, mat, config=SolverConfig(
                preconditioner=prec, cg_eps=1e-10, **extra), device=DEVICE)
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            check(system.solve(inp).success, f"slab {prec} {label} solve")
            torch.cuda.synchronize()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            its[label] = system._last_cg_iters
            t = time.perf_counter()
            system.solve(inp)
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t, peak)
            dofs[label] = system.dof.cpu().numpy()
            if label == "slab":
                check(launches["dia_spmv_window"] > 0
                      and launches["structured_accumulate"] == SLABS,
                      f"slab {prec}: launches {launches}")
                check(launches["structured_fused"] == 0,
                      f"slab {prec}: P3 launched {launches}")
                if prec == "multigrid":
                    check(launches["dia_spmv"] > 0,
                          f"slab multigrid: the inner cycle's P1 {launches}")
                by_path[f"slab, {prec}"] = launches
            del system
            torch.cuda.empty_cache()
        rel = float(np.abs(dofs["slab"] - dofs["single"]).max()
                    / np.abs(dofs["single"]).max())
        check(rel <= 1e-7, f"slab {prec}: dof vs single device {rel:.3e}")
        iters[f"slab, {prec}"] = its["slab"]
        print(f"slab linear, {prec}, {SLABS} slabs on {card}: CG "
              f"{its['slab']} iterations (single device {its['single']}), "
              f"dof rel {rel:.3e} of the single device; warm solve "
              f"{walls['slab'][0]:.4f} s (single device "
              f"{walls['single'][0]:.4f} s), peak memory "
              f"{walls['slab'][1] / 1e9:.3f} GB (single device "
              f"{walls['single'][1] / 1e9:.3f} GB); launches "
              f"{by_path[f'slab, {prec}']}", flush=True)
    print(f"slab linear: phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path, iters


def slab_newton_run(torch, card, single):
    """Phase 34: the pinned twist (TWIST) on box_tets(56) in SLABS slabs
    with the multigrid CG: the history against EXPECTED_NEWTON["box
    Newton"] (the single-device run's), dof within 1e-6 relative and
    elastic_energy within 1e-6 of the single-device run (``single``: its
    "dof" and "energy"), M5, P2 and the windowed P1 launched (M5 and P2
    SLABS times an evaluation); then one consistent-tangent slab
    evaluation at the final state against the single-device one, tangent
    values within 1e-12 relative.  Returns (launches, history)."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.parallel.structured import ShardedStructuredSolver
    from femcy_tpu_torch.user import make_rotation_dirichlet

    t_phase = time.perf_counter()
    mesh = box_tets(*FULL)
    mat = LinearIsotropic(1000.0, 0.3)
    inp = twist_model(mesh)
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0))
    system = FEMSystem(mesh, mat, True, SolverConfig(
        preconditioner="multigrid", linear_solver="cg", sharding="slab",
        sharding_devices=SLABS), device=DEVICE)
    zero_launches()
    t = time.perf_counter()
    report = system.solve(inp, user_dirichlet=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    evals = sum(r.name == "newton_eval" for r in system.timer.records)
    history = [(r.newton_iters, r.converged) for r in report.increments]
    energy = system.elastic_energy()
    rel = float(np.abs(system.dof.cpu().numpy() - single["dof"]).max()
                / np.abs(single["dof"]).max())
    rel_e = abs(energy - single["energy"]) / abs(single["energy"])
    print(f"slab Newton, {SLABS} slabs on {card}: {wall:.2f} s, {evals} "
          f"evaluations, history {history}, CG iterations "
          f"{system._cg_iters_log}, dof rel {rel:.3e} and energy rel "
          f"{rel_e:.3e} of the single device; launches {launches}",
          flush=True)
    check(report.success, f"slab Newton: {report.message}")
    check(history == EXPECTED_NEWTON["box Newton"],
          f"slab Newton: history {history}")
    check(rel <= 1e-6 and rel_e <= 1e-6,
          f"slab Newton vs single device: dof {rel:.3e}, energy {rel_e:.3e}")
    check(launches["structured_force"] == SLABS * evals
          and launches["structured_accumulate"] == SLABS * evals
          and launches["dia_spmv_window"] > 0,
          f"slab Newton: launches {launches} for {evals} evaluations")
    fixed, sval = system._last_dirichlet
    dof = system.dof
    del system
    torch.cuda.empty_cache()
    # one consistent-tangent evaluation, slab against single device
    ref = FEMSystem(mesh, mat, True, SolverConfig(tangent="consistent"),
                    device=DEVICE)
    zeros = torch.zeros_like(dof)
    _, v_ref, _, _, _ = ref._newton_eval(dof, zeros, fixed, sval)
    v_ref = v_ref.cpu().numpy()
    del ref
    sh = ShardedStructuredSolver(
        mesh, mat, devices=[DEVICE] * SLABS, tangent="consistent")
    t = time.perf_counter()
    _, v_s, _, _ = sh.newton_eval(sh.stack(dof), sh.stack(zeros),
                                  sh.stack(fixed), sh.stack(sval))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    rel_v = float(np.abs(sh.unstack(v_s) - v_ref).max()
                  / np.abs(v_ref).max())
    check(rel_v <= 1e-12, f"slab consistent tangent vs single: {rel_v:.3e}")
    print(f"slab Newton, consistent tangent: one slab evaluation "
          f"{eval_s:.3f} s, values rel {rel_v:.3e} of the single device's; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    del sh, v_s
    torch.cuda.empty_cache()
    return launches, history


def clamp_top_ux(mesh, ux: float):
    """``boundary_model``'s arrays: z = 0 clamped, ux on z = max; (rhs,
    fixed, sval) numpy."""
    bottom, top = z_faces(mesh)
    fixed = np.zeros(mesh.n_dof, bool)
    sval = np.zeros(mesh.n_dof)
    for d in range(3):
        fixed[bottom * 3 + d] = True
    fixed[top * 3] = True
    sval[top * 3] = ux
    return np.zeros(mesh.n_dof), fixed, sval


def host_residual(K, x, rhs, fixed, sval) -> float:
    """max|K x - rhs| over the free rows of the f64 host operator K (no
    boundary conditions), relative to the largest entry of the eliminated
    right-hand side (rhs - K x_c on the free rows), with x's prescribed
    entries set to sval."""
    x = np.where(fixed, sval, x)
    free = ~fixed
    b = rhs - K @ np.where(fixed, sval, 0.0)
    r = K @ x - rhs
    return float(np.abs(r[free]).max() / np.abs(b[free]).max())


def sharded_ell_run(torch, card, host_K):
    """Phase 35: unstructured_box_tets(56) (``clamp_top_ux``, ux 0.01)
    through ``ShardedLinearSolver`` in SHARDS shards on the one card: at
    cg_eps 1e-3 its CG iterations (pinned as "sharded ELL", printed beside
    the single-device ELL slice's 312), M1 SHARDS times (M7: one partial a
    shard) and M2 SHARDS times an iteration; at cg_eps 1e-10 x within 1e-8
    (inf-norm, relative) of the single-device FEMSystem's Jacobi CG at the
    same cg_eps and its f64 host residual (``host_K``) below 1e-8; then
    one ``ShardedNewtonStep`` at a seeded state, cg_eps 1e-10, against
    the single-device evaluation: rms within 1e-10 relative, and its step
    du = pinned dof - new dof solves the single device's tangent system,
    max|K du - r| / max|r| below 1e-8 (K and r the single-device
    evaluation's, the product the plain ELL SpMV; the same gate for the
    single device's own CG at 1e-10).  The gate holds wherever either CG
    stopped: two Jacobi CGs that sum in other orders stop at other
    iterates, so the two new dofs are printed beside each other but not
    compared.  M1 and M4 SHARDS times.  Returns ({path: launches},
    {path: iterations})."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import unstructured_box_tets
    from femcy_tpu_torch.parallel import ShardedLinearSolver, ShardedNewtonStep
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain
    from femcy_tpu_torch.topology import build_pattern

    t_phase = time.perf_counter()
    mesh = unstructured_box_tets(UNSTRUCT[-1])
    mat = LinearIsotropic(1000.0, 0.3)
    rhs, fixed, sval = clamp_top_ux(mesh, 0.01)
    pattern = build_pattern(mesh)
    devices = [DEVICE] * SHARDS
    t = time.perf_counter()
    sh = ShardedLinearSolver(mesh, mat, devices=devices, cg_eps=1e-3,
                             pattern=pattern)
    setup_s = time.perf_counter() - t
    zero_launches()
    t = time.perf_counter()
    x3, it3 = sh.solve(rhs, fixed, sval)
    torch.cuda.synchronize()
    solve3_s = time.perf_counter() - t
    launches = read_launches()
    check(launches["ell_scatter"] == SHARDS
          and launches["ell_spmv"] == SHARDS * it3,
          f"sharded ELL: launches {launches} for {it3} iterations")
    for name, n in launches.items():
        if name not in ("ell_scatter", "ell_spmv"):
            check(n == 0, f"sharded ELL: {name} launched {n} times")
    check(np.isfinite(x3).all() and np.abs(x3).max() > 0, "sharded ELL: x")
    del sh
    sh = ShardedLinearSolver(mesh, mat, devices=devices, cg_eps=1e-10,
                             pattern=pattern)
    t = time.perf_counter()
    x10, it10 = sh.solve(rhs, fixed, sval)
    solve10_s = time.perf_counter() - t
    del sh
    single = FEMSystem(mesh, mat, config=SolverConfig(
        cg_eps=1e-10, linear_solver="cg"), device=DEVICE)
    check(single.solve(boundary_model(mesh, 0.01)).success,
          "sharded ELL: the single-device solve")
    x_single = single.dof.cpu().numpy()
    it_single = single._last_cg_iters
    del single
    rel = float(np.abs(x10 - x_single).max() / np.abs(x_single).max())
    res = host_residual(host_K, x10, rhs, fixed, sval)
    check(rel <= 1e-8, f"sharded ELL vs single device at 1e-10: {rel:.3e}")
    check(res <= 1e-8, f"sharded ELL: f64 host residual {res:.3e}")
    print(f"sharded ELL, {SHARDS} shards on {card}: {mesh.n_dof} dofs, setup "
          f"{setup_s:.2f} s; cg_eps 1e-3: CG {it3} iterations (the "
          f"single-device ELL slice {EXPECTED_CG_ITERS['ELL slice']}) in "
          f"{solve3_s:.3f} s; cg_eps 1e-10: {it10} iterations (single "
          f"device {it_single}) in {solve10_s:.3f} s, x rel {rel:.3e} of the "
          f"single device's, f64 host residual {res:.3e}; launches "
          f"{launches}", flush=True)
    torch.cuda.empty_cache()

    # one Newton step, sharded against the single device
    rng = np.random.default_rng(4)
    dof0 = 1e-3 * rng.standard_normal(mesh.n_dof)
    f_ext = np.zeros(mesh.n_dof)
    _, top = z_faces(mesh)
    f_ext[top * 3 + 1] = 1e-3
    step = ShardedNewtonStep(mesh, mat, devices=devices, cg_eps=1e-10,
                             pattern=pattern)
    zero_launches()
    t = time.perf_counter()
    d_sh, rms_sh, k_sh = step.step(dof0, f_ext, fixed, sval)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    step_launches = read_launches()
    d_sh = d_sh.cpu().numpy()
    del step
    single = FEMSystem(mesh, mat, True, SolverConfig(
        cg_eps=1e-10, linear_solver="cg"), device=DEVICE)

    def dev(a, dt=torch.float64):
        return torch.as_tensor(a, dtype=dt, device=DEVICE)

    dof_p, values, residual, rms, _ = single._newton_eval(
        dev(dof0), dev(f_ext), dev(fixed, torch.bool), dev(sval))
    du = single._solve_linear_system(values, residual, dev(fixed, torch.bool))
    k_single = single._last_cg_iters
    colidx = single._arrs["colidx"]

    def step_residual(step):
        r = ell_spmv_plain(values, colidx, step) - residual
        return float(r.abs().max() / residual.abs().max())

    res_sh = step_residual(dof_p - dev(d_sh))
    res_single = step_residual(du)
    d_single = (dof_p - du).cpu().numpy()
    del single, values, residual, du, colidx
    rel_d = float(np.abs(d_sh - d_single).max() / np.abs(d_single).max())
    rel_r = abs(float(rms_sh) - float(rms)) / float(rms)
    check(step_launches["ell_scatter"] == SHARDS
          and step_launches["internal_force"] == SHARDS
          and step_launches["ell_spmv"] == SHARDS * k_sh,
          f"sharded Newton step: launches {step_launches}")
    check(rel_r <= 1e-10 and res_sh <= 1e-8 and res_single <= 1e-8,
          f"sharded Newton step vs the single-device evaluation: rms "
          f"{rel_r:.3e}, step residual {res_sh:.3e} (single device's CG "
          f"{res_single:.3e})")
    print(f"sharded Newton step on {card}: {step_s:.3f} s, CG {k_sh} "
          f"iterations (single device {k_single}), rms rel {rel_r:.3e} of "
          f"the single device's; max|K du - r|/max|r| on the single "
          f"device's tangent {res_sh:.3e} (its own CG's {res_single:.3e}); "
          f"new dof rel {rel_d:.3e} of the single device's (not gated); "
          f"launches {step_launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return ({"sharded ELL": launches, "sharded Newton step": step_launches},
            {"sharded ELL": it3})


def m7_checks(torch, card, results):
    """Phase 36, M7: shard 0 of SHARDS of the ELL slice's mesh: M1 and M4
    on the shard's plan bit for bit against their plain versions run on
    the CPU, in float32 and float64, and timed in float64 in turns with
    the plain versions and one ``index_add_`` over the shard's targets,
    beside the bound (the shard's Ke or f_e, its plan and the full-height
    partial)."""
    from femcy_tpu_torch import assembly
    from femcy_tpu_torch.kernels import ell_scatter as k_scat
    from femcy_tpu_torch.kernels import internal_force as k_force
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import unstructured_box_tets
    from femcy_tpu_torch.parallel.sharded import (
        build_sharded_operands,
        shard_element_ids,
    )
    from femcy_tpu_torch.topology import build_pattern

    t_phase = time.perf_counter()
    mesh = unstructured_box_tets(UNSTRUCT[-1])
    mat = LinearIsotropic(1000.0, 0.3)
    pattern = build_pattern(mesh)
    ops = build_sharded_operands(mesh, mat, SHARDS, pattern=pattern)
    ids = shard_element_ids(ops, 0)
    t = time.perf_counter()
    plan = k_scat.build_scatter_plan(pattern, DEVICE, elements=ids)
    plan_s = time.perf_counter() - t
    f_np = np.random.default_rng(9).standard_normal(
        (ids.shape[0], mesh.element.n_nodes, mesh.dm))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)

        elements = torch.as_tensor(mesh.elements[ids].astype(np.int64),
                                   device=DEVICE)
        dsdx, vol = assembly.gradients_and_volume(
            dev(mesh.nodes), elements, dev(mesh.element.dshape_at_gp),
            dev(mesh.element.gauss_weights))
        Ke = assembly.element_stiffness(dsdx, vol, dev(mat.C))
        del dsdx, vol
        v_k, abs1 = m1_against_cpu_plain(torch, Ke, plan, f"M7 shard {name}")
        f_e = dev(f_np)
        f_k, abs4 = m4_against_cpu_plain(torch, f_e, plan, f"M7 shard {name}")
        print(f"M7 on {card}, shard 0 of {SHARDS} ({ids.shape[0]} of "
              f"{mesh.n_elements} elements, plan {plan_s:.2f} s) {name}: M1 "
              "and M4 on the shard's plan bit-equal to their CPU plain "
              "versions, bit-identical reruns", flush=True)
        if dtype == torch.float64:
            targets = k_scat.contribution_targets(plan)
            lib_out = torch.zeros(plan.out_shape, dtype=dtype,
                                  device=DEVICE).view(-1)
            ke_flat = Ke.view(-1)
            ms, pms, lms = in_turns(
                lambda: k_scat.scatter_plain(Ke, plan),
                lambda: k_scat.scatter(Ke, plan), 3, 10,
                lambda: lib_out.zero_().index_add_(0, targets, ke_flat))
            del targets, lib_out
            isz = Ke.element_size()
            b = bound((Ke.numel() + v_k.numel()) * isz + plan_bytes(plan),
                      Ke.numel(), name)
            f_row = m4_timing(torch, card, f_e, f_k, abs4, plan,
                              f"M7 force, shard 0 of {SHARDS}")
            print(f"timing M7 on {card}, shard 0 of {SHARDS} {name}: "
                  f"stiffness partial (M1) {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"index_add_ {lms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); "
                  f"force partial (M4) {f_row['ms']:.4f} ms, bound "
                  f"{f_row['bound_ms']:.4f} ms", flush=True)
            results[name]["ell_scatter_shard"] = row(abs1, ms, pms, lms, b)
        del Ke, v_k, f_e, f_k
    del plan, ops
    torch.cuda.empty_cache()
    print(f"M7 checks: phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def m8_checks(torch, card, sh, results):
    """Phase 36, M8: the stiffness and force plans of shard 0 of the
    banded cell (``sh``, phase 37's solver) on seeded entries in float32
    and float64, bit for bit against the plain version run on the CPU and
    against a rerun; timed in float64 in turns with the plain version and
    one zeroed ``index_add_`` over the prebuilt targets, beside the bound
    (entries and plan read once, the whole output written once)."""
    from femcy_tpu_torch.kernels import btd_scatter

    s = sh.shards[0]
    rng = np.random.default_rng(11)
    for kind, plan in (("stiffness", s.plan_k), ("force", s.plan_f)):
        vals_np = rng.standard_normal(plan.n_entries)
        cpu_plan = plan_to(torch, plan, "cpu")
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            vals = torch.as_tensor(vals_np, dtype=dtype, device=DEVICE)
            out = btd_scatter.scatter(vals, plan)
            ref = btd_scatter.scatter_plain(vals.cpu(), cpu_plan)
            got = out.cpu()
            abs_err = float((got - ref).abs().max())
            check(torch.equal(got, ref), f"M8 {kind} {name}: not bit-equal "
                  f"to the CPU plain version ({abs_err:.3e})")
            check(torch.equal(out, btd_scatter.scatter(vals, plan)),
                  f"M8 {kind} {name}: rerun not bit-identical")
            del got, ref
            msg = (f"M8 {kind} on {card}, shard 0 of {SHARDS} {name}: "
                   f"{plan.n_entries} entries, {plan.run_target.numel()} "
                   f"runs into {plan.n_out} slots: bit-equal to the CPU "
                   "plain version, bit-identical rerun")
            if dtype == torch.float64:
                targets = btd_scatter.targets_of(plan)
                lib_out = torch.empty_like(out)
                ms, pms, lms = in_turns(
                    lambda: btd_scatter.scatter_plain(vals, plan),
                    lambda: btd_scatter.scatter(vals, plan), 2, 5,
                    lambda: lib_out.zero_().index_add_(0, targets, vals))
                del targets, lib_out
                isz = vals.element_size()
                n_bytes = ((plan.n_entries + plan.n_out) * isz
                           + plan.order.numel() * plan.order.element_size()
                           + (plan.run_start.numel()
                              + plan.run_target.numel()) * 8)
                b = bound(n_bytes, plan.n_entries, name)
                msg += (f"; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                        f"index_add_ {lms:.4f} ms, bound {b[0]:.4f} ms "
                        f"({b[1]}, {n_bytes / 1e9:.3f} GB)")
                if kind == "stiffness":
                    results[name]["btd_scatter"] = row(abs_err, ms, pms, lms,
                                                       b)
            print(msg, flush=True)
            del vals, out
        torch.cuda.empty_cache()


def banded_cell_run(torch, card, results):
    """Phases 36 (M8) and 37: BANDED_SWEEP.json's largest cell,
    cantilever_tets(400, 20) (530,523 dofs) with its loading (the x = 0
    end clamped, a unit x-force on every node of the x = 10 end; as
    tools/banded_cell.py loads it), through ``BandedShardedSolver`` in
    SHARDS shards on the one card, twolevel, cg_eps 1e-5: B 1328 and nbl
    100, M8 checked and timed on shard 0's plans (``m8_checks``) before
    the solve, then the solve (M8 once a shard), its iterations (pinned as
    "banded cell", beside the JAX CPU sweep's 48), the setup, assembly,
    factor and CG walls, peak device memory, and the f64 host residual
    below 1e-4 (the CG stops at 1e-5 of its initial residual); the
    Thomas sweep's and the SpMV's device ms once each.  Returns
    ({path: launches}, {path: iterations})."""
    from femcy_tpu_torch.assembly_host import assemble_csr_host
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import cantilever_tets
    from femcy_tpu_torch.parallel import banded as pb
    from femcy_tpu_torch.topology import build_pattern

    t_phase = time.perf_counter()
    mesh, fixed_nodes, loaded = cantilever_tets(*BANDED_CELL)
    mat = LinearIsotropic(1000.0, 0.3)
    fixed = np.zeros(mesh.n_dof, bool)
    for d in range(3):
        fixed[fixed_nodes * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    rhs[loaded * 3] = 1.0
    sval = np.zeros(mesh.n_dof)
    t = time.perf_counter()
    pattern = build_pattern(mesh)
    pattern_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sh = pb.BandedShardedSolver(mesh, mat, devices=[DEVICE] * SHARDS,
                                cg_eps=1e-5, pattern=pattern)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    ops = sh.ops
    print(f"banded cell: cantilever_tets{BANDED_CELL}, {mesh.n_elements} "
          f"tets, {mesh.n_dof} dofs, B {ops.B}, nbl {ops.nbl}, "
          f"{SHARDS} shards of up to {ops.elements.shape[1]} elements; host "
          f"ELL pattern {pattern_s:.2f} s, solver setup (RCM, operands, "
          f"coarse basis, M8 plans) {setup_s:.2f} s", flush=True)
    check((ops.B, ops.nbl) == BANDED_CELL_BLOCKS, f"banded cell: B {ops.B}, "
          f"nbl {ops.nbl}, expected {BANDED_CELL_BLOCKS}")
    m8_checks(torch, card, sh, results)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t = time.perf_counter()
    x, iters = sh.solve(rhs, fixed, sval)
    solve_s = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    walls = ", ".join(f"{k} {v:.3f} s" for k, v in sh.last_seconds.items())
    check(launches["btd_scatter"] == SHARDS,
          f"banded cell: M8 launched {launches['btd_scatter']} times")
    for name, n in launches.items():
        if name != "btd_scatter":
            check(n == 0, f"banded cell: {name} launched {n} times")
    check(np.isfinite(x).all() and np.abs(x).max() > 0, "banded cell: x")
    # one Thomas sweep (all shards) and one SpMV, device ms
    V = sh.assemble()
    fixed_s = list(sh._stack(fixed, fill=True))
    pb._btd_dirichlet(V, fixed_s, list(sh._stack(rhs)),
                      list(sh._stack(sval)))
    thomas, _, _ = sh._minv_cache
    rs = [torch.ones_like(f, dtype=torch.float64) for f in fixed_s]
    sweep_ms = cuda_ms(lambda: pb._local_solve(thomas, sh._group_ids(), rs), 3)
    spmv_ms = cuda_ms(lambda: pb._btd_spmv(V, rs), 5)
    del V, thomas, rs
    sh._minv_cache = None
    torch.cuda.empty_cache()
    t = time.perf_counter()
    K = assemble_csr_host(mesh, pattern, mat.C)
    host_s = time.perf_counter() - t
    res = host_residual(K, x, rhs, fixed, sval)
    del K
    check(res <= 1e-4, f"banded cell: f64 host residual {res:.3e}")
    print(f"banded cell on {card}: twolevel CG {iters} iterations (the JAX "
          f"CPU sweep: {BANDED_SWEEP_ITERS} at {SHARDS} devices) in "
          f"{solve_s:.2f} s ({walls}); peak device memory {peak / 1e9:.2f} "
          f"GB; one Thomas sweep {sweep_ms:.3f} ms and one SpMV "
          f"{spmv_ms:.3f} ms (device); f64 host residual {res:.3e} (host "
          f"operator {host_s:.2f} s); launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del sh
    torch.cuda.empty_cache()
    return {"banded cell": launches}, {"banded cell": iters}


def banded_nl_model(mesh, fixed_nodes, loaded):
    """tests/test_banded.py's nlgeom cantilever: the x = 0 end clamped, a
    traction of 2 along z on the x = length end's faces, *Static 0.5, 1,
    1e-4, 0.5."""
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel, NeumannBC

    lset = set(loaded.tolist())
    faces = [f for f in mesh.boundary if all(n in lset for n in f)]
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(fixed_nodes, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(face_set=faces, traction=2.0,
                               direction=np.array([0.0, 0.0, 1.0]))],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5),
    )


def banded_newton_run(torch, card):
    """Phase 38: ``banded_nl_model`` on cantilever_tets(BANDED_NL) through
    FEMSystem(sharding="banded", sharding_devices=SHARDS) and the
    single-device ELL FEMSystem (Jacobi CG), both at cg_eps 1e-10, with
    the secant and the consistent tangent: the histories equal (pinned in
    EXPECTED_NEWTON), dof within 1e-8 and elastic energy within 1e-10
    relative, M8 2 * SHARDS times an evaluation and no other kernel in
    the banded runs (the arch rescue is ``banded_rescue_run``).  Returns
    ({path: launches}, {path: history})."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.meshgen import cantilever_tets

    t_phase = time.perf_counter()
    mesh, fixed_nodes, loaded = cantilever_tets(*BANDED_NL)
    model = banded_nl_model(mesh, fixed_nodes, loaded)
    mat = LinearIsotropic(1000.0, 0.3)
    by_path, histories = {}, {}
    for tangent in ("secant", "consistent"):
        runs = {}
        for label, extra in (("single", dict(linear_solver="cg")),
                             ("banded", dict(sharding="banded",
                                             sharding_devices=SHARDS))):
            system = FEMSystem(mesh, mat, True, SolverConfig(
                sparse_format="ell", cg_eps=1e-10, newton_boost_max=0,
                tangent=tangent, **extra), device=DEVICE)
            zero_launches()
            t = time.perf_counter()
            rep = system.solve(model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            evals = sum(r.name == "newton_eval" for r in system.timer.records)
            runs[label] = dict(
                launches=read_launches(), wall=wall, evals=evals,
                history=[(r.newton_iters, r.converged)
                         for r in rep.increments],
                dof=system.dof.cpu().numpy(), energy=system.elastic_energy(),
                cg=list(system._cg_iters_log), ok=rep.success)
            del system
            torch.cuda.empty_cache()
        s, b = runs["single"], runs["banded"]
        rel = float(np.abs(b["dof"] - s["dof"]).max() / np.abs(s["dof"]).max())
        rel_e = abs(b["energy"] - s["energy"]) / abs(s["energy"])
        path = f"banded Newton, {tangent}"
        print(f"{path}, cantilever_tets{BANDED_NL} ({mesh.n_dof} dofs), "
              f"{SHARDS} shards on {card}: {b['wall']:.2f} s, {b['evals']} "
              f"evaluations, history {b['history']} (single device "
              f"{s['history']} in {s['wall']:.2f} s), CG iterations "
              f"{b['cg']} (single device {s['cg']}), dof rel {rel:.3e}, "
              f"energy rel {rel_e:.3e}; launches {b['launches']}",
              flush=True)
        check(b["ok"] and s["ok"], f"{path}: a run failed")
        check(b["history"] == s["history"],
              f"{path}: history {b['history']}, single {s['history']}")
        check(rel <= 1e-8 and rel_e <= 1e-10,
              f"{path} vs single device: dof {rel:.3e}, energy {rel_e:.3e}")
        check(b["launches"]["btd_scatter"] == 2 * SHARDS * b["evals"],
              f"{path}: M8 {b['launches']} for {b['evals']} evaluations")
        for name, n in b["launches"].items():
            if name != "btd_scatter":
                check(n == 0, f"{path}: {name} launched {n} times")
        by_path[path], histories[path] = b["launches"], b["history"]
    print(f"banded Newton: phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return by_path, histories


def banded_rescue_run(torch, card, recs, seen, uy_s):
    """Phase 38, its second half: the arch at ARCH_FIXTURE with
    ``dynamic_rescue``, the consistent tangent, in RESCUE_SHARDS banded
    shards resumed at the last attempt before the rescue of the
    single-device run (the CLI's of phase 32: its records ``recs``, its
    (record, dof) pairs ``seen``, its min uy ``uy_s``; ``last_attempt``):
    the same records from there on, success and min uy within 1e-6
    relative, M8 launched.  Returns {path: launches}."""
    from femcy_tpu_torch import FEMSystem, SolverConfig, material_from_inp
    from femcy_tpu_torch.mesh import FEMesh

    t_phase = time.perf_counter()
    arch = arch_model(*ARCH_FIXTURE)
    amat = material_from_inp(arch.material_type, arch.material_params,
                             arch.element_type)
    amesh = FEMesh(arch.nodes, arch.elements, arch.element)
    history = [(r.newton_iters, r.converged) for r in recs]
    banded = FEMSystem(amesh, amat, True, SolverConfig(
        tangent="consistent", dynamic_rescue=True, sharding="banded",
        sharding_devices=RESCUE_SHARDS, cg_max_iters=4 * arch.nodes.size),
        device=DEVICE)
    k, i = last_attempt(torch, banded, recs, seen)
    t_i, dt_i = banded.time0, banded.dt
    zero_launches()
    t = time.perf_counter()
    rep_b = banded.solve(arch, resume=True)
    torch.cuda.synchronize()
    banded_s = time.perf_counter() - t
    rescue_launches = read_launches()
    uy_b = banded.dof.cpu().numpy().reshape(-1, 2)[:, 1].min()
    tail = history[k - 1:]
    got = [(r.newton_iters, r.converged) for r in rep_b.increments]
    rel_uy = abs(uy_b - uy_s) / abs(uy_s)
    print(f"banded rescue, arch {ARCH_FIXTURE} ({amesh.n_dof} dofs), "
          f"{RESCUE_SHARDS} shards on {card}: resumed at t {t_i:.6f} "
          f"(record {i}) at the dt of the single-device run's last attempt "
          f"there ({dt_i:.4g}), {banded_s:.2f} s, "
          f"{len(rep_b.increments)} records (single device "
          f"{len(tail)} from there), min uy {uy_b:.9f} (single device "
          f"{uy_s:.9f}, rel {rel_uy:.3e}); launches {rescue_launches}; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(rep_b.success and banded.time0 == 1.0,
          f"banded rescue: {rep_b.success} at {banded.time0}")
    check(got == tail, f"banded rescue: records {got}, single {tail}")
    check(uy_b < -2 * ARCH_RISE and rel_uy <= 1e-6,
          f"banded rescue: min uy {uy_b}, single {uy_s}")
    check(rescue_launches["btd_scatter"] > 0, "banded rescue: no M8")
    del banded
    torch.cuda.empty_cache()
    return {"banded rescue": rescue_launches}


def slice_j_run(torch, card, ell):
    """Phase 39: femcy_tpu's remaining public functions on the card.  On
    the NX=56 box in float64: (a) ``structured_assemble`` against
    ``structured_dia_scatter(element_stiffness(...))`` within 1e-13 of
    max|values| (both reach P2), (b) against the f64
    ``analytic_structured_dia_values`` within 1e-12, (c) P2 launched once
    by the call and no other kernel; (d) ``analytic_dia_values_device``
    against the host ``dia_dirichlet_linear_numpy`` of the analytic values
    with a seeded 20% ``fixed`` mask, within 1e-12 of max|host|.  On the
    ELL slice's operator and mesh (``ell``, kept by phase 8): (e)
    ``solvers.pcg_solve`` with no ``spmv`` takes the ELL slice's pinned
    iterations with M2 launched once an iteration and no other kernel,
    and its x meets ||A x - b||_inf <= cg_eps * ||b||_inf with the plain
    gather; ``solvers.ell_spmv`` on that x against ``ell_spmv_plain``
    within 1e-12 relative, both timed in turns;
    (f) ``assembly.internal_force`` on seeded stresses against M4
    (``scatter_force``) within 1e-12 of max|M4|.  Prints each check's
    wall and ``structured_assemble``'s peak memory above its inputs.
    Returns ({path: launches}, {path: iterations})."""
    from femcy_tpu_torch import assembly, solvers
    from femcy_tpu_torch.kernels import internal_force as k_force
    from femcy_tpu_torch.materials import LinearIsotropic
    from femcy_tpu_torch.meshgen import box_tets
    from femcy_tpu_torch.solvers.cg import ell_spmv_plain
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
    from femcy_tpu_torch.structured import (
        analytic_cell_tensor,
        analytic_dia_values_device,
        analytic_structured_dia_values,
        build_structured_plan,
        dia_dirichlet_linear_numpy,
        structured_assemble,
        structured_dia_scatter,
    )

    t_phase = time.perf_counter()
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        return out

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)

    mesh = box_tets(*FULL)
    dia = build_structured_dia_pattern(mesh)
    plan = build_structured_plan(mesh, dia)
    C = LinearIsotropic(1000.0, 0.3).C
    dsdx, vol = assembly.gradients_and_volume(
        dev(mesh.nodes), dev(mesh.elements, torch.int64),
        dev(mesh.element.dshape_at_gp), dev(mesh.element.gauss_weights))
    host = timed("host analytic", lambda: analytic_structured_dia_values(
        mesh, C, dia))
    walls["setup"] = time.perf_counter() - t_phase

    zero_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    values = timed("(a) structured_assemble",
                   lambda: structured_assemble(dsdx, vol, dev(C), plan))
    peak = torch.cuda.max_memory_allocated() - base
    launches = read_launches()
    check(launches["structured_accumulate"] == 1,
          f"structured_assemble launched P2 "
          f"{launches['structured_accumulate']} times, 1 expected")
    check(all(n == 0 for k, n in launches.items()
              if k != "structured_accumulate"),
          f"structured_assemble launched another kernel: {launches}")
    by_path = {"slice J, structured_assemble": launches}
    ref = timed("(a) Newton route", lambda: structured_dia_scatter(
        assembly.element_stiffness(dsdx, vol, dev(C)), plan))
    scale = float(ref.abs().max())
    err_a = float((values - ref).abs().max()) / scale
    check(err_a <= 1e-13, f"structured_assemble vs structured_dia_scatter: "
          f"{err_a:.3e} > 1e-13")
    del ref
    err_b = float(np.abs(values.cpu().numpy() - host).max()
                  / np.abs(host).max())
    check(err_b <= TOL["float64"], f"structured_assemble vs analytic: "
          f"{err_b:.3e} > {TOL['float64']:.0e}")
    before = read_launches()["structured_accumulate"]
    structured_assemble(dsdx, vol, dev(C), plan)
    check(read_launches()["structured_accumulate"] == before + 1,
          "a second structured_assemble call did not launch P2 once")
    del values, dsdx, vol

    fixed = np.random.default_rng(3).random(dia.n_dof) < 0.2
    want = timed("(d) host elimination", lambda: dia_dirichlet_linear_numpy(
        host, dia.offsets, dia.diag_idx, fixed))
    c = analytic_cell_tensor(mesh, C, dia)
    got = timed("(d) analytic_dia_values_device",
                lambda: analytic_dia_values_device(
                    c, FULL, dia.offsets, dia.diag_idx,
                    torch.as_tensor(fixed, device=DEVICE)))
    diff_d = float(np.abs(got.cpu().numpy() - want).max())
    check(got.dtype == torch.float64 and got.device.type == "cuda",
          f"analytic_dia_values_device gave {got.dtype} on {got.device}")
    check(diff_d <= TOL["float64"] * float(np.abs(want).max()),
          f"analytic_dia_values_device vs host: {diff_d:.3e}")
    del got, want, host

    values = ell["values"].to(DEVICE)
    colidx, diag_slot = ell["colidx"].to(DEVICE), ell["diag_slot"].to(DEVICE)
    rhs = ell["rhs"].to(DEVICE)
    zero_launches()
    x, cg_iters, _ = timed("(e) solvers.pcg_solve", lambda: solvers.pcg_solve(
        values, colidx, diag_slot, rhs, eps=ell["cg_eps"],
        max_iters=ell["cg_max_iters"]))
    launches = read_launches()
    by_path["slice J, pcg_solve"] = launches
    check(launches["ell_spmv"] == cg_iters,
          f"solvers.pcg_solve launched M2 {launches['ell_spmv']} times for "
          f"{cg_iters} CG iterations")
    check(all(n == 0 for k, n in launches.items() if k != "ell_spmv"),
          f"solvers.pcg_solve launched another kernel: {launches}")
    res_e = float((ell_spmv_plain(values, colidx, x) - rhs).abs().max())
    bmax_e = float(rhs.abs().max())
    check(res_e <= ell["cg_eps"] * bmax_e,
          f"solvers.pcg_solve: ||Ax-b||_inf {res_e:.3e} > cg_eps*||b||_inf "
          f"{ell['cg_eps'] * bmax_e:.3e}")
    # the public SpMV, whose CUDA branch builds M2's plan and transposes
    # the operand at every call, against the plain gather it replaces
    y = solvers.ell_spmv(values, colidx, x)
    y_plain = ell_spmv_plain(values, colidx, x)
    err_e = float((y - y_plain).abs().max() / y_plain.abs().max())
    check(err_e <= TOL["float64"], f"solvers.ell_spmv vs ell_spmv_plain: "
          f"{err_e:.3e} > {TOL['float64']:.0e}")
    public_ms, gather_ms, _ = in_turns(
        lambda: ell_spmv_plain(values, colidx, x),
        lambda: solvers.ell_spmv(values, colidx, x), 5, 5)
    del values, colidx, diag_slot, rhs, x, y, y_plain

    plan4 = plan_to(torch, ell["plan"], DEVICE)
    dsdx, vol = ell["dsdx"].to(DEVICE), ell["vol"].to(DEVICE)
    s = torch.as_tensor(np.random.default_rng(16).standard_normal(
        (dsdx.shape[0], dsdx.shape[1], 3, 3)), device=DEVICE)
    sigma = s + s.transpose(-1, -2)
    targets = (ell["elements"].to(DEVICE)[:, :, None] * 3
               + torch.arange(3, device=DEVICE)).reshape(-1)
    f_int = timed("(f) assembly.internal_force",
                  lambda: assembly.internal_force(dsdx, sigma, vol, targets,
                                                  plan4.n_dof))
    m4 = k_force.scatter_force(
        assembly.element_internal_force(dsdx, sigma, vol), plan4)
    err_f = float((f_int - m4).abs().max() / m4.abs().max())
    check(err_f <= TOL["float64"], f"assembly.internal_force vs M4: "
          f"{err_f:.3e} > {TOL['float64']:.0e}")
    del plan4, dsdx, vol, s, sigma, targets, f_int, m4
    torch.cuda.empty_cache()
    print(f"slice J on {card}: (a) structured_assemble at {FULL} float64 vs "
          f"structured_dia_scatter rel {err_a:.3e} (tol 1e-13), peak memory "
          f"above its inputs {peak / 1e9:.3f} GB; (b) vs the f64 analytic "
          f"operator rel {err_b:.3e}; (c) P2 once a call, "
          f"{by_path['slice J, structured_assemble']}; (d) "
          f"analytic_dia_values_device vs the host elimination max abs "
          f"{diff_d:.3e}; (e) solvers.pcg_solve without spmv: {cg_iters} CG "
          f"iterations, M2 {by_path['slice J, pcg_solve']['ell_spmv']}, "
          f"||Ax-b||_inf {res_e:.3e} (cg_eps*||b||_inf "
          f"{ell['cg_eps'] * bmax_e:.3e}); solvers.ell_spmv vs the plain "
          f"gather rel {err_e:.3e}, {public_ms:.4f} ms a call (plan and "
          f"transpose included) vs the gather's {gather_ms:.4f} ms; (f) "
          f"assembly.internal_force vs M4 rel {err_f:.3e}; walls " + ", ".join(
              f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path, {"slice J, pcg_solve": cg_iters}


def _die_with_parent() -> None:
    """In a lane's process before it runs: Linux sends it SIGKILL when the
    script's process ends, also when that one is killed."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


class Lane:
    """An extra lane: this script run again with ``LANE_ARG name``, in a
    process of its own on the same card, its output in a temporary file.
    ``join`` waits for it, prints its lines and returns its launches, CG
    iterations and histories by path; ``stop`` ends it if it still runs."""

    def __init__(self, name: str):
        import tempfile

        self.name, self.t = name, time.perf_counter()
        self.log = tempfile.TemporaryFile()
        self.joined = False
        self.proc = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             LANE_ARG, name], stdout=self.log, stderr=subprocess.STDOUT,
            preexec_fn=_die_with_parent)

    def lines(self) -> list:
        self.log.seek(0)
        return self.log.read().decode(errors="replace").splitlines()

    def join(self) -> dict:
        try:
            rc = self.proc.wait(timeout=max(
                1.0, LANE_DEADLINE_S - (time.perf_counter() - T_START)))
        except subprocess.TimeoutExpired:
            rc = None
        self.joined = True
        print(f"lane {self.name!r} ({LANES[self.name].__doc__.split(':')[0]}"
              f"): exit code {rc}, wall {time.perf_counter() - self.t:.1f} "
              "s; its lines follow", flush=True)
        result = None
        for line in self.lines():
            if line.startswith(LANE_RESULT):
                result = json.loads(line[len(LANE_RESULT):])
            else:
                print(line, flush=True)
        check(rc == 0 and result is not None,
              f"lane {self.name!r}: exit code {rc}")
        result["histories"] = {path: [tuple(r) for r in h] for path, h
                               in result["histories"].items()}
        return result

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        if not self.joined:
            print(f"lane {self.name!r}, stopped: its last lines\n"
                  + "\n".join(self.lines()[-40:]), file=sys.stderr)
        self.log.close()


def cli_lane(torch, card, out):
    """Phases 14, 14b, 15, 23, 20, 16, 32's CLI and 38's arch rescue: the
    CLI runs and the banded rescue resumed from the CLI's."""
    from femcy_tpu_torch.meshgen import box_hexes, unstructured_box_tets

    by_path, iters = out["by_path"], out["iters"]
    by_path["CLI, ELL"], iters["CLI, ELL"] = cli_linear_run(
        torch, card, "CLI, ELL", unstructured_box_tets(UNSTRUCT[-1]), "C3D4",
        "ell_spmv", trace=False)
    by_path["CLI, AMG"], iters["CLI, AMG"] = cli_amg_run(torch, card)
    by_path["CLI, general DIA"], iters["CLI, general DIA"] = cli_linear_run(
        torch, card, "CLI, general DIA", box_hexes(*HEX), "C3D8", "dia_spmv",
        trace=True)
    by_path["CLI, mixed"] = cli_mixed_run(torch, card)
    for path, (counts, n) in cli_multiblock_run(torch, card).items():
        by_path[path] = counts
        if path in EXPECTED_CG_ITERS:
            iters[path] = n
    for label, extra in (("CLI nonlinear", []),
                         ("CLI nonlinear, stabilized",
                          ["--stabilize", repr(STABILIZE)])):
        by_path[label], _ = cli_nonlinear_run(torch, card, label, extra)
    recs, seen, uy = rescue_cli_run(torch, card)
    by_path.update(banded_rescue_run(torch, card, recs, seen, uy))


def nonlinear_lane(torch, card, out):
    """Phases 31 and 32's two blocks, 17, 19, 38's banded Newton and 22b:
    the rescues, the stabilized Newton cases, the hex + wedge box, the
    banded Newton cantilever and M6's routes."""
    from femcy_tpu_torch.meshgen import box_tets, unstructured_box_tets

    by_path, iters, histories = out["by_path"], out["iters"], out["histories"]
    by_path["rescue"], uy_min = rescue_run(torch, card)
    by_path["rescue, two blocks"] = rescue_blocks_run(torch, card, uy_min)
    by_path["ELL Newton, stabilized"], histories["ELL Newton, stabilized"] = (
        newton_run(torch, card, "ELL Newton, stabilized",
                   unstructured_box_tets(UNSTRUCT[-1]),
                   dict(stabilize_factor=STABILIZE), "internal_force",
                   "ell_scatter", warm=False))
    by_path["box secant, stabilized"], histories["box secant, stabilized"] = (
        newton_run(torch, card, "box secant, stabilized", box_tets(16, 16, 16),
                   dict(geometric_stiffness=False, preconditioner="multigrid",
                        linear_solver="cg", stabilize_factor=STABILIZE),
                   "structured_force", "structured_fused", warm=False))
    (by_path["hex+wedge"], iters["hex+wedge"]), (
        by_path["hex+wedge Newton"], histories["hex+wedge Newton"]) = (
        hex_wedge_run(torch, card))
    paths, hist = banded_newton_run(torch, card)
    by_path.update(paths)
    histories.update(hist)
    mixed_route_run(torch, card)


#: the extra lanes by name: each runs beside the main lane once every
#: kernel is timed, in a process of its own on the same card
LANES = {"cli": cli_lane, "nonlinear": nonlinear_lane}


def run_lane(name: str) -> int:
    """An extra lane's process: its phases, each line printed, then
    LANE_RESULT and their launches, CG iterations and histories by path
    as one JSON object."""
    import torch

    from femcy_tpu_torch.kernels import _build

    card = card_line()
    check(torch.cuda.is_available(), f"lane {name!r}: no CUDA device")
    _build.load_library()
    out = {"by_path": {}, "iters": {}, "histories": {}}
    t = time.perf_counter()
    LANES[name](torch, card, out)
    print(f"lane {name!r}: phases' wall {time.perf_counter() - t:.1f} s",
          flush=True)
    print(LANE_RESULT + json.dumps(out), flush=True)
    return 0


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
    window_spmv_checks(torch, card, results)
    coarse_spmv_checks(torch)
    p2_launches = two_stage_run(torch, full_ref)
    box_force_checks(torch, card, results)
    newton_element_checks(torch, card, results)
    iters = {}
    mg_keep = {}
    launches, iters["multigrid box"] = slice_run(torch, card, full_ref,
                                                 "multigrid", keep=mg_keep)
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
    jacobi = {}
    ell, iters["ELL slice"] = general_slice_run(
        torch, card, unstructured_box_tets(UNSTRUCT[-1]), "ell", host_K,
        keep=jacobi)
    by_path["ELL slice"] = ell
    ell_host_K = host_K  # the sharded phase's residual check
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
    by_path["AMG slice"], iters["AMG slice"] = amg_slice_run(
        torch, card, unstructured_box_tets(UNSTRUCT[-1]), jacobi["dof"],
        results)
    launches["bell_spmv"] = by_path["AMG slice"]["bell_spmv"]
    ell_operator = jacobi.pop("operator")
    del jacobi
    amg_2d_checks(torch)

    # the last phases that time kernels, before the other lanes start
    t = time.perf_counter()
    by_path["mixed box"], iters["mixed box"] = mixed_run(torch, card, results)
    m7_checks(torch, card, results)
    paths, its = banded_cell_run(torch, card, results)
    by_path.update(paths)
    iters.update(its)
    print(f"mixed, M7 and banded-cell phases: wall "
          f"{time.perf_counter() - t:.1f} s; alone until here "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)

    histories = {}
    box_single = {}
    lanes = [Lane(name) for name in LANES]
    try:
        t_lanes = time.perf_counter()
        by_path["box Newton"], histories["box Newton"] = newton_run(
            torch, card, "box Newton", box_tets(*FULL),
            dict(preconditioner="multigrid", linear_solver="cg"),
            "structured_force", "structured_accumulate", warm=True,
            keep=box_single)
        by_path["ELL Newton"], histories["ELL Newton"] = newton_run(
            torch, card, "ELL Newton", unstructured_box_tets(UNSTRUCT[-1]),
            {}, "internal_force", "ell_scatter", warm=True)
        small = unstructured_box_tets(INP_NX)
        for label, config in (
                ("consistent tangent", dict(tangent="consistent")),
                ("Jacobian reuse", dict(newton_jacobian_reuse="increment")),
                ("Newton, AMG", dict(preconditioner="amg",
                                     linear_solver="cg"))):
            by_path[label], histories[label] = newton_run(
                torch, card, label, small, config, "internal_force",
                "ell_scatter", warm=False)
        by_path["box secant"], histories["box secant"] = newton_run(
            torch, card, "box secant", box_tets(16, 16, 16),
            dict(geometric_stiffness=False, preconditioner="multigrid",
                 linear_solver="cg"), "structured_force", "structured_fused",
            warm=False)
        t = time.perf_counter()
        for path, (counts, n) in two_material_run(torch, card).items():
            by_path[path], iters[path] = counts, n
        by_path["beam lattice"] = beam_run(torch, card)
        by_path["Riks"], riks_history = riks_run(torch, card)
        print(f"two-material, beam and Riks phases: wall "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        by_path["refinement, box"], _ = refine_box_run(torch, card,
                                                       mg_keep.pop("dof"))
        refine_incompressible_run(torch, card)
        by_path["Newton refinement"], histories["Newton refinement"] = (
            newton_refine_run(torch, card))
        for path, (counts, n) in dense_cg_run(torch, card).items():
            by_path[path], iters[path] = counts, n
        for label, mesh, force, tangent in (
                ("ELL Newton, fused", unstructured_box_tets(UNSTRUCT[-1]),
                 "internal_force", "ell_scatter"),
                ("box fused", box_tets(16, 16, 16), "structured_force",
                 "structured_accumulate")):
            by_path[label], histories[label] = newton_run(
                torch, card, label, mesh, dict(fused_newton=True), force,
                tangent, warm=False)
        by_path["device loop"], histories["device loop"] = device_loop_run(
            torch, card)
        print(f"refinement, dense CG, fused and device-loop phases: wall "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        slab_paths, slab_iters = slab_linear_run(torch, card)
        by_path.update(slab_paths)
        iters.update(slab_iters)
        by_path["slab Newton"], histories["slab Newton"] = slab_newton_run(
            torch, card, box_single)
        del box_single
        paths, its = sharded_ell_run(torch, card, ell_host_K)
        by_path.update(paths)
        iters.update(its)
        del ell_host_K
        print(f"slab and sharded phases: wall {time.perf_counter() - t:.1f} "
              "s", flush=True)
        paths, its = slice_j_run(torch, card, ell_operator)
        by_path.update(paths)
        iters.update(its)
        del ell_operator
        print(f"main lane: wall {time.perf_counter() - t_lanes:.1f} s",
              flush=True)
        for lane in lanes:
            out = lane.join()
            by_path.update(out["by_path"])
            iters.update(out["iters"])
            histories.update(out["histories"])
    finally:
        for lane in lanes:
            lane.stop()
    launches["ell_scatter_shard"] = by_path["sharded ELL"]["ell_scatter"]
    launches["btd_scatter"] = by_path["banded cell"]["btd_scatter"]
    launches["dia_spmv_window"] = by_path["slab, multigrid"][
        "dia_spmv_window"]
    launches["mixed_scatter"] = by_path["mixed box"]["mixed_scatter"]
    launches["structured_accumulate"] = by_path["box Newton"][
        "structured_accumulate"]
    launches["structured_force"] = by_path["box Newton"]["structured_force"]
    launches["newton_element"] = by_path["box Newton"]["newton_element"]
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
    print(f"Riks history (expected): {riks_history} ({EXPECTED_RIKS})",
          flush=True)
    print(f"M1 on the general-DIA route at box_hexes{HEX}, float64: "
          + json.dumps(m1_dia), flush=True)

    source = {
        "dia_spmv": ("femcy_tpu_torch/csrc/dia_spmv.cu",
                     "femcy_tpu/kernels/dia_spmv.py:109"),
        # P1's windowed entry point takes the place of the slab's
        # shifted-slice halo SpMV
        "dia_spmv_window": ("femcy_tpu_torch/csrc/dia_spmv.cu",
                            "femcy_tpu/parallel/structured.py:134"),
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
        # M9 takes the place of the box Newton evaluation's einsums
        "newton_element": ("femcy_tpu_torch/csrc/c3d4_newton_element.cu",
                           "femcy_tpu/system.py:633"),
        "bell_spmv": ("femcy_tpu_torch/csrc/bell_spmv.cu",
                      "femcy_tpu/solvers/bell.py:147"),
        "mixed_scatter": ("femcy_tpu_torch/csrc/mixed_scatter.cu",
                          "femcy_tpu/mixed.py:245"),
        # M7: M1 on a plan per element shard (M4 likewise for the forces)
        "ell_scatter_shard": ("femcy_tpu_torch/csrc/ell_scatter.cu",
                              "femcy_tpu/parallel/sharded.py:180"),
        "btd_scatter": ("femcy_tpu_torch/csrc/btd_scatter.cu",
                        "femcy_tpu/parallel/banded.py:679"),
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
    sys.exit(run_lane(sys.argv[2]) if sys.argv[1:2] == [LANE_ARG]
             else main())
