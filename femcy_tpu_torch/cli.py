"""Non-interactive CLI: ``python -m femcy_tpu_torch.cli model.inp [options]``.

The port of ``femcy_tpu.cli``: the same flags, defaults and choices (and
``--preconditioner amg``, the algebraic multigrid, which femcy_tpu's CLI
does not offer), and on
the single-model route the same printed lines in the same order and format
(model, solve, elastic energy, max Mises at integration points, max nodal
Mises, max |dof|, the ``--stress`` pair), so a script that parses one
parses the other.  Outputs: PNG (``--save-png``, per-increment frames and a
GIF; matplotlib and Pillow, imported only on that route), legacy VTK and a
self-contained HTML viewer.

The model runs on the card unless ``--platform cpu`` is given (``gpu`` and
``cuda`` name the card too); without a card the CUDA default raises, as
``FEMSystem`` does.  Solution tensors come to the host once, after the
solve.  Models are routed as femcy_tpu routes them: several element types
or materials to ``MultiBlockSystem`` (per-block stresses, mixed-cell VTK,
HTML and PNG), pure B31 models to ``solve_beam`` (deflection, rotation and
section forces), and models that mix B31 beams and continuum elements to
``solve_mixed`` (deflection, solid Mises, beam section forces), each
printing femcy_tpu's lines for that route.  With ``-v`` the wall of each
stage is logged.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time

import numpy as np

logger = logging.getLogger("femcy_tpu_torch.cli")

STRESS_IDS_2D = {0: (0, 0), 1: (1, 1), 2: (0, 1)}
STRESS_IDS_3D = {0: (0, 0), 1: (1, 1), 2: (2, 2), 3: (0, 1), 4: (2, 0), 5: (1, 2)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="femcy_tpu_torch",
        description="finite-element solver for Abaqus .inp models on an "
        "NVIDIA GPU (PyTorch + CUDA)",
    )
    p.add_argument("inp", help="path to the .inp model")
    p.add_argument(
        "--platform",
        default=None,
        choices=["cpu", "gpu", "cuda"],
        help="where to solve: the card (default; gpu and cuda name it too) "
        "or cpu",
    )
    p.add_argument(
        "--solver",
        default="auto",
        choices=["auto", "direct", "cg"],
        help="linear solver selection (default: auto crossover like the reference)",
    )
    p.add_argument(
        "--tangent",
        default="secant",
        choices=["secant", "consistent"],
        help="Newton Jacobian (consistent = exact autodiff tangent)",
    )
    p.add_argument(
        "--predictor",
        default="previous",
        choices=["previous", "extrapolate"],
        help="increment initial guess (extrapolate = Abaqus-style linear "
        "extrapolation of the previous solution increment)",
    )
    p.add_argument(
        "--stabilize",
        type=float,
        default=0.0,
        metavar="FRACTION",
        help="static stabilization: volume-proportional viscous damping "
        "calibrated to this dissipated-energy fraction (Abaqus *Static, "
        "stabilize; try 2e-4). Carries nonlinear analyses through local "
        "instabilities. 0 = off",
    )
    p.add_argument(
        "--dynamic-rescue",
        action="store_true",
        help="when a nonlinear increment fails at the minimum dt, traverse "
        "the snap with implicit dynamics (Newmark with numerical "
        "dissipation) and resume statics on the far side",
    )
    p.add_argument("--cg-eps", type=float, default=1.0e-3)
    p.add_argument(
        "--preconditioner",
        default="jacobi",
        choices=["jacobi", "block_jacobi", "multigrid", "amg"],
        help="CG preconditioner (multigrid needs a structured box_tets mesh, "
        "so it applies to generated meshes, not .inp models; amg, the "
        "smoothed-aggregation algebraic multigrid, takes any single-block "
        "mesh on the ELL layout; multi-block and B31 models ignore it, "
        "with a warning)",
    )
    p.add_argument(
        "--stress",
        type=int,
        default=None,
        help="also report stress component by index "
        "(2D: 0=sxx 1=syy 2=sxy; 3D: 0=sxx 1=syy 2=szz 3=sxy 4=szx 5=syz)",
    )
    p.add_argument("--save-png", default=None, help="write a Mises PNG here")
    p.add_argument(
        "--save-frames",
        default=None,
        help="directory for a per-increment Mises PNG (nonlinear runs)",
    )
    p.add_argument(
        "--save-gif",
        default=None,
        help="assemble the per-increment frames into a GIF here",
    )
    p.add_argument("--save-vtk", default=None, help="write a VTK result file here")
    p.add_argument(
        "--save-html",
        default=None,
        help="write a self-contained interactive HTML viewer here "
        "(drag-rotate/zoom; the reference's GUI equivalent without a display)",
    )
    p.add_argument(
        "--cmap",
        default="turbo",
        help="colormap for PNG export: any matplotlib name (turbo, viridis, "
        "jet, ...) or femcy1..femcy7 — the reference colorBar.py's seven "
        "ramps (femcy4 = its default 4-interval rainbow)",
    )
    p.add_argument("--checkpoint", default=None, help="write .npz checkpoints here")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _element_types(text: str) -> set:
    """Element type strings of every ``*Element`` block header (the same
    tokenization femcy_tpu's beam reader uses)."""
    types = set()
    for line in text.splitlines():
        s = line.strip()
        if s[:2] == "**" or not s.startswith("*"):
            continue
        low = s.lower().replace(" ", "")
        if low.split(",")[0] != "*element":
            continue
        for tok in low.split(","):
            if tok.startswith("type="):
                types.add(tok[5:].upper())
    return types


@contextlib.contextmanager
def _stage(name: str):
    """Log the wall of one stage of the run (INFO, shown with -v)."""
    t = time.perf_counter()
    yield
    logger.info("stage %s: %.3f s", name, time.perf_counter() - t)


def _read_multiblock(path: str):
    """The routing rule of femcy_tpu's CLI: the ``read_inp_multi`` model
    when it has more than one element block or material (and every block's
    material resolves), else None; any failure to read it so leaves the
    model to ``read_inp``."""
    from femcy_tpu_torch.io.inp import read_inp_multi

    try:
        block_model = read_inp_multi(path)
        is_multi = (
            len(block_model.element_blocks) > 1
            or len(block_model.materials) > 1
        )
        for bi in range(len(block_model.element_blocks)):
            block_model.material_of_block(bi)  # raises if unresolvable
    except Exception:
        # odd single-type layouts (or unmapped materials): let read_inp
        # decide -- it keeps the reference's first-material quirk
        return None
    return block_model if is_multi else None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(message)s")

    from femcy_tpu_torch import FEMesh, FEMSystem, SolverConfig, read_inp
    from femcy_tpu_torch.materials import material_from_inp

    device = "cpu" if args.platform == "cpu" else "cuda"
    # unported options raise here, before any work
    config = SolverConfig(
        linear_solver=args.solver,
        cg_eps=args.cg_eps,
        preconditioner=args.preconditioner,
        tangent=args.tangent,
        predictor=args.predictor,
        stabilize_factor=args.stabilize,
        dynamic_rescue=args.dynamic_rescue,
        verbose=args.verbose,
        checkpoint_path=args.checkpoint,
    )
    t0 = time.time()
    with _stage("read"):
        # B31 detection matches *Element header lines with type=B31, as
        # femcy_tpu's CLI does
        with open(args.inp, "r") as fh:
            types = _element_types(fh.read())
        beam_model = block_model = mixed_model = None
        if "B31" in types and len(types) > 1:
            # beams AND continuum blocks in one model: the 6-dof/node
            # mixed system
            from femcy_tpu_torch.mixed import read_mixed_inp

            mixed_model = read_mixed_inp(args.inp)
        elif types == {"B31"}:
            from femcy_tpu_torch.beam import read_beam_inp

            beam_model = read_beam_inp(args.inp)
        else:
            block_model = _read_multiblock(args.inp)
            if block_model is None:
                inp = read_inp(args.inp)
    if mixed_model is not None:
        return _main_mixed(args, mixed_model, t0, device)
    if beam_model is not None:
        return _main_beam(args, beam_model, t0, device)
    if block_model is not None:
        return _main_multiblock(args, block_model, t0, device)

    with _stage("setup"):
        material = material_from_inp(
            inp.material_type, inp.material_params, inp.element_type
        )
        mesh = FEMesh(inp.nodes, inp.elements, inp.element)
        system = FEMSystem(mesh, material, inp.geometric_nonlinear, config,
                           device=device)
    print(
        f"model: {mesh.n_elements} {inp.element_type} elements, "
        f"{mesh.n_nodes} nodes, {mesh.n_dof} dofs, "
        f"geometric_nonlinear={inp.geometric_nonlinear}"
    )

    frames = []

    def _frame_cb(sys_, record):
        import os as _os

        from femcy_tpu_torch.io.export import export_png

        _os.makedirs(args.save_frames, exist_ok=True)
        _, _, mises_f = sys_.compute_strain_stress()
        nodal_f = sys_.extrapolate(mises_f).cpu().numpy()
        fname = _os.path.join(
            args.save_frames, f"frame_{len(frames):04d}.png"
        )
        export_png(
            mesh,
            sys_.dof.cpu().numpy(),
            nodal_f,
            fname,
            title=f"t={record.time:.4f}",
            cmap=args.cmap,
        )
        frames.append(fname)

    with _stage("solve"):
        report = system.solve(
            inp, on_increment=_frame_cb if args.save_frames else None
        )
    print(
        f"solve: {'converged' if report.success else 'FAILED'} in "
        f"{report.n_increments} increment(s), {report.wall_time:.2f}s "
        f"(total {time.time() - t0:.2f}s incl. compile)"
    )
    if not report.success:
        print(f"  {report.message}", file=sys.stderr)

    # observables (parity with reference main.py:34-47); each tensor comes
    # to the host once
    with _stage("post"):
        energy = system.elastic_energy()
        _, stress, mises = system.compute_strain_stress()
        nodal_mises = system.extrapolate(mises).cpu().numpy()
        mises_np = mises.cpu().numpy()
        dof = system.dof.cpu().numpy()
        if args.stress is not None:
            ids = STRESS_IDS_2D if mesh.dm == 2 else STRESS_IDS_3D
            i, j = ids[args.stress]
            comp_d = stress[:, :, i, j]
            nodal_comp = system.extrapolate(comp_d).cpu().numpy()
            comp = comp_d.cpu().numpy()
        del stress
    print(f"total elastic energy = {energy:.6g}")
    print(f"max Mises stress at integration points = {mises_np.max():.6g}")
    print(f"max nodal (extrapolated) Mises stress = {nodal_mises.max():.6g}")
    print(f"max |dof| (displacement) = {np.abs(dof).max():.6g}")
    if args.stress is not None:
        print(f"max |stress[{i}{j}]| at integration points = {np.abs(comp).max():.6g}")
        print(f"max nodal stress[{i}{j}] = {nodal_comp.max():.6g}")

    if args.save_gif and frames:
        from femcy_tpu_torch.utils.gif import frames_to_gif

        with _stage("gif"):
            frames_to_gif(frames, args.save_gif)
        print(f"wrote {args.save_gif} ({len(frames)} frames)")
    if args.save_png:
        from femcy_tpu_torch.io.export import export_png

        with _stage("png"):
            export_png(mesh, dof, nodal_mises, args.save_png,
                       title="Mises stress", cmap=args.cmap)
        print(f"wrote {args.save_png}")
    if args.save_vtk:
        from femcy_tpu_torch.io.export import average_nodal_field, export_vtk

        with _stage("vtk"):
            export_vtk(
                mesh,
                args.save_vtk,
                dof=dof,
                point_data={"mises": average_nodal_field(mesh, nodal_mises)},
                cell_data={"mises_max_gp": mises_np.max(axis=1)},
            )
        print(f"wrote {args.save_vtk}")
    if args.save_html:
        from femcy_tpu_torch.io.html import export_html

        with _stage("html"):
            export_html(mesh, dof, nodal_mises, args.save_html)
        print(f"wrote {args.save_html}")
    return 0 if report.success else 1


def _warn_amg_ignored(args, route: str) -> None:
    """``--preconditioner amg`` is the port's own choice; femcy_tpu's
    multi-block and B31 routes, which these twin, take no preconditioner
    from the command line, so it is dropped there, and said so."""
    if args.preconditioner == "amg":
        print(
            "warning: --preconditioner amg is only supported for "
            f"single-block models; ignoring it for this {route} analysis"
        )


def _main_multiblock(args, model, t0: float, device) -> int:
    """The route of multi-element-type / multi-material models, femcy_tpu's
    ``_main_multiblock``: the single-block observables over per-block
    stress recovery, and mixed-cell exports; linear and geometric-
    nonlinear.  Its SolverConfig is femcy_tpu's for this route."""
    from femcy_tpu_torch import SolverConfig
    from femcy_tpu_torch.multiblock import system_from_model

    if args.stabilize > 0.0:
        print(
            "warning: --stabilize is only supported for single-block "
            "models; ignoring it for this multi-block analysis"
        )
    _warn_amg_ignored(args, "multi-block")
    config = SolverConfig(
        linear_solver=args.solver,
        cg_eps=args.cg_eps,
        tangent=args.tangent,
        dynamic_rescue=args.dynamic_rescue,
        verbose=args.verbose,
    )
    with _stage("setup"):
        system = system_from_model(model, config, device=device)
    blocks_txt = ", ".join(
        f"{blk.elements.shape[0]} {etype}[{blk.name or bi}]"
        for bi, ((etype, _, _), blk) in enumerate(
            zip(model.element_blocks, system.blocks)
        )
    )
    print(
        f"model: {blocks_txt}; {model.nodes.shape[0]} nodes, "
        f"{system.n_dof} dofs, {len(model.materials)} material(s), "
        f"geometric_nonlinear={model.geometric_nonlinear}"
    )
    n_blocks = len(system.blocks)
    frames = []

    def _frame_cb(sys_, record):
        import os as _os

        from femcy_tpu_torch.io.export import export_png_blocks

        _os.makedirs(args.save_frames, exist_ok=True)
        meshes_f = [sys_.block_mesh(bi) for bi in range(n_blocks)]
        fname = _os.path.join(
            args.save_frames, f"frame_{len(frames):04d}.png"
        )
        nodal_f = [sys_.extrapolate_block(bi, sys_.block_stress(bi)[2])
                   .cpu().numpy() for bi in range(n_blocks)]
        export_png_blocks(
            meshes_f, sys_.dof.cpu().numpy(), nodal_f, fname,
            title=f"t={record.time:.4f}", cmap=args.cmap,
        )
        frames.append(fname)

    report = None
    with _stage("solve"):
        if model.geometric_nonlinear:
            report = system.solve_nonlinear(
                model, on_increment=_frame_cb if args.save_frames else None
            )
        else:
            system.solve_model(model)
    if report is not None:
        print(
            f"solve: {'converged' if report.success else 'FAILED'} in "
            f"{report.n_increments} increment(s), {report.wall_time:.2f}s "
            f"(total {time.time() - t0:.2f}s incl. compile)"
        )
        if not report.success:
            print(f"  {report.message}", file=sys.stderr)
    else:
        print(
            "solve: converged in 1 increment(s) "
            f"(total {time.time() - t0:.2f}s incl. compile)"
        )

    with _stage("post"):
        dof = system.dof.cpu().numpy()
        gp_mises, nodal_mises, comp_max, nodal_comp_max = [], [], [], []
        if args.stress is not None:
            ids = STRESS_IDS_2D if model.dm == 2 else STRESS_IDS_3D
            i, j = ids[args.stress]
        for bi in range(n_blocks):
            _, stress, mises = system.block_stress(bi)
            gp_mises.append(mises.cpu().numpy())
            nodal_mises.append(system.extrapolate_block(bi, mises)
                               .cpu().numpy())
            if args.stress is not None:
                comp = stress[:, :, i, j]
                comp_max.append(float(comp.abs().max()))
                nodal_comp_max.append(
                    float(system.extrapolate_block(bi, comp).max()))
            del stress
        energy = system.elastic_energy()
    print(f"total elastic energy = {energy:.6g}")
    print(
        "max Mises stress at integration points = "
        f"{max(m.max() for m in gp_mises):.6g}"
    )
    print(
        "max nodal (extrapolated) Mises stress = "
        f"{max(m.max() for m in nodal_mises):.6g}"
    )
    print(f"max |dof| (displacement) = {np.abs(dof).max():.6g}")
    if args.stress is not None:
        print(f"max |stress[{i}{j}]| at integration points = "
              f"{max(comp_max):.6g}")
        print(f"max nodal stress[{i}{j}] = {max(nodal_comp_max):.6g}")

    if (args.save_frames or args.save_gif) and not model.geometric_nonlinear:
        print(
            "frames/GIF apply to nonlinear increments; linear multi-block "
            "solves have one state",
            file=sys.stderr,
        )
    if args.save_gif and frames:
        from femcy_tpu_torch.utils.gif import frames_to_gif

        with _stage("gif"):
            frames_to_gif(frames, args.save_gif)
        print(f"wrote {args.save_gif} ({len(frames)} frames)")
    meshes = [system.block_mesh(bi) for bi in range(n_blocks)]
    if args.save_png:
        from femcy_tpu_torch.io.export import export_png_blocks

        with _stage("png"):
            export_png_blocks(meshes, dof, nodal_mises, args.save_png,
                              title="Mises stress", cmap=args.cmap)
        print(f"wrote {args.save_png}")
    if args.save_vtk:
        from femcy_tpu_torch.io.export import (
            average_nodal_field_blocks,
            export_vtk_blocks,
        )

        with _stage("vtk"):
            export_vtk_blocks(
                system.nodes,
                [(blk.elements, blk.element.name) for blk in system.blocks],
                args.save_vtk,
                dof=dof,
                point_data={
                    "mises": average_nodal_field_blocks(
                        model.nodes.shape[0], meshes, nodal_mises
                    )
                },
                cell_data={
                    "mises_max_gp": np.concatenate(
                        [m.max(axis=1) for m in gp_mises]
                    )
                },
            )
        print(f"wrote {args.save_vtk}")
    if args.save_html:
        from femcy_tpu_torch.io.html import export_html_blocks

        with _stage("html"):
            export_html_blocks(meshes, dof, nodal_mises, args.save_html)
        print(f"wrote {args.save_html}")
    return 0 if report is None or report.success else 1


def _main_beam(args, model, t0: float, device) -> int:
    """The route of B31 beam lattices, femcy_tpu's ``_main_beam``: max
    deflection and rotation and the peak section forces (the continuum
    routes' stress, energy and Mises do not apply to beam theory)."""
    from femcy_tpu_torch.beam import solve_beam

    _warn_amg_ignored(args, "B31 beam")
    print(
        f"model: {model.elements.shape[0]} B31 elements, "
        f"{model.nodes.shape[0]} nodes, {model.n_dof} dofs (6/node)"
    )
    with _stage("solve"):
        res = solve_beam(model, device=device)
    dt = time.time() - t0
    defl = np.linalg.norm(res.u[:, :3], axis=1)
    rot = np.linalg.norm(res.u[:, 3:], axis=1)
    fe = res.end_forces
    print(f"max deflection |u| = {defl.max():.6e} (node {defl.argmax()})")
    print(f"max rotation |theta| = {rot.max():.6e} (node {rot.argmax()})")
    print(f"max axial force N = {np.abs(fe[:, [0, 6]]).max():.6e}")
    print(f"max bending moment = {np.abs(fe[:, [4, 5, 10, 11]]).max():.6e}")
    print(f"max torque = {np.abs(fe[:, [3, 9]]).max():.6e}")
    print(f"solve time: {dt:.2f}s")
    return 0


def _main_mixed(args, model, t0: float, device) -> int:
    """The route of mixed beam + continuum models, femcy_tpu's
    ``_main_mixed``: one 6-dof/node system over B31 and continuum blocks,
    solved with femcy_tpu's default SolverConfig for this route."""
    from femcy_tpu_torch.mixed import solve_mixed

    _warn_amg_ignored(args, "mixed beam + continuum")
    n_beam = sum(b.elements.shape[0] for b in model.beam_blocks)
    n_solid = sum(b.elements.shape[0] for b in model.solid_blocks)
    print(
        f"mixed model: {n_solid} continuum elements in "
        f"{len(model.solid_blocks)} block(s) + {n_beam} B31 elements, "
        f"{model.nodes.shape[0]} nodes (6 dofs/node)"
    )
    with _stage("solve"):
        res = solve_mixed(model, device=device)
    dt = time.time() - t0
    defl = np.linalg.norm(res.u[:, :3], axis=1)
    print(f"max deflection |u| = {defl.max():.6e} (node {defl.argmax()})")
    if res.solid_mises:
        mx = max(float(m.max()) for m in res.solid_mises)
        print(f"max solid Mises = {mx:.6e}")
    if res.beam_end_forces:
        fe = np.concatenate(res.beam_end_forces)
        print(f"max beam axial force N = {np.abs(fe[:, [0, 6]]).max():.6e}")
        print(
            f"max beam bending moment = "
            f"{np.abs(fe[:, [4, 5, 10, 11]]).max():.6e}"
        )
    print(f"auto-constrained rotation dofs: {res.n_auto_fixed}")
    print(f"solve time: {dt:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
