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
solve.  Models that mix B31 beams and continuum elements, pure B31 models
and multi-block models (several element types or materials) are detected
as femcy_tpu detects them and raise ``NotImplementedError`` before any
system is built; ``--dynamic-rescue`` raises through ``SolverConfig``.
With ``-v`` the wall of each stage is logged.
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

_SLICE_H = "the multi-block, beam and mixed systems (ROADMAP slice H)"


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
        "smoothed-aggregation algebraic multigrid, takes any mesh on the "
        "ELL layout)",
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


def _is_multiblock(path: str) -> bool:
    """The routing rule of femcy_tpu's CLI: more than one element block or
    material by ``read_inp_multi`` (and every block's material resolvable);
    any failure to read it so leaves the model to ``read_inp``."""
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
        is_multi = False
    return is_multi


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
        if "B31" in types and len(types) > 1:
            raise NotImplementedError(
                "mixed B31 + continuum models need " + _SLICE_H
                + ", not yet ported to femcy_tpu_torch"
            )
        if types == {"B31"}:
            raise NotImplementedError(
                "B31 beam models need " + _SLICE_H
                + ", not yet ported to femcy_tpu_torch"
            )
        if _is_multiblock(args.inp):
            raise NotImplementedError(
                "models mixing element types or materials need " + _SLICE_H
                + ", not yet ported to femcy_tpu_torch"
            )
        inp = read_inp(args.inp)

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


if __name__ == "__main__":
    raise SystemExit(main())
