"""The command-line interface and its outputs: femcy_tpu_torch.cli against
femcy_tpu.cli, and the port's readers and exporters against femcy_tpu's,
on the CPU.

CLI against CLI: both packages' ``main([... "--platform", "cpu"])`` on the
same inline Abaqus models (a CPS3 membrane under a *Dsload, a C3D4 box on
ELL by the CG, a C3D8 box on the general DIA with a 3-D PNG, a geometric-
nonlinear CPS4 cantilever with frames, a GIF and checkpoints, the same
cantilever stabilized; a two-material CPS4 model and a B31 beam, through
the multi-block and beam routes, line for line).  Tolerances: every
printed observable within 1e-6 relative after parsing (they are printed
with 6 significant digits), the model line, increment counts and exit
codes equal; the VTK numeric blocks within 1e-8 of each block's largest
value; the HTML payload's triangles and positions equal and its colour
range within 1e-9; the PNGs equal in
size with at most 0.1% of pixels differing; frame counts equal and the
checkpoint dof within 1e-10 relative.  In float32 (a subprocess with
FEMCY_TPU_X64=0) the observables hold within 1e-3.

Module by module: ``read_inp_multi`` field by field on multi-block texts,
the colour ramps, the exporters' helpers, the VTK cell types, the GIF
helpers and ``device_trace``.
"""

import dataclasses
import json
import logging
import os
import pathlib
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import femcy_tpu as F
from femcy_tpu import cli as jcli
from femcy_tpu.io import colormap as jcmap
from femcy_tpu.io import export as jexport
from femcy_tpu.io.inp import read_inp_multi as j_read_inp_multi
from femcy_tpu.utils import gif as jgif

import femcy_tpu_torch as T
from femcy_tpu_torch import cli as tcli
from femcy_tpu_torch import convert
from femcy_tpu_torch.io import colormap as tcmap
from femcy_tpu_torch.io import export as texport
from femcy_tpu_torch.io import html as thtml
from femcy_tpu_torch.utils import gif as tgif
from femcy_tpu_torch.utils.timing import device_trace

REPO = pathlib.Path(__file__).resolve().parent.parent
OBS_TOL = 1e-6


# --------------------------------------------------------------------------- #
# inline models
# --------------------------------------------------------------------------- #
def _inp_text(mesh, etype, boundary, dsload, *, nlgeom="NO",
              static="1., 1., 1e-05, 1."):
    """``mesh`` as an Abaqus .inp: node sets ``fix`` (x=0 in 2-D, z=0 in
    3-D) and ``top`` (z=max, 3-D), a *Surface ``xload`` of the faces on
    x=max (per-face-number element sets), *Elastic 1000, 0.3."""
    lines = ["*Heading", "cli parity model", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(mesh.nodes)]
    lines.append(f"*Element, type={etype}")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in conn)
              for e, conn in enumerate(mesh.elements)]
    x = mesh.nodes[:, 0]
    faces = {}
    for e, conn in enumerate(mesh.elements):
        for k, facets in enumerate(mesh.element.inp_surface_num):
            nodes = [int(conn[ln]) for f in facets for ln in f]
            if (x[nodes] > x.max() - 1e-9).all():
                faces.setdefault(k + 1, []).append(e + 1)
    axis = mesh.nodes[:, 2] if mesh.dm == 3 else x
    sets = [("fix", axis < 1e-9)]
    if mesh.dm == 3:
        sets.append(("top", axis > axis.max() - 1e-9))
    for name, sel in sets:
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in np.nonzero(sel)[0])]
    for k, eles in faces.items():
        lines += [f"*Elset, elset=_x{k}, internal, instance=a",
                  ", ".join(str(e) for e in eles)]
    lines.append("*Surface, type=ELEMENT, name=xload")
    lines += [f"_x{k}, S{k}" for k in faces]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              f"*Step, name=s, nlgeom={nlgeom}", "*Static", static,
              "*Boundary", *boundary, "*Dsload", dsload, "*End Step"]
    return "\n".join(lines) + "\n"


_CLAMP_2D = ["fix, 1, 1", "fix, 2, 2"]
_CLAMP_3D = ["fix, 1, 1", "fix, 2, 2", "fix, 3, 3", "top, 1, 1, 0.01"]


def _membrane():
    """A CPS3 plate pulled by a *Dsload on its x=2 edge (direct solve)."""
    mesh = T.meshgen.rect_tris(8, 4, 2.0, 1.0)
    return _inp_text(mesh, "CPS3", _CLAMP_2D, "xload, P, -2.")


def _tet_box():
    """unstructured_box_tets(4): the ELL layout."""
    mesh = T.meshgen.unstructured_box_tets(4)
    return _inp_text(mesh, "C3D4", _CLAMP_3D, "xload, P, 2.")


def _hex_box():
    """box_hexes(4, 3, 3): the general DIA layout."""
    mesh = T.meshgen.box_hexes(4, 3, 3)
    return _inp_text(mesh, "C3D8", _CLAMP_3D, "xload, P, 2.")


def _cantilever(load=0.5, static="0.25, 1., 1e-05, 0.5"):
    """A 10 x 1 CPS4 cantilever, x=0 clamped, a transverse traction on its
    x=10 end; geometric nonlinearity, increments of a quarter growing to a
    half."""
    mesh = T.meshgen.rect_quads(10, 2, 10.0, 1.0)
    return _inp_text(mesh, "CPS4", _CLAMP_2D,
                     f"xload, TRVEC, {load}, 0., 1., 0.", nlgeom="YES",
                     static=static)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _observables(out):
    """{label: value} of every 'label = value' line."""
    vals = {}
    for line in out.splitlines():
        if " = " in line:
            key, val = line.rsplit(" = ", 1)
            vals[key] = float(val)
    return vals


def _increments(out):
    return int(re.search(r"in (\d+) increment", out).group(1))


def _same_output(t_out, j_out, tol=OBS_TOL):
    t_lines, j_lines = t_out.splitlines(), j_out.splitlines()
    assert t_lines[0] == j_lines[0]  # the model line
    assert _increments(t_out) == _increments(j_out)
    t_obs, j_obs = _observables(t_out), _observables(j_out)
    assert list(t_obs) == list(j_obs) and len(t_obs) >= 4
    for key, j in j_obs.items():
        assert abs(t_obs[key] - j) <= tol * max(abs(j), 1e-30), key
    # the same lines, in the same order, but for the files named
    strip = [re.sub(r"\S*(?:torch|jax)\S*", "", ln) for ln in t_lines[1:]]
    assert [ln.split(" = ")[0] for ln in strip if "solve:" not in ln] == [
        re.sub(r"\S*(?:torch|jax)\S*", "", ln).split(" = ")[0]
        for ln in j_lines[1:] if "solve:" not in ln]


def _vtk_blocks(path):
    """[(header line, values)] of a legacy VTK file."""
    blocks = []
    for line in pathlib.Path(path).read_text().splitlines():
        if line[:1].isalpha() or line.startswith("#"):
            blocks.append((line, []))
        else:
            blocks[-1][1].extend(float(v) for v in line.split())
    return [(h, np.asarray(v)) for h, v in blocks]


def _same_vtk(t_path, j_path):
    tb, jb = _vtk_blocks(t_path), _vtk_blocks(j_path)
    assert [h for h, _ in tb] == [h for h, _ in jb]
    for (h, t), (_, j) in zip(tb, jb):
        assert t.shape == j.shape, h
        if j.size:
            assert np.abs(t - j).max() <= 1e-8 * max(np.abs(j).max(), 1e-30), h


def _html_payload(path):
    text = pathlib.Path(path).read_text()
    return json.loads(re.search(r"const D=(\{.*?\});", text).group(1))


def _same_html(t_path, j_path):
    t, j = _html_payload(t_path), _html_payload(j_path)
    assert t["tri"] == j["tri"] and t["pos"] == j["pos"]
    for key in ("vmin", "vmax"):
        assert abs(t[key] - j[key]) <= 1e-9 * max(abs(j[key]), 1e-30)


def _same_png(t_path, j_path):
    t = np.asarray(Image.open(t_path).convert("RGB"))
    j = np.asarray(Image.open(j_path).convert("RGB"))
    assert t.shape == j.shape
    assert (t != j).any(axis=-1).mean() <= 1e-3


def _cli_pair(tmp_path, text, extra, capsys, outputs=("vtk", "html")):
    """Both CLIs on ``text`` with ``extra`` flags and per-package output
    files.  Returns {package: (rc, stdout, {output: path})}."""
    path = tmp_path / "model.inp"
    path.write_text(text)
    runs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        files = {o: tmp_path / f"{name}.{o}" for o in outputs}
        argv = [str(path), "--platform", "cpu", *extra]
        for o, p in files.items():
            argv += [f"--save-{o}", str(p)]
        runs[name] = (*_run(main, argv, capsys), files)
    return runs


# --------------------------------------------------------------------------- #
# CLI against CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model, extra, outputs", [
    ("membrane", ["--stress", "1"], ("vtk", "html", "png")),
    ("tet box", ["--stress", "2", "--solver", "cg", "--cg-eps", "1e-10"],
     ("vtk", "html")),
    ("hex box", ["--stress", "5", "--cmap", "femcy4"], ("vtk", "html", "png")),
])
def test_linear_models_match_jax_cli(tmp_path, capsys, model, extra, outputs):
    text = {"membrane": _membrane, "tet box": _tet_box,
            "hex box": _hex_box}[model]()
    runs = _cli_pair(tmp_path, text, extra, capsys, outputs)
    (j_rc, j_out, j_files), (t_rc, t_out, t_files) = runs["jax"], runs["torch"]
    assert t_rc == j_rc == 0
    assert "converged in 1 increment(s)" in t_out
    _same_output(t_out, j_out)
    _same_vtk(t_files["vtk"], j_files["vtk"])
    _same_html(t_files["html"], j_files["html"])
    if "png" in outputs:
        _same_png(t_files["png"], j_files["png"])


@pytest.mark.parametrize("stabilize", ["0", "1e-4"])
def test_nonlinear_cantilever_matches_jax_cli(tmp_path, capsys, stabilize):
    """Frames, a GIF and checkpoints after every increment; with
    ``--stabilize`` the viscous force and its calibration."""
    path = tmp_path / "model.inp"
    path.write_text(_cantilever())
    runs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        argv = [str(path), "--platform", "cpu", "--stress", "0",
                "--stabilize", stabilize,
                "--save-frames", str(d / "frames"),
                "--save-gif", str(d / "out.gif"),
                "--checkpoint", str(d / "ck"),
                "--save-vtk", str(d / "out.vtk"),
                "--save-png", str(d / "out.png")]
        runs[name] = _run(main, argv, capsys)
    (j_rc, j_out), (t_rc, t_out) = runs["jax"], runs["torch"]
    assert t_rc == j_rc == 0
    assert "geometric_nonlinear=True" in t_out and _increments(t_out) >= 3
    _same_output(t_out, j_out)
    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    j_frames = sorted(os.listdir(j_dir / "frames"))
    assert sorted(os.listdir(t_dir / "frames")) == j_frames
    assert len(j_frames) == _increments(t_out)
    assert f"({len(j_frames)} frames)" in t_out
    for f in (j_frames[0], j_frames[-1]):
        _same_png(t_dir / "frames" / f, j_dir / "frames" / f)
    _same_png(t_dir / "out.png", j_dir / "out.png")
    assert Image.open(t_dir / "out.gif").n_frames == len(j_frames)
    _same_vtk(t_dir / "out.vtk", j_dir / "out.vtk")
    tj, tt = np.load(j_dir / "ck.npz"), np.load(t_dir / "ck.npz")
    assert int(tt["kinc"]) == int(tj["kinc"]) and float(tt["time0"]) == 1.0
    dof_j = tj["dof"]
    assert np.abs(tt["dof"] - dof_j).max() <= 1e-10 * np.abs(dof_j).max()
    assert np.abs(dof_j).max() > 1.0  # a large deflection


def test_failure_exits_1_in_both(tmp_path, capsys):
    """A crushing end pressure in one increment, no room to cut back: the
    analysis fails (element inversion), both CLIs report it and exit 1."""
    path = tmp_path / "model.inp"
    path.write_text(_inp_text(T.meshgen.rect_quads(10, 2, 10.0, 1.0), "CPS4",
                              _CLAMP_2D, "xload, P, 2000.", nlgeom="YES",
                              static="1., 1., 1., 1."))
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        rc = main([str(path), "--platform", "cpu"])
        outs[name] = (rc, *capsys.readouterr())
    (j_rc, j_out, j_err), (t_rc, t_out, t_err) = outs["jax"], outs["torch"]
    assert t_rc == j_rc == 1
    assert "solve: FAILED in" in t_out and "solve: FAILED in" in j_out
    assert _increments(t_out) == _increments(j_out)
    assert "element inversion at the trial configuration" in t_err
    assert t_err.split("(min")[0] == j_err.split("(min")[0]


def test_float32_observables(tmp_path):
    """FEMCY_TPU_X64=0 in a fresh process: both CLIs in float32 agree with
    each other and with the port's float64 run within 1e-3."""
    path = tmp_path / "model.inp"
    path.write_text(_hex_box())
    outs = {}
    for pkg, x64 in (("femcy_tpu", "0"), ("femcy_tpu_torch", "0"),
                     ("femcy_tpu_torch", "1")):
        env = dict(os.environ, FEMCY_TPU_X64=x64)
        run = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", str(path), "--platform",
             "cpu", "--stress", "1"],
            capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert run.returncode == 0, run.stderr[-1500:]
        outs[pkg, x64] = run.stdout
    _same_output(outs["femcy_tpu_torch", "0"], outs["femcy_tpu", "0"], 1e-3)
    _same_output(outs["femcy_tpu_torch", "0"], outs["femcy_tpu_torch", "1"],
                 1e-3)


# --------------------------------------------------------------------------- #
# the other model kinds, and the routes and flags that raise
# --------------------------------------------------------------------------- #
_TWO_MATERIALS = """*Heading
two materials by *Solid Section
*Node
1, 0., 0.
2, 1., 0.
3, 2., 0.
4, 0., 1.
5, 1., 1.
6, 2., 1.
*Element, type=CPS4, elset=soft
1, 1, 2, 5, 4
*Element, type=CPS4, elset=hard
2, 2, 3, 6, 5
*Nset, nset=fix
1, 4
*Nset, nset=pull
3, 6
*Solid Section, elset=soft, material=rubber
*Solid Section, elset=hard, material=steel
*Material, name=rubber
*Elastic
100., 0.3
*Material, name=steel
*Elastic
300., 0.3
*Step, nlgeom=NO
*Static
1., 1., 1e-05, 1.
*Boundary
fix, 1, 2
pull, 1, 1, 0.01
*End Step
"""

_BEAM = """*Heading
a B31 beam
*Node
1, 0., 0., 0.
2, 1., 0., 0.
*Element, type=B31, elset=beam
1, 1, 2
*Nset, nset=fix
1
*Beam Section, elset=beam, material=m, section=RECT
0.05, 0.08
*Material, name=m
*Elastic
1000., 0.3
*Step, nlgeom=NO
*Static
1., 1., 1e-05, 1.
*Boundary
fix, 1, 6
*Cload
2, 2, 0.001
*End Step
"""


def _same_lines(t_out, j_out):
    """The same lines in the same order: equal but for the numbers of
    'label = value' lines (within 1e-6 relative, the words after them
    equal) and the walls of the solve lines."""
    t_lines, j_lines = t_out.splitlines(), j_out.splitlines()
    assert len(t_lines) == len(j_lines)
    for t, j in zip(t_lines, j_lines):
        if t.startswith(("solve:", "solve time:")):
            assert t.split("(")[0].split(":")[0] == j.split("(")[0].split(":")[0]
            assert re.sub(r"[\d.]+s", "", t) == re.sub(r"[\d.]+s", "", j)
        elif " = " in j:
            (t_key, t_val), (j_key, j_val) = t.split(" = "), j.split(" = ")
            assert t_key == j_key
            t_num, j_num = float(t_val.split()[0]), float(j_val.split()[0])
            assert abs(t_num - j_num) <= OBS_TOL * max(abs(j_num), 1e-30), j
            assert t_val.split()[1:] == j_val.split()[1:]
        else:
            assert t == j


@pytest.mark.parametrize("text", [
    _TWO_MATERIALS,
    _BEAM,
    _BEAM.replace("*Nset", "*Element, type=C3D4, elset=solid\n"
                  "2, 1, 2, 3, 4\n*Nset").replace(
        "2, 1., 0., 0.\n", "2, 1., 0., 0.\n3, 0., 1., 0.\n4, 0., 0., 1.\n")
    # the tet's nodes 3 and 4 held too: else it turns about the beam's axis
    .replace("*Nset, nset=fix\n1\n", "*Nset, nset=fix\n1, 3, 4\n"),
], ids=["two materials", "B31", "B31 + C3D4"])
def test_other_model_kinds_raise_naming_slice_h(tmp_path, capsys, text):
    """The model kinds of ROADMAP slice H: a two-material model (the
    multi-block route), a B31 beam and a B31 beam on a C3D4 tet (the mixed
    beam + continuum route) solve, and print femcy_tpu.cli's lines, line
    for line."""
    path = tmp_path / "model.inp"
    path.write_text(text)
    argv = [str(path), "--platform", "cpu"]
    j_rc, j_out = _run(jcli.main, argv, capsys)
    t_rc, t_out = _run(tcli.main, argv, capsys)
    assert t_rc == j_rc == 0
    assert t_out.splitlines()[0] == j_out.splitlines()[0]
    _same_lines(t_out, j_out)


@pytest.mark.parametrize("text, route", [
    (_TWO_MATERIALS, "multi-block"), (_BEAM, "B31 beam"),
], ids=["two materials", "B31"])
def test_amg_ignored_with_a_warning_off_the_single_block_route(
        tmp_path, capsys, text, route):
    """--preconditioner amg, which femcy_tpu's CLI lacks, does not reach the
    multi-block and B31 routes: they say so on their first line, and then
    print what they print without it."""
    path = tmp_path / "model.inp"
    path.write_text(text)
    argv = [str(path), "--platform", "cpu"]
    rc, plain = _run(tcli.main, argv, capsys)
    rc_amg, amg = _run(tcli.main, argv + ["--preconditioner", "amg"], capsys)
    assert rc == rc_amg == 0
    first, *rest = amg.splitlines()
    assert first == ("warning: --preconditioner amg is only supported for "
                     f"single-block models; ignoring it for this {route} "
                     "analysis")
    _same_lines("\n".join(rest), plain)


def _arch():
    """femcy_tpu's snap-through arch (tests/test_dynamic_rescue.py::
    _arch_inp: 64 x 2 CPE4, span 100, rise 8, thickness 0.8) as an .inp:
    the mid-thickness end nodes hinged, a pressure of 0.2 on the top
    faces, its *Static schedule."""
    from test_torch_rescue import arch_inp

    inp = arch_inp()
    mesh = T.FEMesh(inp.nodes, inp.elements, convert.element_from(
        F.elements.get_element("CPE4")))
    lines = ["*Heading", "snap-through arch", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(mesh.nodes)]
    lines.append("*Element, type=CPE4")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in conn)
              for e, conn in enumerate(mesh.elements)]
    hinge = inp.dirichlet_bcs[0].node_set
    top = {n for face in inp.neumann_bcs[0].face_set for n in face}
    faces = {}
    for e, conn in enumerate(mesh.elements):
        for k, facets in enumerate(mesh.element.inp_surface_num):
            if {int(conn[ln]) for f in facets for ln in f} <= top:
                faces.setdefault(k + 1, []).append(e + 1)
    lines += ["*Nset, nset=hinge, instance=a",
              ", ".join(str(n + 1) for n in hinge)]
    for k, eles in faces.items():
        lines += [f"*Elset, elset=_t{k}, internal, instance=a",
                  ", ".join(str(e) for e in eles)]
    lines.append("*Surface, type=ELEMENT, name=top")
    lines += [f"_t{k}, S{k}" for k in faces]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              "*Step, name=s, nlgeom=YES", "*Static",
              "0.05, 1., 1e-05, 0.1", "*Boundary", "hinge, 1, 1",
              "hinge, 2, 2", "*Dsload", "top, P, 0.2", "*End Step"]
    return "\n".join(lines) + "\n"


def test_dynamic_rescue_raises_naming_slice_g(tmp_path, capsys, caplog):
    """``--dynamic-rescue`` runs (the name is from before the rescue was
    ported, when the flag raised): femcy_tpu's snap-through arch from
    t = 0 through both CLIs with the consistent tangent, one torch thread
    (thousands of evaluations on 128 elements): exit 0, femcy_tpu's lines
    (observables within 1e-6), its warnings about the failed increment
    and the rescue, and the largest displacement past twice the rise."""
    path = tmp_path / "arch.inp"
    path.write_text(_arch())
    argv = [str(path), "--platform", "cpu", "--tangent", "consistent",
            "--dynamic-rescue"]
    outs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, main in (("jax", jcli.main), ("torch", tcli.main)):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                rc = main(argv)
            rescue = [r.getMessage() for r in caplog.records
                      if "rescue" in r.getMessage()]
            outs[name] = (rc, capsys.readouterr().out, rescue)
    finally:
        torch.set_num_threads(threads)
    (j_rc, j_out, j_warn), (t_rc, t_out, t_warn) = outs["jax"], outs["torch"]
    assert t_rc == j_rc == 0
    _same_output(t_out, j_out)
    assert t_warn == j_warn and len(t_warn) == 2
    assert "attempting implicit-dynamics traversal" in t_warn[0]
    assert t_warn[1].endswith("resuming statics")
    assert _observables(t_out)["max |dof| (displacement)"] > 16.0


def test_platform_choices(tmp_path, capsys, monkeypatch):
    """The card unless --platform cpu: without a card the default, gpu and
    cuda raise as FEMSystem does; another platform is a usage error."""
    path = tmp_path / "model.inp"
    path.write_text(_membrane())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--platform", "gpu"], ["--platform", "cuda"]):
        with pytest.raises(RuntimeError, match="never falls back to the CPU"):
            tcli.main([str(path), *extra])
    with pytest.raises(SystemExit) as exc:
        tcli.main([str(path), "--platform", "tpu"])
    assert exc.value.code == 2
    assert tcli.main([str(path), "--platform", "cpu"]) == 0
    capsys.readouterr()


def test_parser_matches_jax():
    """The same flags, defaults and choices, but --platform's and the
    port's --preconditioner amg, which femcy_tpu's CLI does not offer."""
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.nargs)
                for a in parser._actions if a.dest != "platform"}

    ours, theirs = actions(tcli.build_parser()), actions(jcli.build_parser())
    flags, default, choices, nargs = ours["preconditioner"]
    assert choices[-1] == "amg"
    ours["preconditioner"] = (flags, default, choices[:-1], nargs)
    assert ours == theirs
    text = "*Element, TYPE=b31\n** *Element, type=C3D4\n*element,type=CPS4\n"
    assert tcli._element_types(text) == jcli._element_types(text) == {
        "B31", "CPS4"}


# --------------------------------------------------------------------------- #
# read_inp_multi
# --------------------------------------------------------------------------- #
def _mixed_rect_text(sections, surface=""):
    """A 2 x 1 plate: a CPS4 block (elset soft) on x<1 and a CPS3 block
    (elset stiff) on x>1, then ``sections`` and ``surface``."""
    nodes = [(i * 0.5, j * 0.5) for i in range(5) for j in range(3)]
    nid = {(i, j): i * 3 + j + 1 for i in range(5) for j in range(3)}
    quads, tris = [], []
    for i in range(4):
        for j in range(2):
            a, b = nid[i, j], nid[i + 1, j]
            c, d = nid[i + 1, j + 1], nid[i, j + 1]
            if i < 2:
                quads.append((a, b, c, d))
            else:
                tris += [(a, b, c), (a, c, d)]
    lines = ["*Heading", "mixed", "*Node"]
    lines += [f"{k + 1}, {x}, {y}" for k, (x, y) in enumerate(nodes)]
    lines.append("*Element, type=CPS4, elset=soft")
    lines += [f"{e + 1}, " + ", ".join(map(str, q))
              for e, q in enumerate(quads)]
    lines.append("*Element, type=CPS3, elset=stiff")
    lines += [f"{len(quads) + e + 1}, " + ", ".join(map(str, t))
              for e, t in enumerate(tris)]
    lines += ["*Nset, nset=left", "1, 2, 3", "*Elset, elset=edge",
              "1, 2, 5, 6, 9, 11"]
    return "\n".join(lines) + "\n" + sections + surface + """*Material, name=rubber
*Elastic
100., 0.
*MATERIAL, NAME=steel
*Elastic
300., 0.
*Step, nlgeom=NO
*Static
1., 1., 1e-05, 1.
*Boundary
left, 1, 2
*End Step
"""


_INLINE = ("*Solid Section, elset=soft, material=rubber\n"
           "*Solid Section, elset=stiff, material=steel\n")
_CAE = ("*Elset, elset=setq, generate\n1, 4, 1\n"
        "*Elset, elset=sett1\n5, 6, 9, 10\n*Elset, elset=sett2\n7, 8, 11, 12\n"
        "*Solid Section, elset=setq, material=steel\n"
        "*Solid Section, elset=sett1, material=steel\n"
        "*Solid Section, elset=sett2, material=rubber\n")
_SURFACE = "*Surface, type=ELEMENT, name=s\nedge, S1\n*Dsload\ns, P, 5.\n"


def _same_fields(t, j):
    assert dataclasses.fields(t) and [f.name for f in dataclasses.fields(t)] \
        == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "element_blocks":
            assert [(x[0], x[1]) for x in a] == [(x[0], x[1]) for x in b]
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x[2], y[2])
                assert x[2].dtype == y[2].dtype
        elif f.name in ("dirichlet_bcs", "neumann_bcs"):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                for k, v in dataclasses.asdict(y).items():
                    np.testing.assert_array_equal(
                        getattr(x, k) if k != "face_set" else x.face_set, v)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, f.name
        elif isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k], object),
                                              np.asarray(b[k], object))
        elif isinstance(b, list):  # block_element_ids
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("sections, surface, n_blocks", [
    (_INLINE, "", 2),
    (_INLINE, _SURFACE, 2),
    ("*Elset, elset=setq, generate\n1, 4, 1\n*Elset, elset=sett, generate\n"
     "5, 12, 1\n*Solid Section, elset=setq, material=steel\n"
     "*Solid Section, elset=sett, material=rubber\n", "", 2),
    (_CAE, "", 3),
], ids=["two blocks", "surface across blocks", "CAE layout", "CAE split"])
def test_read_inp_multi_matches_jax(tmp_path, sections, surface, n_blocks):
    path = tmp_path / "m.inp"
    path.write_text(_mixed_rect_text(sections, surface))
    tm, jm = T.read_inp_multi(str(path)), j_read_inp_multi(str(path))
    assert isinstance(tm, T.InpBlockModel)
    _same_fields(tm, jm)
    assert len(tm.element_blocks) == n_blocks and tm.dm == 2
    for bi in range(n_blocks):
        assert tm.material_of_block(bi) == jm.material_of_block(bi)
    if surface:
        # the surface spans a CPS4 and a CPS3 block: both face maps used
        assert len(tm.neumann_bcs) == 1 and tm.neumann_bcs[0].traction == -5.0
        assert len(tm.face_sets["s"]) == 6


def test_read_inp_multi_unresolvable_material_raises(tmp_path):
    path = tmp_path / "m.inp"
    path.write_text(_mixed_rect_text(
        "*Solid Section, elset=soft, material=rubber\n"))
    tm, jm = T.read_inp_multi(str(path)), j_read_inp_multi(str(path))
    assert tm.material_of_block(0) == jm.material_of_block(0)
    for model in (tm, jm):
        with pytest.raises(ValueError, match="cannot resolve the material"):
            model.material_of_block(1)
    path.write_text(_mixed_rect_text(_CAE.replace("5, 6, 9, 10", "5, 6, 7, 10")))
    for read in (T.read_inp_multi, j_read_inp_multi):
        with pytest.raises(ValueError, match="more than one"):
            read(str(path))


def test_read_inp_multi_of_a_single_block_model(tmp_path):
    """A one-type one-material model reads as read_inp reads it."""
    path = tmp_path / "m.inp"
    path.write_text(_hex_box())
    multi, single = T.read_inp_multi(str(path)), T.read_inp(str(path))
    (etype, _, conn), = multi.element_blocks
    assert etype == single.element_type
    np.testing.assert_array_equal(conn, single.elements)
    assert multi.material_of_block(0) == (single.material_type,
                                          single.material_params)
    assert [b.face_set for b in multi.neumann_bcs] == [
        b.face_set for b in single.neumann_bcs]


# --------------------------------------------------------------------------- #
# colormap, exporters, GIF, trace
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mod", range(1, 8))
def test_colormap_matches_jax(mod):
    x = np.random.default_rng(mod).random((4, 5))
    np.testing.assert_array_equal(tcmap.ramp(x, mod), jcmap.ramp(x, mod))
    for v in (-0.5, 0.0, 0.3, 1.0, 1.0005, 2.0):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert tcmap.get_color(v, mod) == jcmap.get_color(v, mod)
    t_cm, j_cm = tcmap.resolve_cmap(f"femcy{mod}"), jcmap.resolve_cmap(
        f"femcy{mod}")
    assert t_cm.name == j_cm.name
    np.testing.assert_array_equal(t_cm.colors, j_cm.colors)
    assert tcmap.resolve_cmap("viridis") == "viridis"
    with pytest.raises(ValueError, match="unknown color ramp"):
        tcmap.ramp(0.5, 8)


@pytest.mark.parametrize("name", ["box_tets", "box_hexes", "rect_tris",
                                  "box_wedges", "box_hexes20"])
def test_patch_values_and_nodal_average_match_jax(name):
    args = {"box_tets": (2, 3, 2), "box_hexes": (2, 2, 3), "rect_tris": (4, 3),
            "box_wedges": (2, 2, 2), "box_hexes20": (2, 1, 1)}[name]
    jm = getattr(F.meshgen, name)(*args)
    tm = convert.mesh_from(jm)
    vals = np.random.default_rng(1).random((jm.n_elements, jm.element.n_nodes))
    t_tris, t_vals = texport._patch_vertex_values(tm, vals)
    j_tris, j_vals = jexport._patch_vertex_values(jm, vals)
    np.testing.assert_array_equal(t_tris, j_tris)
    np.testing.assert_array_equal(t_vals, j_vals)
    np.testing.assert_array_equal(texport.average_nodal_field(tm, vals),
                                  jexport.average_nodal_field(jm, vals))
    blocks = ([tm, tm], [vals, 2.0 * vals])
    np.testing.assert_array_equal(
        texport.average_nodal_field_blocks(tm.n_nodes, *blocks),
        jexport.average_nodal_field_blocks(jm.n_nodes, [jm, jm],
                                           [vals, 2.0 * vals]))


def test_export_vtk_wedge6_hex20(tmp_path):
    """C3D6 and C3D20 cells as VTK 13 and 25, byte for byte femcy_tpu's
    file; the multi-block writer mixes the two."""
    for name, ct in (("box_wedges", 13), ("box_hexes20", 25)):
        jm = getattr(F.meshgen, name)(2, 2, 2)
        tm = convert.mesh_from(jm)
        dof = np.random.default_rng(2).standard_normal(tm.n_dof)
        cell = {"c": np.arange(tm.n_elements, dtype=float)}
        t_path = texport.export_vtk(tm, str(tmp_path / "t.vtk"), dof=dof,
                                    cell_data=cell)
        j_path = jexport.export_vtk(jm, str(tmp_path / "j.vtk"), dof=dof,
                                    cell_data=cell)
        text = pathlib.Path(t_path).read_text()
        assert text == pathlib.Path(j_path).read_text()
        types = text.split("CELL_TYPES")[1].split("\n")[1:1 + tm.n_elements]
        assert all(int(t) == ct for t in types)
    w, h = T.meshgen.box_wedges(1, 1, 1), T.meshgen.box_hexes20(1, 1, 1)
    nodes = np.concatenate([w.nodes, h.nodes])
    blocks = [(w.elements, "wedge6"), (h.elements + w.n_nodes, "hex20")]
    args = (nodes, blocks)
    texport.export_vtk_blocks(*args, str(tmp_path / "tb.vtk"))
    jexport.export_vtk_blocks(*args, str(tmp_path / "jb.vtk"))
    assert (tmp_path / "tb.vtk").read_text() == (tmp_path / "jb.vtk").read_text()


def test_export_html_blocks_matches_jax(tmp_path):
    jm = F.meshgen.box_tets(2, 2, 2)
    tm = convert.mesh_from(jm)
    dof = np.random.default_rng(3).standard_normal(tm.n_dof) * 0.01
    vals = np.random.default_rng(4).random((tm.n_elements, 4))
    from femcy_tpu.io import html as jhtml

    thtml.export_html_blocks([tm, tm], dof, [vals, vals], str(tmp_path / "t"))
    jhtml.export_html_blocks([jm, jm], dof, [vals, vals], str(tmp_path / "j"))
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()


def test_gif_helpers_match_jax(tmp_path):
    mesh = T.meshgen.rect_tris(3, 2)
    dof = np.zeros(mesh.n_dof)
    patch = np.ones((mesh.n_elements, 3))
    frames = []
    for i in (2, 0, 1, 10):
        f = str(tmp_path / f"f_{i}.png")
        texport.export_png(mesh, dof, patch * (i + 1), f)
        frames.append(f)
    (tmp_path / "notes.png").write_bytes(b"")  # no number: not a frame
    ordered = [str(tmp_path / f"f_{i}.png") for i in (0, 1, 2, 10)]
    assert tgif.collect_frames(str(tmp_path), r"f_(\d+)\.png$") == ordered
    assert jgif.collect_frames(str(tmp_path), r"f_(\d+)\.png$") == ordered
    t_gif = tgif.frames_to_gif(ordered, str(tmp_path / "t.gif"))
    j_gif = jgif.frames_to_gif(ordered, str(tmp_path / "j.gif"))
    assert Image.open(t_gif).n_frames == Image.open(j_gif).n_frames == 4
    assert pathlib.Path(t_gif).read_bytes() == pathlib.Path(j_gif).read_bytes()
    with pytest.raises(ValueError, match="no frames"):
        tgif.frames_to_gif([], str(tmp_path / "x.gif"))


def test_device_trace(tmp_path):
    """A directory gets a Chrome trace of the block's ops; None traces
    nothing and leaves the work where it was."""
    x = torch.ones(64, dtype=torch.float64)
    with device_trace(str(tmp_path / "trace")):
        y = (x * 2.0).sum()
    (trace,) = list((tmp_path / "trace").iterdir())
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)
    assert y.device.type == "cpu" and float(y) == 128.0
    with device_trace(None):
        z = (x * 3.0).sum()
    assert float(z) == 192.0 and len(list((tmp_path / "trace").iterdir())) == 1
    with device_trace(str(tmp_path / "trace")):
        pass
    assert len(list((tmp_path / "trace").iterdir())) == 2
