"""Guards of the port's boundaries: it imports no JAX and no femcy_tpu, it
never runs a CUDA request on the CPU, and a missing nvcc is a clear error.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import femcy_tpu_torch
from femcy_tpu_torch import FEMSystem, LinearIsotropic, meshgen
from femcy_tpu_torch.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_imports_and_solves_without_jax():
    """In a fresh interpreter where importing jax or femcy_tpu fails, the
    package imports and solves a small box on the CPU."""
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["femcy_tpu"] = None
        import numpy as np
        import femcy_tpu_torch as T
        from femcy_tpu_torch.io.inp import DirichletBC, InpModel
        from femcy_tpu_torch.kernels import (
            bell_spmv, dia_spmv, ell_scatter, ell_spmv, internal_force,
            mixed_scatter, structured_accumulate, structured_force,
            structured_fused)
        from femcy_tpu_torch import cli, user
        from femcy_tpu_torch.io import colormap, export, html
        from femcy_tpu_torch.native import loader
        from femcy_tpu_torch.utils import gif, timing
        from femcy_tpu_torch.solvers import amg, bell, cg, multigrid, riks
        from femcy_tpu_torch import assembly_host, topology
        from femcy_tpu_torch import beam, device_loop, mixed, multiblock
        from femcy_tpu_torch.kernels import btd_scatter
        from femcy_tpu_torch.parallel import banded, sharded, shards
        from femcy_tpu_torch.parallel import structured

        mesh = T.meshgen.box_tets(3, 2, 2)
        bottom = np.nonzero(mesh.nodes[:, 2] < 1e-9)[0]
        top = np.nonzero(mesh.nodes[:, 2] > 1 - 1e-9)[0]
        bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
        bcs.append(DirichletBC(top, 0, 0.01))
        inp = InpModel(mesh.nodes, mesh.elements, "C3D4", {}, {}, {}, bcs,
                       [], "Elastic", [1000.0, 0.3], False,
                       {"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                        "max_inc": 1.0})
        s = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3),
                        config=T.SolverConfig(linear_solver="cg"),
                        device="cpu")
        assert s.solve(inp).success and s._last_cg_iters > 0
        m = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3),
                        config=T.SolverConfig(linear_solver="cg",
                                              preconditioner="multigrid"),
                        device="cpu")
        assert m.solve(inp).success and m._last_cg_iters > 0
        assert np.isfinite(s.dof.numpy()).all()
        # the general ELL path, with the native pattern library
        u = T.meshgen.unstructured_box_tets(3)
        ub = np.nonzero(u.nodes[:, 2] < 1e-9)[0]
        ut = np.nonzero(u.nodes[:, 2] > 1 - 1e-9)[0]
        ubcs = [DirichletBC(ub, d, 0.0) for d in range(3)]
        ubcs.append(DirichletBC(ut, 0, 0.01))
        uinp = InpModel(u.nodes, u.elements, "C3D4", {}, {}, {}, ubcs, [],
                        "Elastic", [1000.0, 0.3], False, inp.time_incs)
        g = T.FEMSystem(u, T.LinearIsotropic(1000.0, 0.3),
                        config=T.SolverConfig(linear_solver="cg"),
                        device="cpu")
        assert g.dia is None and loader.get_lib() is not None
        assert g.solve(uinp).success and g._last_cg_iters > 0
        # and by the algebraic multigrid
        a = T.FEMSystem(u, T.LinearIsotropic(1000.0, 0.3),
                        config=T.SolverConfig(linear_solver="cg",
                                              preconditioner="amg"),
                        device="cpu")
        assert a.solve(uinp).success and a._amg is not None
        # the Newton path on both layouts, the top face turned by the
        # rotation hook
        tinp = InpModel(mesh.nodes, mesh.elements, "C3D4", {}, {}, {},
                        bcs[:3] + [DirichletBC(top, d, 0.0, True)
                                   for d in range(3)],
                        [], "Elastic", [1000.0, 0.3], True,
                        {"ini_inc": 0.05, "max_time": 0.05, "min_inc": 1e-5,
                         "max_inc": 0.05})
        hook = user.make_rotation_dirichlet((0.5, 0.5, 0.0))
        for nl in (mesh, u):
            n = T.FEMSystem(nl, T.LinearIsotropic(1000.0, 0.3), True,
                            T.SolverConfig(linear_solver="direct"),
                            device="cpu")
            if nl is u:
                ut3 = [DirichletBC(ut, d, 0.0, True) for d in range(3)]
                tinp = InpModel(u.nodes, u.elements, "C3D4", {}, {}, {},
                                ubcs[:3] + ut3, [], "Elastic",
                                [1000.0, 0.3], True, tinp.time_incs)
            rep = n.solve(tinp, user_dirichlet=hook)
            assert rep.success and rep.increments[0].newton_iters > 0
        # a two-block plate (CPS4 + CPS3, two materials) by the CG, and a
        # beam
        nodes = np.array([[i * 0.5, j * 0.5] for i in range(5)
                          for j in range(3)])
        cells = [(3 * i + j, 3 * i + j + 3, 3 * i + j + 4, 3 * i + j + 1)
                 for i in range(4) for j in range(2)]
        quads = np.array(cells[:4], np.int32)
        tris = np.array([t for a, b, c, d in cells[4:]
                         for t in ((a, b, c), (a, c, d))], np.int32)
        mb = T.MultiBlockSystem(nodes, [
            T.ElementBlock(quads, T.meshgen.rect_quads(1, 1).element,
                           T.LinearIsotropicPlaneStress(100.0, 0.3)),
            T.ElementBlock(tris, T.meshgen.rect_tris(1, 1).element,
                           T.LinearIsotropicPlaneStress(300.0, 0.3))],
            T.SolverConfig(linear_solver="cg"), device="cpu")
        x = nodes[:, 0]
        fixed = np.zeros(mb.n_dof, bool)
        fixed[np.nonzero(x < 1e-9)[0][:, None] * 2 + np.arange(2)] = True
        rhs = np.zeros(mb.n_dof)
        rhs[np.nonzero(x > 2 - 1e-9)[0] * 2] = 1.0
        dof = mb.solve(rhs, fixed, np.zeros(mb.n_dof)).numpy()
        assert mb._last_cg_iters > 0 and np.isfinite(dof).all()
        assert dof[np.nonzero(x > 2 - 1e-9)[0] * 2].min() > 0
        cant = T.BeamModel(np.array([[0., 0, 0], [1, 0, 0]]),
                           np.array([[0, 1]], np.int32),
                           T.BeamSection.circ(0.1), 1000.0, 0.3,
                           [(0, d, 0.0) for d in range(6)], [(1, 1, 1.0)])
        assert T.solve_beam(cant, device="cpu").u[1, 1] > 0
        # the beam on a tet: the mixed beam + continuum route
        tet = T.meshgen.box_tets(1, 1, 1)
        mixed_model = T.MixedModel(
            tet.nodes, [T.ElementBlock(tet.elements, tet.element,
                                       T.LinearIsotropic(1000.0, 0.3))],
            [T.BeamBlock(np.array([[6, 7]], np.int32), T.BeamSection.circ(0.1),
                         1000.0, 0.3)],
            [(n, d, 0.0) for n in range(4) for d in range(3)]
            + [(6, d, 0.0) for d in range(3, 6)], [(7, 1, 1.0)], [])
        assert T.solve_mixed(mixed_model, device="cpu").u[7, 1] > 0
        assert not any(m == "jax" or m.startswith(("jax.", "femcy_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cli_runs_without_matplotlib_and_pillow(tmp_path):
    """As on the card's machine: with matplotlib and PIL absent, ``cli``
    and ``io.export`` import and the CLI writes its VTK and HTML outputs;
    only the PNG route needs them."""
    inp = tmp_path / "m.inp"
    inp.write_text(textwrap.dedent(
        """\
        *Node
        1, 0., 0.
        2, 1., 0.
        3, 0., 1.
        4, 1., 1.
        *Element, type=CPS3
        1, 1, 2, 4
        2, 1, 4, 3
        *Nset, nset=fix, instance=a
        1, 3
        *Nset, nset=pull, instance=a
        2, 4
        *Material, name=m
        *Elastic
        1000., 0.3
        *Step, nlgeom=NO
        *Static
        1., 1., 1e-05, 1.
        *Boundary
        fix, 1, 2
        pull, 1, 1, 0.01
        *End Step
        """))
    script = textwrap.dedent(
        f"""
        import sys
        for name in ("matplotlib", "PIL", "mpl_toolkits", "jax",
                     "femcy_tpu"):
            sys.modules[name] = None
        from femcy_tpu_torch import cli
        from femcy_tpu_torch.io import export, html
        rc = cli.main([{str(inp)!r}, "--platform", "cpu",
                       "--save-vtk", {str(tmp_path / "m.vtk")!r},
                       "--save-html", {str(tmp_path / "m.html")!r}])
        assert rc == 0
        try:
            cli.main([{str(inp)!r}, "--platform", "cpu",
                      "--save-png", {str(tmp_path / "m.png")!r}])
        except ImportError as exc:
            print("png:", exc)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "wrote" in out.stdout and "png: import of matplotlib" in out.stdout
    assert (tmp_path / "m.vtk").exists() and (tmp_path / "m.html").exists()
    assert not (tmp_path / "m.png").exists()


def test_package_sources_never_import_jax():
    """Neither the package's sources nor chip_smoke.py, which runs on the
    card's machine, import JAX or femcy_tpu."""
    pkg = pathlib.Path(femcy_tpu_torch.__file__).parent
    sources = set(pkg.rglob("*.py"))
    assert (pkg / "device_loop.py") in sources
    for name in ("structured.py", "sharded.py", "banded.py", "shards.py"):
        assert (pkg / "parallel" / name) in sources
    assert (pkg / "kernels" / "btd_scatter.py") in sources
    for path in sorted(sources) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert mod != "jax" and not mod.startswith("jax."), path
                assert mod != "femcy_tpu" and not mod.startswith(
                    "femcy_tpu."), path


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        FEMSystem(meshgen.box_tets(2, 2, 2), LinearIsotropic(1000.0, 0.3),
                  device="cuda")


@pytest.mark.parametrize("entry", ["FEMSystem", "StructuredMultigrid",
                                   "MultiBlockSystem", "solve_beam",
                                   "amg_from", "dof_from",
                                   "ShardedLinearSolver", "ShardedNewtonStep",
                                   "BandedShardedSolver", "FEMSystem banded"])
def test_default_device_is_the_card(monkeypatch, entry):
    """Every entry point defaults to CUDA: with no card that default raises
    as an explicit device="cuda" does, and device="cpu" still runs."""
    from femcy_tpu_torch import BeamModel, BeamSection, ElementBlock
    from femcy_tpu_torch import MultiBlockSystem, solve_beam
    from femcy_tpu_torch.solvers.multigrid import StructuredMultigrid

    mesh = meshgen.box_tets(2, 2, 2)
    mat = LinearIsotropic(1000.0, 0.3)
    if entry == "FEMSystem":
        def build(**kw):
            return FEMSystem(mesh, mat, **kw).device
    elif entry == "StructuredMultigrid":
        def build(**kw):
            return StructuredMultigrid(mesh, mat, np.zeros(mesh.n_dof, bool),
                                       coarsest_max_dof=10**6, **kw).device
    elif entry == "MultiBlockSystem":
        def build(**kw):
            half = mesh.elements.shape[0] // 2
            return MultiBlockSystem(mesh.nodes, [
                ElementBlock(mesh.elements[:half], mesh.element, mat),
                ElementBlock(mesh.elements[half:], mesh.element, mat)],
                **kw).device
    elif entry == "amg_from":
        from types import SimpleNamespace

        from femcy_tpu_torch import convert

        # a one-level hierarchy with the reference's attribute names
        level = SimpleNamespace(
            n_dof=3, bs=3, lmax=2.0, inv_diag=np.ones(3), values=None,
            colidx=None, P_values=None, P_colidx=None, R_values=None,
            R_colidx=None)
        ref = SimpleNamespace(
            levels=[level], smooth_steps=2, cheby_alpha=4.0, _fine_nnz=9.0,
            setup_seconds={}, _coarse_smooth_only=False, _single=True,
            _coarse_inv=np.eye(3))

        def build(**kw):
            return convert.amg_from(ref, **kw).device
    elif entry == "dof_from":
        from femcy_tpu_torch import convert

        def build(**kw):
            return convert.dof_from(np.zeros(mesh.n_dof), **kw).device
    elif entry in ("ShardedLinearSolver", "ShardedNewtonStep",
                   "BandedShardedSolver"):
        from femcy_tpu_torch import parallel
        from femcy_tpu_torch.parallel.banded import BandedShardedSolver

        cls = (BandedShardedSolver if entry == "BandedShardedSolver"
               else getattr(parallel, entry))

        def build(**kw):
            # the shards' devices: one per card by default, or as given
            devices = [kw["device"]] * 2 if kw else None
            return cls(mesh, mat, devices=devices).devices[0]
    elif entry == "FEMSystem banded":
        from femcy_tpu_torch import SolverConfig

        def build(**kw):
            cfg = SolverConfig(sharding="banded", sharding_devices=2)
            s = FEMSystem(mesh, mat, config=cfg, **kw)
            assert {sh.device for sh in s._shard_sys.shards} == {s.device}
            return s.device
    else:
        def build(**kw):
            beam = BeamModel(np.array([[0.0, 0, 0], [1, 0, 0]]),
                             np.array([[0, 1]], np.int32),
                             BeamSection.circ(0.1), 1000.0, 0.3,
                             [(0, d, 0.0) for d in range(6)], [(1, 1, 1.0)])
            solve_beam(beam, **kw)
            return torch.device(kw["device"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        build()
    assert build(device="cpu") == torch.device("cpu")


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", (str(tmp_path / "nvcc"),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not (tmp_path / "build").exists()


def test_build_reports_nvcc_failure(tmp_path, monkeypatch):
    """A compiler that fails surfaces its stderr in the error."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: error in dia_spmv.cu' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake nvcc: error in dia_spmv.cu"):
        _build.build_library()
    assert list((tmp_path / "build").iterdir()) == []  # no partial library


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    a = _build.library_path()
    assert a.parent == tmp_path and a.name.startswith("libfemcy_kernels-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path() != a
