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
            dia_spmv, ell_scatter, ell_spmv, internal_force,
            structured_accumulate, structured_force, structured_fused)
        from femcy_tpu_torch import user
        from femcy_tpu_torch.native import loader
        from femcy_tpu_torch.solvers import cg, multigrid
        from femcy_tpu_torch import assembly_host, topology

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


def test_package_sources_never_import_jax():
    pkg = pathlib.Path(femcy_tpu_torch.__file__).parent
    for path in pkg.rglob("*.py"):
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


@pytest.mark.parametrize("entry", ["FEMSystem", "StructuredMultigrid"])
def test_default_device_is_the_card(monkeypatch, entry):
    """Both entry points default to CUDA: with no card that default raises
    as an explicit device="cuda" does, and device="cpu" still builds."""
    from femcy_tpu_torch.solvers.multigrid import StructuredMultigrid

    mesh = meshgen.box_tets(2, 2, 2)
    mat = LinearIsotropic(1000.0, 0.3)
    if entry == "FEMSystem":
        def build(**kw):
            return FEMSystem(mesh, mat, **kw)
    else:
        def build(**kw):
            return StructuredMultigrid(mesh, mat, np.zeros(mesh.n_dof, bool),
                                       coarsest_max_dof=10**6, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        build()
    assert build(device="cpu").device == torch.device("cpu")


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
