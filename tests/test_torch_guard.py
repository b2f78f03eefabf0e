"""Guards of the port's boundaries: it imports no JAX and no femcy_tpu, it
never runs a CUDA request on the CPU, and a missing nvcc is a clear error.
"""

import pathlib
import subprocess
import sys
import textwrap

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
            dia_spmv, structured_accumulate, structured_fused)
        from femcy_tpu_torch.solvers import multigrid

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
                        config=T.SolverConfig(linear_solver="cg"))
        assert s.solve(inp).success and s._last_cg_iters > 0
        m = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3),
                        config=T.SolverConfig(linear_solver="cg",
                                              preconditioner="multigrid"))
        assert m.solve(inp).success and m._last_cg_iters > 0
        assert np.isfinite(s.dof.numpy()).all()
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
