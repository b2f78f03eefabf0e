"""Helpers of the benchmark's CPU tests: every cell at a size the CPU
holds, driven through the harness with its look for a card skipped."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: mesh sizes of the CPU runs: the multigrid needs grids that halve
SMALL = {"box1m.twist": 4, "ell1m.amg_cases": 8, "ell1m.jacobi_cases": 8}


def small_spec(cell: str):
    from fembench.harness import bench

    spec = bench.load_spec(cell)
    mesh = dict(spec.config["mesh"], nx=SMALL[cell])
    if "ny" in mesh:
        mesh.update(ny=SMALL[cell], nz=SMALL[cell])
    spec.config["mesh"] = mesh
    return spec


def cpu_run(cell: str, seed: int = 2**31 + 7, seconds: float = 0.3,
            dtype=None):
    """One run of ``cell`` on the CPU at its small size; the result line."""
    from fembench.harness import bench

    result, _, _ = bench.run(small_spec(cell), seed, seconds, False, "cpu",
                             time.perf_counter(), dtype=dtype)
    return result


@pytest.fixture(autouse=True)
def _x64(monkeypatch):
    # the harness sets the program's dtype switch; restore it after each test
    monkeypatch.setenv("FEMCY_TPU_X64", "1")
