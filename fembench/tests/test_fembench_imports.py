"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference loads nothing of the
program."""

import ast
import json
import os
import pathlib
import subprocess
import sys

from fembench.harness import bench

HERE = pathlib.Path(bench.ROOT) / "fembench"

PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
from conftest import cpu_run
r = cpu_run("ell1m.jacobi_cases", seconds=0.0)
from fembench.harness import bench
print(json.dumps({"correct": r["correct"], "bad": bench.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, FEMCY_TPU_X64="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(bench.ROOT), str(HERE / "tests")],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["bad"] == []
    assert "femcy_tpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "femcy_tpu"} & set(got["top"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "femcy_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "femcy_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in bench.forbidden_modules()


def test_reference_and_yardstick_import_nothing_of_the_program():
    files = [p for kind in ("reference", "metrics", "procedures",
                            "generators", "harness")
             for p in (HERE / kind).glob("*.py") if p.name != "program.py"]
    for p in files:
        bad = _imports(p) & {"femcy_tpu_torch", "femcy_tpu", "jax"}
        assert not bad, (p.name, bad)
    # the system under test is imported by program.py and the systems alone
    for p in [HERE / "harness" / "program.py", *(HERE / "systems").glob("*.py")]:
        assert _imports(p) & {"femcy_tpu_torch", "femcy_tpu", "jax"} == {
            "femcy_tpu_torch"}, p.name
