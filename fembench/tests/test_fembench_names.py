"""Everything a cell needs is found by name, and a cell, a configuration,
a mesh generator, a system, a traffic mix with a procedure of its own or
a per-layer metric is added by adding files and entries alone."""

import json
import shutil
import textwrap
import time

import pytest

from fembench.harness import bench

PROCEDURES = {"twist", "load_cases"}


def _bench():
    with open(bench.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_finds_its_files():
    b = _bench()
    for w in b["workloads"]:
        spec = bench.load_spec(w["name"])
        assert spec.config["name"] == w["config"]
        assert spec.procedure.__name__.endswith(spec.mix["procedure"])
        assert spec.mix["procedure"] in PROCEDURES
        for f in ("case", "prepare", "solve", "ended", "numbers"):
            assert callable(getattr(spec.procedure, f)), f
        assert callable(spec.system.build) and callable(spec.system.recover)
        assert spec.limits
        assert len(spec.end_to_end) >= 2
        assert spec.per_layer


def test_metric_readers_declare_what_benchmark_json_says():
    for m in _bench()["per_layer"]:
        mod = bench.metric_reader(m["name"])
        assert (mod.UNIT, mod.LAYER) == (m["unit"], m["layer"])
        assert callable(mod.read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    b = _bench()
    for w in b["workloads"]:
        spec = bench.load_spec(w["name"])
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert all(m["moves"] in names for m in spec.per_layer)


def test_every_per_layer_metric_lists_its_cells():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


GENERATOR = '''
    """Box tets with their elements in an order the seed shuffles."""
    import numpy as np

    from fembench.harness import named
    from fembench.harness.meshes import Mesh


    def build(nx, seed):
        m = named.module("generators", "box_tets").build(nx, nx, nx)
        order = np.random.default_rng(seed).permutation(len(m.elements))
        return Mesh(m.nodes, m.elements[order], None)
'''

SYSTEM = '''
    """The FEMSystem, by another name."""
    from fembench.harness import named

    _base = named.module("systems", "fem_system")
    build, recover = _base.build, _base.recover
'''

PROCEDURE = '''
    """Linear pulls of the unit box: the z=0 face clamped, the z=1 face's
    z-dofs prescribed at ``a``, drawn from the mix's ``amplitude``."""
    from fembench.harness import checks, meshes

    NONLINEAR = False


    def case(mix, draw):
        return {"a": draw("amplitude")}


    def prepare(mesh):
        return meshes.faces(mesh.nodes)


    def solve(program, case, keep):
        bottom, top = program.prepared
        bcs = [(bottom, d, 0.0, False) for d in range(3)]
        bcs.append((top, 2, case["a"], False))
        inp = program.inp_model(bcs, {"ini_inc": 1.0, "max_time": 1.0,
                                      "min_inc": 1e-5, "max_inc": 1.0})
        return program.system.solve(inp).success, {}


    def ended(sample):
        return sample["success"]


    def numbers(torch, model, sample):
        bottom, top = meshes.faces(model.nodes.cpu().numpy())
        n = model.n_nodes
        u = sample["u"].to(model.device, torch.float64).view(n, 3)
        f = model.internal_force(u, large=False)
        free = torch.ones_like(f, dtype=torch.bool)
        free[bottom] = False
        free[top, 2] = False
        out = {"residual_free": float(f[free].abs().max()
                                      / f[~free].abs().max()),
               "pull_gap": float((u[top, 2] - sample["case"]["a"]).abs().max())}
        out.update(checks.field_gaps(model, sample, u, large=False))
        return out
'''


def _add_cell(root):
    """A new cell on a new configuration (a new generator and system), a
    new mix with a procedure of its own, its limits and a new metric, each
    a new file, and new entries in BENCHMARK.json."""
    shutil.copytree(bench.ROOT / "fembench", root / "fembench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    fb = root / "fembench"
    (fb / "generators/shuffled_box_tets.py").write_text(
        textwrap.dedent(GENERATOR))
    (fb / "systems/fem_system_again.py").write_text(textwrap.dedent(SYSTEM))
    (fb / "procedures/z_pull.py").write_text(textwrap.dedent(PROCEDURE))
    cfg = json.loads((fb / "configs/box1m.json").read_text())
    cfg.update(name="pull3", system="fem_system_again",
               mesh={"generator": "shuffled_box_tets", "nx": 3, "seed": 5})
    (fb / "configs/pull3.json").write_text(json.dumps(cfg))
    (fb / "traffic/z_pull.json").write_text(json.dumps({
        "procedure": "z_pull", "amplitude": [0.001, 0.002],
        "warmup": [{"amplitude": 0.0015}], "sample": 2, "trace_analyses": 1,
        "solver": {"cg_eps": 1e-10}}))
    (fb / "limits/pull3.z_pull.json").write_text(json.dumps({
        "residual_free": {"limit": 1e-6}, "pull_gap": {"limit": 1e-12},
        "strain_gap": {"limit": 1e-8}, "stress_gap": {"limit": 1e-8},
        "mises_gap": {"limit": 1e-8}}))
    (fb / "metrics/walls_total_s.py").write_text(
        'UNIT, LAYER = "s", "analysis loop"\n\n\n'
        "def read(run):\n    return sum(a.wall_s for a in run.analyses)\n")
    b = _bench()
    cell = "pull3.z_pull"
    b["configs"].append(dict(b["configs"][0], name="pull3",
                             file="fembench/configs/pull3.json"))
    b["workloads"].append({"name": cell, "config": "pull3",
                           "traffic": "z_pull", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "walls_total_s", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "analysis loop", "moves": "solve_s",
                           "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return cell


def test_a_cell_is_added_by_files_alone(tmp_path):
    cell = _add_cell(tmp_path)
    spec = bench.load_spec(cell, tmp_path)
    assert spec.procedure.__name__.endswith("z_pull")
    assert spec.system.__name__.endswith("fem_system_again")
    assert [m["name"] for m in spec.per_layer] == ["walls_total_s"]
    assert "walls_total_s" not in [
        m["name"] for m in bench.load_spec("box1m.twist", tmp_path).per_layer]
    # the whole run, on the CPU: the new generator, system and procedure
    # drive the program, and the reference judges it by the new numbers
    result, _, analyses = bench.run(spec, 2**31 + 3, 0.2, False, "cpu",
                                    time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"residual_free", "pull_gap",
                                     "strain_gap", "stress_gap", "mises_gap"}
    assert {"solve_s", "setup_s"} <= set(result["metrics"])
    reader = bench.metric_reader("walls_total_s", tmp_path)
    run = bench.Record(analyses, 1.0, None, None, 8, "cpu", None, None)
    assert reader.read(run) == pytest.approx(sum(a.wall_s for a in analyses))


def test_a_split_metric_is_read_by_its_base():
    assert bench.metric_reader("linear_solve_ms.host").read is not None
    assert (bench.metric_reader("linear_solve_ms.host").UNIT
            == bench.metric_reader("linear_solve_ms").UNIT)
