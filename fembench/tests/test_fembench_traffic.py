"""The generator: a seed fixes the stream, warm-up is the same on every
seed, cycles send the same set of sizes to every seed."""

import itertools
import json
import math

import numpy as np

from fembench.harness import bench, named, traffic

MIXES = ["twist", "amg_cases", "jacobi_cases"]


def _mix(name):
    with open(bench.ROOT / "fembench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _proc(mix):
    return named.module("procedures", mix["procedure"])


def _take(mix, seed, n):
    return list(itertools.islice(traffic.stream(mix, seed, _proc(mix)), n))


def test_same_seed_same_stream():
    for name in MIXES:
        mix = _mix(name)
        assert _take(mix, 2**31 + 5, 20) == _take(mix, 2**31 + 5, 20)
        assert _take(mix, 2**31 + 5, 20) != _take(mix, 2**31 + 6, 20)


def test_draws_stay_in_their_ranges():
    mix = _mix("amg_cases")
    for c in _take(mix, 3, 200):
        assert 0.005 <= c["a"] <= 0.01
        assert 0.0 <= c["theta"] <= 2 * math.pi


def test_cycle_sends_every_seed_the_same_sizes():
    mix = _mix("twist")
    sizes = sorted(mix["inc"]["cycle"])
    k = len(sizes)
    for seed in (1, 2**31 + 11, 4_000_000_000):
        incs = [c["inc"] for c in _take(mix, seed, 3 * k)]
        for j in range(3):
            assert sorted(incs[j * k:(j + 1) * k]) == sizes
        assert {c["sense"] for c in _take(mix, seed, 40)} == {-1.0, 1.0}


def test_warmup_does_not_depend_on_the_seed():
    mix = _mix("twist")
    twist = traffic.warmup_cases(mix, _proc(mix))
    assert twist == [{"inc": 0.0038, "sense": 1.0, "increments": 1,
                      "center": [0.5, 0.5]}]
    mix = _mix("jacobi_cases")
    assert traffic.warmup_cases(mix, _proc(mix)) == [
        {"a": 0.0075, "theta": 1.0}, {"a": 0.0075, "theta": 4.0}]


def test_twist_times_end_where_the_analysis_ends():
    t = named.module("procedures", "twist").times(0.00368, 5)
    assert len(t) == 5 and t[0] == 0.00368
    s = 0.0
    for _ in range(5):  # the load stepping's own sum
        s = min(s + 0.00368, t[-1])
    assert s == t[-1]


def test_prescribed_dofs():
    nodes = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1.0], [1, 1, 1.0],
                      [0.5, 0.5, 0.5]])
    case = {"a": 0.01, "theta": math.pi / 2}
    fixed, sval = named.module("procedures", "load_cases").prescribed(
        case, nodes)
    assert fixed.tolist() == [1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 0]
    assert np.allclose(sval[6:8], [0.0, 0.01])
    twist = {"sense": -1.0, "center": [0.5, 0.5]}
    fixed, sval = named.module("procedures", "twist").prescribed(
        twist, nodes, 0.5)  # a quarter turn
    assert fixed[6:12].all() and not fixed[12:].any()
    # the hook's rows [cos, sin; -sin, cos] at -90 degrees take (0, 0),
    # relative to (0.5, 0.5), to (1, 0), and (1, 1) to (0, 1)
    assert np.allclose(sval[6:9], [1.0, 0.0, 0.0])
    assert np.allclose(sval[9:12], [-1.0, 0.0, 0.0])
