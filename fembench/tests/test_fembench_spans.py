"""The program's spans in a profile: attribution of device operations by
their launch, on synthetic kineto events and on a real CPU profile, and
the readers of the metrics that read the spans."""

import types

import numpy as np
import pytest
import torch

from fembench.harness import named, spans, trace

C, G = "cpu", "gpu"


class _E:
    """A kineto event as the profiler gives it."""

    def __init__(self, name, dev, s, t, corr=0):
        self._n, self._d, self._s, self._t, self._c = name, dev, s, t, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._t - self._s) * 1e9)


def _span(name, s, t, corr=0):
    return _E(name, C, s, t, corr)


def _launch(at, corr, name="cudaLaunchKernel"):
    return _E(name, C, at, at + 0.01, corr)


def _op(s, t, corr, name="kernel"):
    return _E(name, G, s, t, corr)


EVENTS = [
    _span("femcy.solve", 0.0, 10.0),
    _span("femcy.pcg", 1.0, 9.0),
    _span("femcy.pcg.iter", 2.0, 4.0),
    _span("femcy.pcg.precond", 3.0, 3.5),
    _span("femcy.pcg.iter", 5.0, 7.0),
    _span("aten::mul", 2.4, 2.6, 16),  # no span; its id is in another space
    _launch(0.5, 13),  # in femcy.solve alone
    _launch(2.5, 11),  # in an iteration
    _launch(3.2, 12),  # in its preconditioner
    _launch(6.0, 15, "cudaMemcpyAsync"),
    _launch(6.5, 16, "cuLaunchKernel"),
    _launch(11.0, 14),  # outside every span
    _op(0.6, 0.7, 13),
    _op(2.6, 2.8, 11),
    _op(9.5, 9.9, 12),  # runs after its spans have closed
    _op(6.1, 6.4, 15, "Memcpy DtoH (Device -> Pinned)"),
    _op(6.6, 6.7, 16),
    _op(11.1, 11.2, 14),
    _op(0.0, 10.0, 12, trace.WINDOW),  # a range's image, no work
    _op(2.0, 3.9, 11, trace.SECTION + "linear_solve"),
    _op(8.0, 8.5, 99),  # no launch in the profile
]


def test_an_operation_counts_for_every_span_open_at_its_launch():
    out = spans.attribute(EVENTS, G)
    assert set(out) == {"femcy.solve", "femcy.pcg", "femcy.pcg.iter",
                        "femcy.pcg.precond"}
    solve, pcg = out["femcy.solve"], out["femcy.pcg"]
    it, pre = out["femcy.pcg.iter"], out["femcy.pcg.precond"]
    assert (solve.count, solve.ops) == (1, 5)
    assert solve.device_s == pytest.approx(0.1 + 0.2 + 0.4 + 0.3 + 0.1)
    assert (pcg.count, pcg.ops) == (1, 4)
    assert pcg.device_s == pytest.approx(0.2 + 0.4 + 0.3 + 0.1)
    assert (it.count, it.ops) == (2, 4)
    assert it.host_s == pytest.approx(4.0)
    assert (pre.count, pre.ops) == (1, 1)
    assert pre.device_s == pytest.approx(0.4)  # by launch, not by overlap


def test_a_span_that_launched_nothing_is_counted_with_no_operations():
    out = spans.attribute([_span("femcy.post", 0.0, 1.0),
                           _launch(2.0, 1), _op(2.1, 2.2, 1)], G)
    assert out == {"femcy.post": spans.SpanTotals(1, 1.0, 0, 0.0)}
    assert spans.attribute([], G) == {}


def _summary(span_totals, analyses=4):
    """A traced stretch's summary that carries the spans' totals."""
    base = trace.TraceSummary(window_s=1.0, busy_s=0.5, analyses=analyses,
                              ops={}, idle_by_host={}, sections={})
    return types.SimpleNamespace(**vars(base), spans=span_totals)


def _reader(name):
    return named.module("metrics", name)


def test_the_readers():
    got = {"femcy.newton.tangent": spans.SpanTotals(10, 0.5, 70, 0.39),
           "femcy.dirichlet": spans.SpanTotals(50, 0.2, 150, 0.002),
           "femcy.pcg.iter": spans.SpanTotals(300, 1.0, 5700, 0.6)}
    run = types.SimpleNamespace(trace=_summary(got))
    assert _reader("newton_tangent_ms").read(run) == pytest.approx(39.0)
    assert _reader("dirichlet_ms").read(run) == pytest.approx(0.5)
    assert _reader("cg_launches_per_iter").read(run) == pytest.approx(19.0)


@pytest.mark.parametrize("name", ["newton_tangent_ms", "dirichlet_ms",
                                  "cg_launches_per_iter"])
def test_a_reader_finds_nothing_where_no_span_was_reduced(name):
    read = _reader(name).read
    assert read(types.SimpleNamespace(trace=None)) is None
    bare = trace.TraceSummary(window_s=1.0, busy_s=0.5, analyses=1, ops={},
                              idle_by_host={}, sections={})
    assert read(types.SimpleNamespace(trace=bare)) is None
    assert read(types.SimpleNamespace(trace=_summary({}))) is None


def test_the_spans_of_a_real_cpu_profile():
    """A small ELL Jacobi solve of the program under a CPU profile: its
    spans are found and counted (no device, so no operations)."""
    import femcy_tpu_torch as T
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    mesh = unstructured_box_tets(3)
    z = mesh.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 2, 0.01))
    inp = InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=False,
        time_incs=dict(ini_inc=1.0, max_time=1.0, min_inc=1e-5, max_inc=1.0))
    system = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3), False,
                         T.SolverConfig(linear_solver="cg"), device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert system.solve(inp).success
    out = spans.attribute(prof.profiler.kineto_results.events(),
                          torch.autograd.DeviceType.CUDA)
    assert out["femcy.pcg.iter"].count == system._last_cg_iters > 0
    assert out["femcy.solve"].count == out["femcy.dirichlet"].count == 1
    assert all(t.ops == 0 and t.host_s > 0 for t in out.values())
