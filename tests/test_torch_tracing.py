"""The port's spans (``femcy_tpu_torch.utils.timing.span``): nothing with
no profile active; under a ``torch.profiler`` profile the listed ranges,
properly nested, one PCG iteration span per CG iteration and one set of
Newton step spans per evaluation, with the results unchanged."""

import collections

import numpy as np
import pytest
import torch

import femcy_tpu_torch as T
from femcy_tpu_torch.io.inp import DirichletBC, InpModel
from femcy_tpu_torch.meshgen import box_tets, unstructured_box_tets
from femcy_tpu_torch.user import make_rotation_dirichlet
from femcy_tpu_torch.utils import timing

NEWTON_STEPS = ("femcy.newton.kinematics", "femcy.newton.stress",
                "femcy.newton.force", "femcy.newton.tangent",
                "femcy.newton.scatter")
S = timing.SECTION
#: span -> the spans it may lie directly inside (None: none)
PARENTS = {
    "femcy.solve": {None},
    "femcy.boundary": {"femcy.solve"},
    S + "assemble+bc": {"femcy.solve"},
    "femcy.assemble": {S + "assemble+bc"},
    "femcy.assemble.ke": {"femcy.assemble"},
    "femcy.assemble.scatter": {"femcy.assemble"},
    "femcy.dirichlet": {S + "assemble+bc", S + "newton_eval"},
    S + "linear_solve": {"femcy.solve"},
    "femcy.pcg": {S + "linear_solve"},
    "femcy.pcg.iter": {"femcy.pcg"},
    "femcy.pcg.precond": {"femcy.pcg", "femcy.pcg.iter"},
    S + "newton_eval": {"femcy.solve"},
    **{name: {S + "newton_eval"} for name in NEWTON_STEPS},
    "femcy.post": {None},
}
LINEAR = {"femcy.solve", "femcy.boundary", S + "assemble+bc",
          "femcy.assemble", "femcy.assemble.ke", "femcy.assemble.scatter",
          "femcy.dirichlet", S + "linear_solve", "femcy.pcg",
          "femcy.pcg.iter", "femcy.pcg.precond", "femcy.post"}
NEWTON = (LINEAR - {S + "assemble+bc", "femcy.assemble", "femcy.assemble.ke",
                    "femcy.assemble.scatter"}
          | {S + "newton_eval", *NEWTON_STEPS})


def _model(mesh, nonlinear):
    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    if nonlinear:  # the top face turned by the default user hook
        bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
        incs = dict(ini_inc=0.004, max_time=0.008, min_inc=1e-5,
                    max_inc=0.004)
    else:
        bcs += [DirichletBC(top, 0, 0.01), DirichletBC(top, 1, -0.005)]
        incs = dict(ini_inc=1.0, max_time=1.0, min_inc=1e-5, max_inc=1.0)
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=nonlinear,
        time_incs=incs)


CASES = {
    "ell_jacobi": (lambda: unstructured_box_tets(4), False,
                   dict(linear_solver="cg")),
    "ell_amg": (lambda: unstructured_box_tets(4), False,
                dict(linear_solver="cg", preconditioner="amg")),
    "box_twist": (lambda: box_tets(4, 4, 4), True,
                  dict(linear_solver="cg", preconditioner="multigrid")),
    # the box without Kg: P3's route, whose tangent is made inside the
    # scatter, so "femcy.newton.tangent" does not run
    "box_twist_no_kg": (lambda: box_tets(4, 4, 4), True,
                        dict(linear_solver="cg", preconditioner="multigrid",
                             geometric_stiffness=False)),
}


def _expected(case):
    """The span names an analysis of ``case`` emits."""
    _, nonlinear, cfg = CASES[case]
    if not nonlinear:
        return LINEAR
    if cfg.get("geometric_stiffness", True):
        return NEWTON
    return NEWTON - {"femcy.newton.tangent"}


def _run(case):
    """(system, the model, its user hook) of ``case``, warmed by one
    analysis."""
    make_mesh, nonlinear, cfg = CASES[case]
    mesh = make_mesh()
    system = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3), nonlinear,
                         T.SolverConfig(**cfg), device="cpu")
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0)) if nonlinear else None
    inp = _model(mesh, nonlinear)
    assert system.solve(inp, hook).success
    return system, inp, hook


def _profiled(fn):
    """(fn's result, the program's spans as (start, end, name))."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("femcy.")]
    return out, sorted(spans, key=lambda s: (s[0], -s[1]))


def _parents(spans):
    """The innermost span around each span (None at the top), checking
    that every two spans are disjoint or one holds the other."""
    out, stack = [], []
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            assert t <= stack[-1][1], f"{name} crosses {stack[-1][2]}"
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, t, name))
    return out


def test_no_profile_gives_the_shared_no_op():
    assert timing.span("femcy.x") is timing.NO_SPAN
    with timing.span("femcy.x") as got:
        assert got is None


def test_a_profile_switches_the_spans_on():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert timing.span("femcy.x") is not timing.NO_SPAN
    assert timing.span("femcy.x") is timing.NO_SPAN


def test_a_timer_section_is_a_range_and_keeps_its_record():
    calls = []
    timer = T.utils.Timer(sync=lambda: calls.append("sync"))
    (_, spans) = _profiled(lambda: _section(timer, calls))
    assert [n for _, _, n in spans] == [S + "work", "femcy.inner"]
    assert calls == ["sync", "work", "sync"]
    assert [r.name for r in timer.records] == ["work"]
    assert timer.summary()["work"]["count"] == 1
    _section(timer, calls)  # and with no profile, as before
    assert len(timer.records) == 2 and calls[-1] == "sync"


def _section(timer, calls):
    with timer.section("work"):
        with timing.span("femcy.inner"):
            calls.append("work")


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_analysis_emits_its_spans_properly_nested(case):
    system, inp, hook = _run(case)
    n_cg, n_rec = len(system._cg_iters_log), len(system.timer.records)
    _, spans = _profiled(lambda: (system.solve(inp, hook),
                                  system.compute_strain_stress()))
    names = collections.Counter(n for _, _, n in spans)
    assert set(names) == _expected(case)
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)
    assert names["femcy.solve"] == names["femcy.post"] == 1
    assert names["femcy.pcg.iter"] == sum(system._cg_iters_log[n_cg:]) > 0
    assert names["femcy.pcg"] == len(system._cg_iters_log) - n_cg
    assert (names["femcy.pcg.precond"]
            == names["femcy.pcg.iter"] + names["femcy.pcg"])
    evals = sum(r.name == "newton_eval" for r in system.timer.records[n_rec:])
    assert all(names[step] == evals
               for step in _expected(case) & set(NEWTON_STEPS))
    assert names[S + "newton_eval"] == evals


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_profile_leaves_the_displacements_bit_identical(case):
    system, inp, hook = _run(case)
    assert system.solve(inp, hook).success
    plain = system.dof.clone()
    report, _ = _profiled(lambda: system.solve(inp, hook))
    assert report.success
    assert torch.equal(system.dof, plain)


def test_wall_time_is_read_on_the_monotonic_clock(monkeypatch):
    import time as time_mod

    system, inp, hook = _run("ell_jacobi")
    monkeypatch.setattr(time_mod, "time", lambda: 0.0)
    report = system.solve(inp, hook)
    assert 0.0 < report.wall_time < 60.0
