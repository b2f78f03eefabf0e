"""The port's host layer against femcy_tpu's: element tables, mesh
generators, the structured DIA pattern and plan, SolverConfig, the .inp
reader, Neumann patterns, the direct solve and the Timer.

These are numpy copies, so every comparison is exact (equal arrays), except
the direct solve: the same SuperLU call on the same matrix, compared at
1e-12 relative to allow for library-internal ordering.
"""

import dataclasses

import numpy as np
import pytest

import femcy_tpu.config as jcfg
import femcy_tpu.elements as jel
import femcy_tpu.meshgen as jmg
from femcy_tpu.bc import build_neumann_patterns as j_neumann
from femcy_tpu.io.inp import NeumannBC as JNeumannBC, read_inp as j_read_inp
from femcy_tpu.materials import LinearIsotropic as JLinearIsotropic
from femcy_tpu.solvers.dia import build_structured_dia_pattern as j_pattern
from femcy_tpu.solvers.direct import direct_solve as j_direct
from femcy_tpu.structured import build_structured_plan as j_plan

import femcy_tpu_torch.config as tcfg
import femcy_tpu_torch.elements as tel
import femcy_tpu_torch.meshgen as tmg
from femcy_tpu_torch import convert
from femcy_tpu_torch.bc import build_neumann_patterns as t_neumann
from femcy_tpu_torch.io.inp import NeumannBC as TNeumannBC, read_inp as t_read_inp
from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern as t_pattern
from femcy_tpu_torch.solvers.direct import direct_solve as t_direct
from femcy_tpu_torch.structured import build_structured_plan as t_plan
from femcy_tpu_torch.utils.timing import Timer

BOXES = [(3, 4, 2), (4, 3, 5, 2.0, 1.5, 1.0)]


def _same(a, b):
    """Exact structural equality of nested tables (dicts, tuples, arrays)."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, float, int)) or a is None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(jel.ELEMENT_REGISTRY))
def test_element_tables_match(name):
    je, te = jel.get_element(name), tel.get_element(name)
    for f in dataclasses.fields(je):
        if f.name in ("shape_fn", "dshape_fn"):
            continue
        _same(getattr(je, f.name), getattr(te, f.name))
    np.testing.assert_array_equal(je.shape_at_gp, te.shape_at_gp)
    np.testing.assert_array_equal(je.dshape_at_gp, te.dshape_at_gp)
    # every facet's quadrature on the same randomly placed element: the
    # copies run the same numpy code, so the results are equal bit for bit
    x = np.random.default_rng(0).uniform(size=(je.n_nodes, je.dm))
    for facet in je.facet_natural_coos:
        for a, b in zip(je.facet_quadrature(x, facet),
                        te.facet_quadrature(x, facet)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", BOXES)
def test_box_tets_matches(dims):
    jm, tm = jmg.box_tets(*dims), tmg.box_tets(*dims)
    np.testing.assert_array_equal(jm.nodes, tm.nodes)
    np.testing.assert_array_equal(jm.elements, tm.elements)
    assert jm.element.name == tm.element.name
    _same(jm.structure, tm.structure)


@pytest.mark.parametrize(
    "gen, args",
    [
        ("rect_quads", (3, 2)),
        ("rect_tris", (3, 2)),
        ("box_hexes", (2, 2, 3)),
        ("box_hexes20", (2, 1, 2)),
        ("box_wedges", (2, 2, 1)),
        ("unstructured_box_tets", (3,)),
        ("graded_box_tets", (3,)),
    ],
)
def test_other_generators_match(gen, args):
    jm, tm = getattr(jmg, gen)(*args), getattr(tmg, gen)(*args)
    np.testing.assert_array_equal(jm.nodes, tm.nodes)
    np.testing.assert_array_equal(jm.elements, tm.elements)
    assert jm.element.name == tm.element.name


@pytest.mark.parametrize("dims", BOXES)
def test_dia_pattern_and_plan_match(dims):
    jm, tm = jmg.box_tets(*dims), tmg.box_tets(*dims)
    jd, td = j_pattern(jm), t_pattern(tm)
    assert jd.n_dof == td.n_dof
    assert jd.offsets == td.offsets
    assert jd.diag_idx == td.diag_idx
    assert (jd.pad_lo, jd.pad_hi) == (td.pad_lo, td.pad_hi)
    jp, tp = j_plan(jm, jd), t_plan(tm, td)
    assert (jp.nx, jp.ny, jp.nz, jp.n_offsets) == (tp.nx, tp.ny, tp.nz, tp.n_offsets)
    assert list(jp.groups.items()) == list(tp.groups.items())
    assert sum(len(v) for v in tp.groups.values()) == 864


def test_mesh_boundary_matches():
    jm, tm = jmg.box_tets(2, 3, 2), tmg.box_tets(2, 3, 2)
    assert jm.boundary == tm.boundary
    np.testing.assert_array_equal(jm.boundary_nodes, tm.boundary_nodes)


def test_solver_config_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SolverConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SolverConfig)]
    assert jf == tf
    assert dataclasses.asdict(jcfg.SolverConfig()) == dataclasses.asdict(
        tcfg.SolverConfig()
    )


@pytest.mark.parametrize(
    "kw",
    [
        {"sharding": "banded"},
    ],
)
def test_solver_config_later_values_raise(kw):
    """The values the port once refused until a later slice (banded
    sharding the last of them) build as in femcy_tpu."""
    assert dataclasses.asdict(tcfg.SolverConfig(**kw)) == dataclasses.asdict(
        jcfg.SolverConfig(**kw))


@pytest.mark.parametrize(
    "kw",
    [
        {"sharding": "slab"},
        {"dynamic_rescue": True},
        {"sharding": "slab", "sharding_devices": 4, "dynamic_rescue": True},
        {"sharding": "banded", "sharding_devices": 4, "dynamic_rescue": True,
         "tangent": "consistent"},
    ],
)
def test_solver_config_rescue_and_slab_values_accepted(kw):
    """The implicit-dynamics rescue and the slab and banded sharding are
    ported: these build in both packages."""
    assert dataclasses.asdict(tcfg.SolverConfig(**kw)) == dataclasses.asdict(
        jcfg.SolverConfig(**kw))


@pytest.mark.parametrize(
    "kw",
    [
        {"dense_operator_max_dof": 10},
        {"mixed_precision_refine": True},
        {"fused_newton": True},
        {"device_loop": True},
        {"dense_operator_max_dof": 10, "mixed_precision_refine": True,
         "fused_newton": True, "device_loop": True},
    ],
)
def test_solver_config_slice_g_values_accepted(kw):
    """The dense CG, the refinement, the fused step and the device loop
    are ported: these build in both packages."""
    assert dataclasses.asdict(tcfg.SolverConfig(**kw)) == dataclasses.asdict(
        jcfg.SolverConfig(**kw))


@pytest.mark.parametrize(
    "kw",
    [
        {"sparse_format": "ell", "preconditioner": "amg"},
        {"preconditioner": "amg"},
    ],
)
def test_solver_config_amg_values_accepted(kw):
    """The algebraic multigrid is ported: these build in both packages."""
    assert dataclasses.asdict(tcfg.SolverConfig(**kw)) == dataclasses.asdict(
        jcfg.SolverConfig(**kw))


def test_solver_config_rejects_unknown_choice():
    with pytest.raises(ValueError):
        tcfg.SolverConfig(linear_solver="lu")


INP = """*Heading
parity model
*Node
1, 0., 0., 0.
2, 1., 0., 0.
3, 0., 1., 0.
4, 0., 0., 1.
5, 1., 1., 1.
*Element, type=C3D4
1, 1, 2, 3, 4
2, 2, 3, 4, 5
*Nset, nset=base, instance=a
1, 2, 3
*Nset, nset=gen, instance=a, generate
1, 5, 2
*Elset, elset=_s, internal, instance=a
1, 2
*Surface, type=ELEMENT, name=load
_s, S2
*Material, name=m
*Elastic
210000., 0.3
*Step, name=s, nlgeom=NO
*Static
0.25, 1., 1e-05, 0.5
*Boundary
base, 1, 1
base, 2, 2, 0.
gen, 3, 3, 0.125
*Dsload
load, P, -5.
load, TRVEC, 2., 0., 0., 1.
*End Step
"""


def test_read_inp_matches(tmp_path):
    p = tmp_path / "m.inp"
    p.write_text(INP)
    jm, tm = j_read_inp(str(p)), t_read_inp(str(p))
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if f.name in ("dirichlet_bcs", "neumann_bcs"):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _same(dataclasses.asdict(x), dataclasses.asdict(y))
        else:
            _same(a, b)
    assert len(tm.neumann_bcs) == 2 and tm.neumann_bcs[1].direction is not None
    # convert carries the reference's model over field by field
    cm = convert.inp_from(jm)
    for f in dataclasses.fields(cm):
        if f.name not in ("dirichlet_bcs", "neumann_bcs"):
            _same(getattr(cm, f.name), getattr(tm, f.name))


def test_neumann_patterns_match():
    jm, tm = jmg.box_tets(2, 2, 3), tmg.box_tets(2, 2, 3)
    top = sorted(f for f in jm.boundary if all(jm.nodes[n, 2] > 1 - 1e-9 for n in f))
    side = sorted(f for f in jm.boundary if all(jm.nodes[n, 0] < 1e-9 for n in f))
    d = np.array([0.0, 1.0, 0.5])
    jb = [JNeumannBC(top, 3.0), JNeumannBC(side, 2.0, d)]
    tb = [TNeumannBC(top, 3.0), TNeumannBC(side, 2.0, d.copy())]
    jp, jt = j_neumann(jm, jb)
    tp, tt = t_neumann(tm, tb)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(jt, tt)
    assert np.abs(tp).sum() > 0


def test_direct_solve_matches():
    """SuperLU on the same operator: 1e-12 relative (same library call,
    f64)."""
    from femcy_tpu.structured import (
        analytic_structured_dia_values as j_values,
        dia_dirichlet_linear_numpy as j_bc,
    )
    from femcy_tpu_torch.structured import (
        analytic_structured_dia_values as t_values,
        dia_dirichlet_linear_numpy as t_bc,
    )

    jm, tm = jmg.box_tets(3, 2, 2), tmg.box_tets(3, 2, 2)
    jd, td = j_pattern(jm), t_pattern(tm)
    C = convert.material_from(JLinearIsotropic(1000.0, 0.3)).C
    jv, tv = j_values(jm, C, jd), t_values(tm, C, td)
    np.testing.assert_array_equal(jv, tv)
    fixed = jm.nodes[:, 0].repeat(3) < 1e-9
    jv = j_bc(jv, jd.offsets, jd.diag_idx, fixed)
    tv = t_bc(tv, td.offsets, td.diag_idx, fixed)
    np.testing.assert_array_equal(jv, tv)
    b = np.where(fixed, 0.0, np.random.default_rng(3).standard_normal(jm.n_dof))
    xj, xt = j_direct(jd, jv, b), t_direct(td, tv, b)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    np.testing.assert_array_equal(jd.to_scipy(jv).toarray(),
                                  td.to_scipy(tv).toarray())


def test_timer_records_sections_and_sync():
    calls = []
    timer = Timer(sync=lambda: calls.append(1))
    for _ in range(3):
        with timer.section("a"):
            pass
    s = timer.summary()["a"]
    assert s["count"] == 3 and s["first"] is not None and s["steady_min"] >= 0
    assert [r.first_call for r in timer.records] == [True, False, False]
    assert len(calls) == 6  # before and after each section
