"""The port's geometric multigrid against femcy_tpu's, on the CPU.

The model: box_tets(8, 8, 8) in float64 with the z=0 face clamped.  The
hierarchy tests take coarsest_max_dof=100 so the cycle has three levels
(8^3 -> 4^3 -> 2^3): two smoothed levels and the dense coarsest solve.

Tolerances (float64): the level operators and masks are the same host
numpy arrays, compared equal; prolong/restrict and one V-cycle do the same
arithmetic, held to 1e-12 relative to the largest entry; the PCG takes the
same number of iterations and its x agrees to 1e-10 (roundoff of the
same iteration, summed in another order); FEMSystem likewise, with Mises
to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu.io.inp import DirichletBC, InpModel
from femcy_tpu.solvers import multigrid as jmg
from femcy_tpu.solvers.dia import build_structured_dia_pattern as j_pattern
from femcy_tpu.structured import (
    analytic_structured_dia_values as j_analytic,
    dia_dirichlet_linear_numpy as j_bc,
)

import femcy_tpu_torch as T
from femcy_tpu_torch import convert
from femcy_tpu_torch.solvers import multigrid as tmg

DIMS = (8, 8, 8)
LEVELS = dict(coarsest_max_dof=100)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _problem(dims=DIMS):
    jm = F.meshgen.box_tets(*dims)
    mat = F.LinearIsotropic(1000.0, 0.3)
    fixed = np.zeros(jm.n_dof, bool)
    bottom = np.nonzero(jm.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    dia = j_pattern(jm)
    values = j_bc(j_analytic(jm, mat.C, dia), dia.offsets, dia.diag_idx, fixed)
    b = np.where(fixed, 0.0,
                 np.random.default_rng(0).standard_normal(jm.n_dof))
    return jm, mat, fixed, dia, values, b


def _pair(smoother="jacobi", **kw):
    jm, mat, fixed, dia, values, b = _problem()
    j = jmg.StructuredMultigrid(jm, mat, fixed, dia=dia, smoother=smoother,
                                **LEVELS, **kw)
    t = tmg.StructuredMultigrid(convert.mesh_from(jm),
                                convert.material_from(mat), fixed,
                                smoother=smoother, **LEVELS, **kw)
    return j, t, values, b


@pytest.mark.parametrize("gc", [(4, 4, 4), (4, 2, 6)])
def test_prolong_restrict_transposes_and_match_jax(gc):
    rng = np.random.default_rng(1)
    gf = tuple(2 * d for d in gc)
    u = rng.standard_normal(3 * int(np.prod([d + 1 for d in gc])))
    v = rng.standard_normal(3 * int(np.prod([d + 1 for d in gf])))
    pu = tmg.prolong(torch.from_numpy(u), gc)
    rv = tmg.restrict(torch.from_numpy(v), gf)
    # <P u, v> == <u, R v>: R = P^T
    np.testing.assert_allclose(float(pu @ torch.from_numpy(v)),
                               float(torch.from_numpy(u) @ rv), rtol=1e-12)
    assert _rel(pu, jmg.prolong(jnp.asarray(u), gc)) < 1e-12
    assert _rel(rv, jmg.restrict(jnp.asarray(v), gf)) < 1e-12


@pytest.mark.parametrize(
    "grid, kw",
    [
        ((56, 56, 56), {}),
        ((8, 8, 8), {}),
        ((8, 8, 8), {"coarsest_max_dof": 100}),
        ((16, 8, 32), {"coarsest_max_dof": 400}),
        ((32, 32, 32), {"n_levels": 2, "coarsest_max_dof": 100}),
        ((7, 7, 7), {"coarsest_max_dof": 100}),
        ((17, 17, 17), {}),
    ],
)
def test_coarsen_grids_matches_jax(grid, kw):
    try:
        ref = jmg.coarsen_grids(grid, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="factors of 2") as got:
            tmg.coarsen_grids(grid, **kw)
        assert str(got.value) == str(e)
        return
    assert tmg.coarsen_grids(grid, **kw) == ref
    if grid == (56, 56, 56):
        assert ref == [(56,) * 3, (28,) * 3, (14,) * 3, (7,) * 3]


def test_level_operators_match_jax():
    j, t, _, _ = _pair()
    assert [lv.grid for lv in t.levels] == [lv.grid for lv in j.levels]
    assert len(t.levels) == 3
    for jl, tl in zip(j.levels, t.levels):
        assert (jl.dia.n_dof, jl.dia.offsets, jl.dia.diag_idx) == (
            tl.dia.n_dof, tl.dia.offsets, tl.dia.diag_idx)
        np.testing.assert_array_equal(tl.fixed.numpy(), np.asarray(jl.fixed))
    for jl, tl in zip(j.levels[1:], t.levels[1:]):
        np.testing.assert_array_equal(tl.values.numpy(), np.asarray(jl.values))
        np.testing.assert_array_equal(tl.inv_diag.numpy(),
                                      np.asarray(jl.inv_diag))
    np.testing.assert_array_equal(t._coarse_inv.numpy(),
                                  np.asarray(j._coarse_inv))
    # coarse_spmv="auto": a DIA SpMV kernel plan on the smoothed coarse
    # levels, none on the dense coarsest one
    assert t.levels[0].spmv_plan is None and t.levels[2].spmv_plan is None
    assert t.levels[1].spmv_plan is not None
    assert torch.equal(t.levels[1].values_t, t.levels[1].values.t())


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_matches_jax(smoother):
    j, t, values, b = _pair(smoother)
    if smoother == "chebyshev":
        assert t._lmax == j._lmax and len(t._lmax) == 3
    ref = j.precondition(jnp.asarray(values), jnp.asarray(b))
    out = t.precondition(torch.from_numpy(values), torch.from_numpy(b))
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_pcg_matches_jax(smoother):
    j, t, values, b = _pair(smoother)
    xj, kj, _ = j.pcg_solve(jnp.asarray(values), jnp.asarray(b), eps=1e-10)
    xt, kt, rt = t.pcg_solve(torch.from_numpy(values), torch.from_numpy(b),
                             eps=1e-10)
    assert kt == int(kj) > 1
    assert _rel(xt, xj) < 1e-10
    assert float(rt) < 1e-10 * np.abs(b).max()


def test_coarse_spmv_choices():
    """"slices" applies the coarse levels with the plain SpMV; on the CPU
    the kernel wrapper of "auto"/"pallas" runs the same plain version, so
    the iterates are equal."""
    jm, _, fixed, _, values, b = _problem()
    out = {}
    for mode in ("auto", "pallas", "slices"):
        mg = tmg.StructuredMultigrid(
            convert.mesh_from(jm), T.LinearIsotropic(1000.0, 0.3), fixed,
            coarse_spmv=mode, **LEVELS)
        assert (mg.levels[1].spmv_plan is None) == (mode == "slices")
        out[mode] = mg.pcg_solve(torch.from_numpy(values),
                                 torch.from_numpy(b), eps=1e-8)
    for mode in ("pallas", "slices"):
        assert out[mode][1] == out["auto"][1]
        assert torch.equal(out[mode][0], out["auto"][0])
    with pytest.raises(ValueError, match="coarse_spmv"):
        tmg.StructuredMultigrid(convert.mesh_from(jm),
                                T.LinearIsotropic(1000.0, 0.3), fixed,
                                coarse_spmv="interpret")


def _model(mesh):
    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, 0.01))
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={"bottom": bottom, "top": top}, ele_sets={}, face_sets={},
        dirichlet_bcs=bcs, neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=False,
        time_incs={"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                   "max_inc": 1.0},
    )


@pytest.mark.parametrize("dims, n_levels", [(DIMS, 1), ((16, 16, 16), 2)])
def test_system_multigrid_matches_jax(dims, n_levels):
    """FEMSystem(preconditioner="multigrid", linear_solver="cg") in both
    packages: the same iteration count, dof and Mises to 1e-10.  At 8^3
    the default coarsest_max_dof leaves one level (the cycle is the dense
    solve); 16^3 has two."""
    jm = F.meshgen.box_tets(*dims)
    inp = _model(jm)
    mat = F.LinearIsotropic(1000.0, 0.3)
    cfg = dict(preconditioner="multigrid", linear_solver="cg")
    js = F.FEMSystem(jm, mat, False, F.SolverConfig(**cfg))
    assert js.solve(inp).success
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat), False,
                     T.SolverConfig(**cfg), device="cpu")
    assert ts.solve(convert.inp_from(inp)).success
    assert len(ts._mg.levels) == len(js._mg.levels) == n_levels
    assert ts._last_cg_iters == js._last_cg_iters > 0
    assert _rel(ts.dof, js.dof) < 1e-10
    assert _rel(ts.compute_strain_stress()[2],
                js.compute_strain_stress()[2]) < 1e-10
    assert abs(ts.elastic_energy() - js.elastic_energy()) < (
        1e-10 * js.elastic_energy())


def test_system_multigrid_hierarchy_keyed_on_mask():
    mesh = T.meshgen.box_tets(*DIMS)
    s = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3),
                    config=T.SolverConfig(preconditioner="multigrid",
                                          linear_solver="cg"))
    inp = convert.inp_from(_model(F.meshgen.box_tets(*DIMS)))
    s.solve(inp)
    mg = s._mg
    assert mg is not None
    s.solve(inp)  # a new mask tensor with the same values: no rebuild
    assert s._mg is mg
    fixed = s._last_dirichlet[0].clone()
    fixed[0] = ~fixed[0]
    s._ensure_multigrid(fixed)
    assert s._mg is not mg


def test_multigrid_rejects_odd_grid():
    mesh = T.meshgen.box_tets(7, 7, 7)
    with pytest.raises(ValueError):
        tmg.StructuredMultigrid(mesh, T.LinearIsotropic(1000.0, 0.3),
                                np.zeros(mesh.n_dof, bool),
                                coarsest_max_dof=100)


def test_system_multigrid_fails_fast_on_uncoarsenable_grid():
    with pytest.raises(ValueError, match="factors of 2"):
        T.FEMSystem(T.meshgen.box_tets(17, 17, 17),
                    T.LinearIsotropic(1000.0, 0.3),
                    config=T.SolverConfig(preconditioner="multigrid"))


def test_system_multigrid_requires_structured_mesh():
    mesh, _, _ = T.meshgen.cantilever_tets(4, 2)
    mesh = T.FEMesh(mesh.nodes, mesh.elements, mesh.element)  # no structure
    with pytest.raises(ValueError, match="multigrid"):
        T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3),
                    config=T.SolverConfig(preconditioner="multigrid"))
    with pytest.raises(ValueError, match="box_tets"):
        tmg.StructuredMultigrid(mesh, T.LinearIsotropic(1000.0, 0.3),
                                np.zeros(mesh.n_dof, bool))
