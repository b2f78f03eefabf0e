"""The Newton path (geometric nonlinearity) of femcy_tpu_torch against
femcy_tpu's, on the CPU, in float64.

System cases: the same model through both packages' ``FEMSystem.solve``
with ``geometric_nonlinear=True`` -- a large-deformation cantilever under a
*Dsload on the box layout and on ELL, a twist of a box by the default
``*Boundary, user`` rotation hook, a bent hex bar on the general-DIA
layout, a neo-Hookean block, the consistent tangent, a forced cutback, the
extrapolation predictor, the global residual reference across a
checkpoint, the on_newton hook, and the failure diagnosis.  Linear solves
are direct: CG parity is roundoff-limited (ROADMAP.md section 3).

Tolerances: the increment/Newton history (increments, times, dt, Newton
loops, convergence flags) is equal; residuals, dof, stress and energy
agree within 1e-8 relative (to the largest residual of the history, max
|dof|, max |stress|, the energy): the same arithmetic summed in another
order, roundoff amplified by the Newton solves.

Unit cases: the internal force, geometric stiffness, consistent tangent,
box force and stiffness scatters, both Newton Dirichlet treatments, the
rotation hook and the f64 host residual against their JAX twins (1e-12
relative, or exactly where both sum in the same order); numpy
restatements of the M4 and M5 kernels' walks held bit for bit to their
plain versions in float32 and float64; the multigrid V-cycle in the Newton
tangent solves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu import assembly as jasm
from femcy_tpu import assembly_host as jhost
from femcy_tpu import bc as jbc
from femcy_tpu import structured as jstr
from femcy_tpu import user as juser
from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC
from femcy_tpu.solvers import dia as jdia
from femcy_tpu.topology import build_pattern as j_build_pattern

import femcy_tpu_torch as T
from femcy_tpu_torch import assembly as tasm
from femcy_tpu_torch import assembly_host as thost
from femcy_tpu_torch import bc as tbc
from femcy_tpu_torch import convert
from femcy_tpu_torch import structured as tstr
from femcy_tpu_torch import user as tuser
from femcy_tpu_torch.kernels import ell_scatter as kscat
from femcy_tpu_torch.kernels import internal_force as kforce
from femcy_tpu_torch.kernels import structured_force as ksforce
from femcy_tpu_torch.solvers import dia as tdia
from femcy_tpu_torch.topology import build_pattern

TOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# --------------------------------------------------------------------------- #
# models
# --------------------------------------------------------------------------- #
def _inp(mesh, dirichlet, neumann=(), material=("Elastic", [1000.0, 0.3]),
         ini_inc=0.5, max_time=1.0, max_inc=None, min_inc=1e-4):
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=list(dirichlet),
        neumann_bcs=list(neumann), material_type=material[0],
        material_params=list(material[1]), geometric_nonlinear=True,
        time_incs=dict(ini_inc=ini_inc, max_time=max_time, min_inc=min_inc,
                       max_inc=ini_inc if max_inc is None else max_inc),
    )


def _cantilever(traction=2.0, **kw):
    """cantilever_tets(6, 2): x=0 clamped, a *Dsload traction along z on
    the x=10 end face (1.66 tip deflection on a 10 x 1 x 1 bar)."""
    jm, fixed, loaded = F.meshgen.cantilever_tets(6, 2)
    lset = set(loaded.tolist())
    faces = [f for f in jm.boundary if all(n in lset for n in f)]
    bcs = [DirichletBC(fixed, d, 0.0) for d in range(3)]
    load = [NeumannBC(face_set=faces, traction=traction,
                      direction=np.array([0.0, 0.0, 1.0]))]
    return jm, _inp(jm, bcs, load, **kw)


def _twist_box(max_time=0.125, ini_inc=0.0625):
    """box_tets(4, 3, 3) about the default hook's axis (40, 5): z=0
    clamped, the z=1 face driven by ``*Boundary, user`` on all three dofs,
    a rotation by time * pi (22.5 degrees at the end)."""
    base = F.meshgen.box_tets(4, 3, 3)
    jm = F.FEMesh(base.nodes + np.array([39.5, 4.5, 0.0]), base.elements,
                  base.element, structure=base.structure)
    z = jm.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > 1 - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
    return jm, _inp(jm, bcs, ini_inc=ini_inc, max_time=max_time)


def _bent_hexes():
    """box_hexes(4, 2, 2) as a 4 x 1 x 1 bar: x=0 clamped, the x=4 face
    pushed 1.2 along z (large rotation of the end)."""
    jm = F.meshgen.box_hexes(4, 2, 2, 4.0, 1.0, 1.0)
    x = jm.nodes[:, 0]
    left, right = np.nonzero(x < 1e-9)[0], np.nonzero(x > 4 - 1e-9)[0]
    bcs = [DirichletBC(left, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(right, 2, 1.2))
    return jm, _inp(jm, bcs, ini_inc=0.25)


def _neo_block():
    """unstructured_box_tets(3) of a neo-Hookean solid: z=0 clamped, the
    top face sheared 0.3 along x and compressed 0.15."""
    jm = F.meshgen.unstructured_box_tets(3)
    z = jm.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, 0, 0.3), DirichletBC(top, 2, -0.15)]
    # *Hyperelastic, neo hooke: C1 = 100, D1 = 1 / 0.02 = 50
    return jm, _inp(jm, bcs, material=("Hyperelastic, neo hooke", [100.0, 0.02]),
                    ini_inc=0.5)


def _systems(jm, mat, cfg):
    js = F.FEMSystem(jm, mat, True, F.SolverConfig(**cfg))
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat), True,
                     T.SolverConfig(**cfg), device="cpu")
    return js, ts


def _same_history(tr, jr):
    """Equal increments, times, dt, Newton loops and flags; residuals
    within TOL of the history's largest."""
    assert tr.success == jr.success and tr.message == jr.message
    assert len(tr.increments) == len(jr.increments)
    scale = max(abs(r.residual) for r in jr.increments) or 1.0
    for t, j in zip(tr.increments, jr.increments):
        assert (t.kinc, t.time, t.dt, t.newton_iters, t.converged) == (
            j.kinc, j.time, j.dt, j.newton_iters, j.converged)
        assert abs(t.residual - j.residual) <= TOL * scale


def _same_state(ts, js):
    assert _rel(ts.dof, js.dof) < TOL
    t_out, j_out = ts.compute_strain_stress(), js.compute_strain_stress()
    for t, j in zip(t_out, j_out):  # Green strain, Cauchy stress, Mises
        assert _rel(t, j) < TOL
    je = js.elastic_energy()
    assert abs(ts.elastic_energy() - je) <= TOL * abs(je)


def _solve_both(jm, mat, inp, cfg, **solve_kw):
    js, ts = _systems(jm, mat, cfg)
    jr = js.solve(inp, **solve_kw)
    tr = ts.solve(convert.inp_from(inp), **solve_kw)
    return js, jr, ts, tr


# --------------------------------------------------------------------------- #
# whole analyses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["box", "box-secant", "ell"])
def test_cantilever_matches_jax(layout):
    """On the box, the default tangent (secant + geometric stiffness, P2's
    path) and the reference's secant alone (assembled from the current
    configuration's gradients on the CPU, P3's path on the card)."""
    jm, inp = _cantilever()
    cfg = dict(linear_solver="direct")
    if layout == "ell":
        cfg["sparse_format"] = "ell"
    if layout == "box-secant":
        cfg["geometric_stiffness"] = False
    js, jr, ts, tr = _solve_both(jm, F.LinearIsotropic(1000.0, 0.3), inp, cfg)
    assert (ts._structured_plan is not None) == (layout != "ell")
    assert ts.dia is None if layout == "ell" else ts.dia is not None
    assert tr.success and tr.n_increments == 2
    assert min(r.newton_iters for r in tr.increments) > 3
    assert float(ts.dof.abs().max()) > 1.5  # a large deflection
    _same_history(tr, jr)
    _same_state(ts, js)


def test_twist_by_the_default_user_hook_matches_jax():
    """``*Boundary, user`` with no callable: both packages take their
    default rotation about (40, 5, 0)."""
    jm, inp = _twist_box()
    js, jr, ts, tr = _solve_both(jm, F.LinearIsotropic(1000.0, 0.3), inp,
                                 dict(linear_solver="direct"))
    assert tr.success and tr.n_increments == 2
    _same_history(tr, jr)
    _same_state(ts, js)
    # the top face turned by 22.5 degrees about the box axis
    top = np.nonzero(jm.nodes[:, 2] > 1 - 1e-9)[0]
    u = ts.dof.numpy().reshape(-1, 3)[top]
    rel = jm.nodes[top, :2] - np.array([40.0, 5.0])
    c, s = np.cos(0.125 * np.pi), np.sin(0.125 * np.pi)
    turned = np.stack([c * rel[:, 0] + s * rel[:, 1],
                       -s * rel[:, 0] + c * rel[:, 1]], 1)
    np.testing.assert_allclose(u[:, :2], turned - rel, atol=1e-12)


def test_bent_hexes_on_the_general_dia_layout_match_jax():
    jm, inp = _bent_hexes()
    js, jr, ts, tr = _solve_both(jm, F.LinearIsotropic(1000.0, 0.3), inp,
                                 dict(linear_solver="direct"))
    assert ts.dia is not None and ts._structured_plan is None
    assert tr.success
    _same_history(tr, jr)
    _same_state(ts, js)


def test_neo_hookean_matches_jax():
    jm, inp = _neo_block()
    mat = F.material_from_inp(inp.material_type, inp.material_params, "C3D4")
    assert type(mat).__name__ == "NeoHookean"
    js, jr, ts, tr = _solve_both(jm, mat, inp, dict(linear_solver="direct"))
    assert ts.dia is None and tr.success
    _same_history(tr, jr)
    _same_state(ts, js)


def test_consistent_tangent_analysis_matches_jax():
    jm, inp = _cantilever()
    js, jr, ts, tr = _solve_both(
        jm, F.LinearIsotropic(1000.0, 0.3), inp,
        dict(linear_solver="direct", tangent="consistent",
             sparse_format="ell", newton_boost_max=0))
    assert tr.success
    _same_history(tr, jr)
    _same_state(ts, js)


def test_forced_cutback_matches_jax():
    """Eight Newton iterations are too few for the whole load in one
    step: the increment is cut back, recorded unconverged, and the analysis
    completes in smaller steps."""
    jm, inp = _cantilever(ini_inc=1.0)
    js, jr, ts, tr = _solve_both(
        jm, F.LinearIsotropic(1000.0, 0.3), inp,
        dict(linear_solver="direct", sparse_format="ell", newton_max_iters=8))
    assert tr.success
    assert any(not r.converged for r in tr.increments)
    _same_history(tr, jr)
    _same_state(ts, js)


def test_extrapolate_predictor_matches_jax():
    jm, inp = _cantilever(ini_inc=0.25)
    js, jr, ts, tr = _solve_both(
        jm, F.LinearIsotropic(1000.0, 0.3), inp,
        dict(linear_solver="direct", sparse_format="ell",
             predictor="extrapolate"))
    assert tr.success and tr.n_increments >= 3
    _same_history(tr, jr)
    _same_state(ts, js)


def test_jacobian_reuse_matches_jax():
    """newton_jacobian_reuse="increment": one LU per increment on the
    direct path, refreshed on a stall."""
    jm, inp = _cantilever()
    js, jr, ts, tr = _solve_both(
        jm, F.LinearIsotropic(1000.0, 0.3), inp,
        dict(linear_solver="direct", sparse_format="ell",
             newton_jacobian_reuse="increment"))
    assert tr.success
    _same_history(tr, jr)
    _same_state(ts, js)


class _Stop(Exception):
    pass


def test_global_residual_reference_survives_a_checkpoint(tmp_path):
    """newton_residual_ref="global" measures every increment against the
    analysis's first residual; a run stopped after its first increment and
    resumed from the checkpoint finishes as the uninterrupted run does."""
    jm, inp = _cantilever(ini_inc=0.25)
    mat = F.LinearIsotropic(1000.0, 0.3)
    cfg = dict(linear_solver="direct", sparse_format="ell",
               newton_residual_ref="global")
    js, jr, ts, tr = _solve_both(jm, mat, inp, cfg)
    _same_history(tr, jr)
    _same_state(ts, js)
    assert ts._ini_residual == pytest.approx(js._ini_residual, rel=TOL)

    path = str(tmp_path / "ck")
    t_inp = convert.inp_from(inp)

    def stop(system, record):
        raise _Stop

    first = T.FEMSystem(ts.mesh, ts.material, True,
                        T.SolverConfig(checkpoint_path=path, **cfg),
                        device="cpu")
    with pytest.raises(_Stop):
        first.solve(t_inp, on_increment=stop)
    data = np.load(path + ".npz")
    assert float(data["ini_residual"]) == first._ini_residual
    resumed = T.FEMSystem(ts.mesh, ts.material, True, T.SolverConfig(**cfg),
                          device="cpu")
    assert resumed._ini_residual is None
    resumed.load_checkpoint(path)
    assert resumed._ini_residual == first._ini_residual
    rep = resumed.solve(t_inp, resume=True)
    # the same records, but for kinc, which a resumed solve counts from 0
    assert [dataclasses.astuple(r)[1:] for r in rep.increments] == [
        dataclasses.astuple(r)[1:] for r in tr.increments[1:]]
    assert torch.equal(resumed.dof, ts.dof)


def test_on_newton_hook_counts_match_jax():
    jm, inp = _cantilever()
    calls = {"jax": [], "torch": []}

    def hook(name):
        def on_newton(system, loop, residual):
            assert np.asarray(system.dof).shape == (jm.n_dof,)
            calls[name].append((loop, residual))
        return on_newton

    cfg = dict(linear_solver="direct", sparse_format="ell")
    js, ts = _systems(jm, F.LinearIsotropic(1000.0, 0.3), cfg)
    jr = js.solve(inp, on_newton=hook("jax"))
    tr = ts.solve(convert.inp_from(inp), on_newton=hook("torch"))
    _same_history(tr, jr)
    assert len(calls["torch"]) == len(calls["jax"]) > tr.n_increments
    assert len(calls["torch"]) == ts.timer.summary()["newton_eval"]["count"]
    assert [c[0] for c in calls["torch"]] == [c[0] for c in calls["jax"]]
    scale = max(c[1] for c in calls["jax"])
    for (_, t), (_, j) in zip(calls["torch"], calls["jax"]):
        assert abs(t - j) <= TOL * scale


def test_failure_diagnosis_matches_jax():
    """One Newton iteration allowed and a minimum dt of the whole step:
    the analysis aborts, and both packages diagnose the same state."""
    jm, inp = _cantilever(ini_inc=1.0, min_inc=0.5)
    js, jr, ts, tr = _solve_both(
        jm, F.LinearIsotropic(1000.0, 0.3), inp,
        dict(linear_solver="direct", sparse_format="ell", newton_max_iters=1))
    assert not tr.success and "lambda_min" in tr.message
    _same_history(tr, jr)
    assert ts.min_element_volume() == pytest.approx(
        js.min_element_volume(), rel=1e-12)
    lam_t, lam_j = ts.tangent_min_eigenvalue(), js.tangent_min_eigenvalue()
    assert lam_t == pytest.approx(lam_j, rel=1e-6)


def test_multigrid_in_newton_path():
    """The V-cycle (built from the small-strain operator) preconditions the
    Newton tangent solves too: the same converged state as the Jacobi CG
    (the twin of tests/test_multigrid.py's test of the same name)."""
    mesh = T.meshgen.box_tets(8, 8, 8)
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    top = np.nonzero(mesh.nodes[:, 2] > 1 - 1e-12)[0]
    rhs[top * 3] = 0.05

    def run(precond):
        system = T.FEMSystem(
            mesh, T.LinearIsotropic(1000.0, 0.3), geometric_nonlinear=True,
            config=T.SolverConfig(preconditioner=precond, linear_solver="cg",
                                  cg_eps=1e-8),
            device="cpu")
        ok, _, res = system._advance_inc(_t(rhs), torch.from_numpy(fixed),
                                         _t(np.zeros(mesh.n_dof)))
        assert ok, (precond, res)
        assert (system._mg is not None) == (precond == "multigrid")
        return system.dof.numpy(), system._cg_iters_log

    (x_mg, it_mg), (x_j, it_j) = run("multigrid"), run("jacobi")
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_mg / scale, x_j / scale, atol=1e-4)
    assert len(it_mg) > 1 and max(it_mg) < min(it_j)


# --------------------------------------------------------------------------- #
# static stabilization (config.stabilize_factor)
# --------------------------------------------------------------------------- #
def _same_stabilization(ts, tr, js, jr):
    """The dissipated energy and the last increment's coefficient C/dt
    (the calibrated C over equal times) within TOL, the lumped diagonal
    within 1e-12."""
    assert tr.stabilization_energy > 0.0
    assert abs(tr.stabilization_energy - jr.stabilization_energy) <= (
        TOL * jr.stabilization_energy)
    j_scale = float(js._arrs["stab_scale"])
    assert j_scale > 0.0
    assert abs(float(ts._stab_scale) - j_scale) <= TOL * j_scale
    assert _rel(ts._stab_diag, js._arrs["stab_diag"]) < 1e-12


_STAB_CASES = {
    # the box with the default tangent (secant + Kg through P2's path), the
    # box's secant alone (P3's path), ELL, ELL with the consistent tangent,
    # and the general DIA layout
    "box": (_cantilever, {}),
    "box-secant": (_cantilever, {"geometric_stiffness": False}),
    "ell": (_cantilever, {"sparse_format": "ell"}),
    "ell-consistent": (_cantilever, {"sparse_format": "ell",
                                     "tangent": "consistent",
                                     "newton_boost_max": 0}),
    "general-dia": (_bent_hexes, {}),
}


@pytest.mark.parametrize("case", list(_STAB_CASES))
def test_stabilization_matches_jax(case):
    """stabilize_factor > 0: the viscous force in the residual, its diagonal
    in every tangent route, C calibrated on the first increment and the
    energy dissipated in the later ones, as in femcy_tpu."""
    model, extra = _STAB_CASES[case]
    jm, inp = model(ini_inc=0.25) if model is _cantilever else model()
    cfg = dict(linear_solver="direct", stabilize_factor=2e-4, **extra)
    js, jr, ts, tr = _solve_both(jm, F.LinearIsotropic(1000.0, 0.3), inp, cfg)
    assert (ts.dia is None) == (case.startswith("ell"))
    assert (ts._structured_plan is not None) == case.startswith("box")
    assert tr.success and tr.n_increments >= 3
    _same_history(tr, jr)
    _same_state(ts, js)
    _same_stabilization(ts, tr, js, jr)


def test_stabilization_switched_off_restores_the_plain_analysis():
    """A second solve after ``config`` is replaced by one with
    stabilize_factor=0 drops the stabilization state (femcy_tpu's restore
    branch) and repeats a plain analysis exactly."""
    jm, inp = _cantilever(ini_inc=0.25)
    mat = F.LinearIsotropic(1000.0, 0.3)
    cfg = dict(linear_solver="direct", sparse_format="ell")
    js, jr, ts, tr = _solve_both(jm, mat, inp, dict(cfg, stabilize_factor=2e-4))
    _same_stabilization(ts, tr, js, jr)
    js.config = dataclasses.replace(js.config, stabilize_factor=0.0)
    ts.config = dataclasses.replace(ts.config, stabilize_factor=0.0)
    jr2, tr2 = js.solve(inp), ts.solve(convert.inp_from(inp))
    assert "stab_diag" not in js._arrs
    assert ts._stab_diag is ts._stab_ref is ts._stab_scale is None
    assert tr2.stabilization_energy == jr2.stabilization_energy == 0.0
    _same_history(tr2, jr2)
    _same_state(ts, js)
    plain = T.FEMSystem(ts.mesh, ts.material, True, T.SolverConfig(**cfg),
                        device="cpu")
    rp = plain.solve(convert.inp_from(inp))
    assert [dataclasses.astuple(r) for r in rp.increments] == [
        dataclasses.astuple(r) for r in tr2.increments]
    assert torch.equal(plain.dof, ts.dof)


# --------------------------------------------------------------------------- #
# units against the JAX twins
# --------------------------------------------------------------------------- #
def _state(jm, seed, scale=0.05):
    """A seeded displacement of every dof."""
    return np.random.default_rng(seed).standard_normal(jm.n_dof) * scale


def _kinematics_t(tm, u, mat):
    nodes, el = _t(tm.nodes), torch.from_numpy(tm.elements.astype(np.int64))
    dN, w = _t(tm.element.dshape_at_gp), _t(tm.element.gauss_weights)
    dsdX0, _ = tasm.gradients_and_volume(nodes, el, dN, w)
    F_ = tasm.deformation_gradient(_t(u), el, dsdX0)
    sigma = tasm.gp_stress(F_, mat, large=True)
    dsdx, vol = tasm.gradients_and_volume(
        nodes + _t(u).reshape(-1, tm.dm), el, dN, w)
    return nodes, el, dN, w, dsdx, vol, sigma


def _kinematics_j(jm, u, mat):
    nodes, el = jnp.asarray(jm.nodes), jnp.asarray(jm.elements)
    dN, w = jnp.asarray(jm.element.dshape_at_gp), jnp.asarray(jm.element.gauss_weights)
    dsdX0, _ = jasm.gradients_and_volume(nodes, el, dN, w)
    F_ = jasm.deformation_gradient(jnp.asarray(u), el, dsdX0)
    sigma = jasm.gp_stress(F_, mat, large=True)
    dsdx, vol = jasm.gradients_and_volume(
        nodes + jnp.asarray(u).reshape(-1, jm.dm), el, dN, w)
    return nodes, el, dN, w, dsdx, vol, sigma


UNIT_CASES = {
    "tet4": (lambda: F.meshgen.unstructured_box_tets(3),
             lambda: F.LinearIsotropic(1000.0, 0.3)),
    "hex8-neo": (lambda: F.meshgen.box_hexes(2, 2, 1),
                 lambda: F.NeoHookean(100.0, 50.0)),
    "tri3-plane-stress": (lambda: F.meshgen.rect_tris(3, 2),
                          lambda: F.LinearIsotropicPlaneStress(200.0, 0.25)),
    "quad4-plane-strain": (lambda: F.meshgen.rect_quads(3, 2),
                           lambda: F.LinearIsotropicPlaneStrain(200.0, 0.3)),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_internal_force_and_geometric_stiffness_match_jax(case):
    jm = UNIT_CASES[case][0]()
    jmat = UNIT_CASES[case][1]()
    tm, tmat = convert.mesh_from(jm), convert.material_from(jmat)
    u = _state(jm, 1)
    *_, dsdx, vol, sigma = _kinematics_t(tm, u, tmat)
    *_, jdsdx, jvol, jsigma = _kinematics_j(jm, u, jmat)
    assert _rel(sigma, jsigma) < 1e-12
    dm = tm.dm
    targets = (jm.elements.astype(np.int64)[:, :, None] * dm
               + np.arange(dm)).reshape(-1)
    f_j = jasm.internal_force(jdsdx, jsigma, jvol, jnp.asarray(targets),
                              jm.n_dof)
    # the force kernel's plain version, from the stiffness scatter's plan
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    f_elem = tasm.element_internal_force(dsdx, sigma, vol).contiguous()
    f_t = kforce.scatter_force_plain(f_elem, plan)
    assert _rel(f_t, f_j) < 1e-12
    before = kforce.scatter_force.launches
    assert torch.equal(kforce.scatter_force(f_elem, plan), f_t)
    assert kforce.scatter_force.launches == before
    # and the f64 host twins of the stress and the whole residual
    F_np = np.asarray(jasm.deformation_gradient(
        jnp.asarray(u), jnp.asarray(jm.elements), jasm.gradients_and_volume(
            jnp.asarray(jm.nodes), jnp.asarray(jm.elements),
            jnp.asarray(jm.element.dshape_at_gp),
            jnp.asarray(jm.element.gauss_weights))[0]))
    np.testing.assert_array_equal(thost.gp_stress_host(F_np, tmat, large=True),
                                  jhost.gp_stress_host(F_np, jmat, large=True))
    assert _rel(thost.internal_force_host(tm, tmat, u),
                jhost.internal_force_host(jm, jmat, u)) < 1e-14
    assert _rel(thost.internal_force_host(tm, tmat, u), f_j) < 1e-12
    Kg_t = tasm.geometric_stiffness(dsdx, sigma, vol)
    Kg_j = jasm.geometric_stiffness(jdsdx, jsigma, jvol)
    assert Kg_t.is_contiguous() and _rel(Kg_t, Kg_j) < 1e-12


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_consistent_tangent_matches_jax(case):
    """Forward-mode autodiff through every material (the 2-D ones embed F
    in 3-D out of place) gives femcy_tpu's scanned JVPs."""
    jm = UNIT_CASES[case][0]()
    jmat = UNIT_CASES[case][1]()
    tm, tmat = convert.mesh_from(jm), convert.material_from(jmat)
    u = _state(jm, 2)
    nodes, el, dN, w, *_ = _kinematics_t(tm, u, tmat)
    Ke_t = tasm.consistent_tangent(_t(u), el, nodes, dN, w, tmat)
    jn, jel, jdN, jw, *_ = _kinematics_j(jm, u, jmat)
    Ke_j = jasm.consistent_tangent(jnp.asarray(u), jel, jn, jdN, jw, jmat)
    assert Ke_t.shape == Ke_j.shape
    assert _rel(Ke_t, Ke_j) < 1e-12
    # at u = 0 the linear materials' tangent is the small-strain stiffness
    if "neo" not in case:
        Ke0 = tasm.consistent_tangent(torch.zeros(tm.n_dof, dtype=torch.float64),
                                      el, nodes, dN, w, tmat)
        dsdx, vol = tasm.gradients_and_volume(nodes, el, dN, w)
        assert _rel(Ke0, tasm.element_stiffness(dsdx, vol, _t(tmat.C))) < 1e-12


def test_box_scatters_match_jax():
    """structured_dia_scatter and structured_force_scatter on a non-cubic
    box against femcy_tpu's; the secant tangent from the current
    coordinates (structured_assemble_coords, the port's only box route)
    against femcy_tpu's structured_assemble from the gradients."""
    jm = F.meshgen.box_tets(3, 2, 4, 1.5, 1.0, 2.0)
    tm = convert.mesh_from(jm)
    u = _state(jm, 3)
    mat = F.LinearIsotropic(1000.0, 0.3)
    tmat = convert.material_from(mat)
    tplan = tstr.build_structured_plan(tm, tdia.build_structured_dia_pattern(tm))
    jplan = jstr.build_structured_plan(jm, jdia.build_structured_dia_pattern(jm))
    nodes, _, dN, w, dsdx, vol, sigma = _kinematics_t(tm, u, tmat)
    _, _, _, _, jdsdx, jvol, jsigma = _kinematics_j(jm, u, mat)
    Ke = (tasm.element_stiffness(dsdx, vol, _t(tmat.C))
          + tasm.geometric_stiffness(dsdx, sigma, vol))
    jKe = (jasm.element_stiffness(jdsdx, jvol, jnp.asarray(mat.C))
           + jasm.geometric_stiffness(jdsdx, jsigma, jvol))
    assert _rel(tstr.structured_dia_scatter(Ke, tplan),
                jstr.structured_dia_scatter(jKe, jplan)) < 1e-13
    coords = nodes + _t(u).reshape(-1, 3)
    assert _rel(tstr.structured_assemble_coords(coords, tm, dN, w,
                                                _t(tmat.C), tplan,
                                                C_host=tmat.C),
                jstr.structured_assemble(jdsdx, jvol, jnp.asarray(mat.C),
                                         jplan)) < 1e-13
    f_elem = tasm.element_internal_force(dsdx, sigma, vol).contiguous()
    jf = jnp.einsum("egaj,egji,eg->eai", jdsdx, jsigma, jvol)
    f_t = tstr.structured_force_scatter(f_elem, tplan, tm)
    assert _rel(f_t, jstr.structured_force_scatter(jf, jplan, jm)) < 1e-13
    before = ksforce.force_scatter.launches
    assert torch.equal(ksforce.force_scatter(f_elem, tplan, tm), f_t)
    assert ksforce.force_scatter.launches == before
    # the general path's sum of the same forces agrees
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    assert _rel(f_t, kforce.scatter_force_plain(f_elem, plan)) < 1e-13
    with pytest.raises(ValueError):
        tstr.structured_dia_scatter(Ke[:-1], tplan)


@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_dirichlet_newton_matches_jax(layout):
    jm = F.meshgen.box_hexes(3, 2, 2)
    tm = convert.mesh_from(jm)
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    rng = np.random.default_rng(4)
    fixed = rng.uniform(size=tm.n_dof) < 0.3
    residual = rng.standard_normal(tm.n_dof)
    if layout == "ell":
        values = rng.standard_normal((tp.n_dof, tp.width)) * tp.valid
        vt, rt = tbc.apply_dirichlet_newton(
            _t(values), torch.from_numpy(tp.colidx.astype(np.int64)),
            torch.from_numpy(tp.diag_slot), _t(residual),
            torch.from_numpy(fixed))
        vj, rj = jbc.apply_dirichlet_newton(
            jnp.asarray(values), jnp.asarray(tp.colidx),
            jnp.asarray(tp.diag_slot), jnp.asarray(residual),
            jnp.asarray(fixed))
        assert (vt.numpy()[~tp.valid] == 0).all()
    else:
        td = tdia.build_dia_pattern(tm, ell=tp)
        values = rng.standard_normal((tm.n_dof, td.n_offsets))
        vt, rt = tdia.dia_dirichlet_newton(
            _t(values), td.offsets, td.diag_idx, _t(residual),
            torch.from_numpy(fixed))
        vj, rj = jdia.dia_dirichlet_newton(
            jnp.asarray(values), td.offsets, td.diag_idx,
            jnp.asarray(residual), jnp.asarray(fixed))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert (rt.numpy()[fixed] == 0).all()


def test_rotation_hook_and_default_match_jax():
    rng = np.random.default_rng(5)
    for dm in (2, 3):
        nodes = rng.uniform(0.0, 50.0, (7, dm))
        for center in ((0.5, 0.5, 0.0), (40.0, 5.0, 0.0)):
            th = tuser.make_rotation_dirichlet(center)
            jh = juser.make_rotation_dirichlet(center)
            for d in range(dm):
                np.testing.assert_allclose(
                    th(nodes, d, 0.3), np.asarray(jh(nodes, d, 0.3)),
                    rtol=1e-14, atol=1e-12)
    jm, inp = _twist_box()
    t_inp, tm = convert.inp_from(inp), convert.mesh_from(jm)
    for time in (0.0625, 0.125):
        ft, st = tbc.build_dirichlet_arrays(t_inp.dirichlet_bcs, tm, time, 1.0)
        fj, sj = jbc.build_dirichlet_arrays(inp.dirichlet_bcs, jm, time, 1.0)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(st, sj, rtol=1e-14, atol=1e-12)
        assert np.abs(st).max() > 0.1


# --------------------------------------------------------------------------- #
# the force kernels' walks, bit for bit
# --------------------------------------------------------------------------- #
def _collapsed_hexes():
    jm = F.meshgen.box_hexes(2, 2, 2)
    elements = np.array(jm.elements)
    elements[0, 7] = elements[0, 6]  # element 0 names the centre node twice
    return convert.mesh_from(F.FEMesh(jm.nodes, elements, jm.element))


def _m4_walk(f_elem, plan):
    """The M4 kernel's rule in numpy: group t sums node node_order[t], dm
    sums from +0; it takes the node's pairs in list order (a flagged ~p
    decoded to p) eight at a time, one a lane, and adds the eight records
    f_e[p * dm : p * dm + dm] in lane order (the shuffle chain)."""
    ptr, pairs = plan.node_ptr.numpy(), plan.pairs.numpy()
    flat = f_elem.reshape(-1, plan.dm)
    out = np.full((ptr.shape[0] - 1, plan.dm), np.nan, dtype=f_elem.dtype)
    for n in plan.node_order.numpy():
        acc = np.zeros(plan.dm, dtype=f_elem.dtype)
        for base in range(ptr[n], ptr[n + 1], 8):
            ids = pairs[base:min(base + 8, ptr[n + 1])]
            lanes = flat[np.where(ids < 0, ~ids, ids)]  # the group's loads
            for j in range(lanes.shape[0]):
                acc += lanes[j]
        out[n] = acc
    return out.reshape(-1)


@pytest.mark.parametrize("name", ["tet4", "tri3", "hex20", "collapsed-hex8",
                                  "orphan-tet4"])
def test_internal_force_kernel_walk_is_bit_equal(name):
    tm = {
        "tet4": lambda: convert.mesh_from(F.meshgen.unstructured_box_tets(3)),
        "tri3": lambda: convert.mesh_from(F.meshgen.rect_tris(4, 3)),
        "hex20": lambda: convert.mesh_from(F.meshgen.box_hexes20(2, 1, 1)),
        "collapsed-hex8": _collapsed_hexes,
        "orphan-tet4": lambda: convert.mesh_from(
            F.meshgen.unstructured_box_tets(3)),
    }[name]()
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    elements = tm.elements.astype(np.int64)
    if name == "orphan-tet4":
        # one more node, numbered 7, that no element names
        plan = kscat.with_orphan_node(plan, 7)
        elements = elements + (elements >= 7)
    assert ((plan.pairs < 0).any()) == (name == "collapsed-hex8")
    # node_order: every node once, sorted by its first pair, orphans last
    ptr, pairs = plan.node_ptr.numpy(), plan.pairs.numpy()
    order = plan.node_order.numpy()
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(ptr.shape[0] - 1))
    listed = np.diff(ptr)[order] > 0
    assert not (~listed[:-1] & listed[1:]).any()  # the empty ones last
    assert listed.sum() == ptr.shape[0] - 1 - (name == "orphan-tet4")
    first = pairs[ptr[:-1][order[listed]]]
    assert (np.diff(np.where(first < 0, ~first, first)) > 0).all()
    npe = tm.element.n_nodes
    targets = (elements[:, :, None] * tm.dm + np.arange(tm.dm)).reshape(-1)
    np.testing.assert_array_equal(kforce.force_targets(plan).numpy(), targets)
    for dtype in (np.float32, np.float64):
        f_elem = np.random.default_rng(6).standard_normal(
            (tm.n_elements, npe, tm.dm)).astype(dtype)
        plain = kforce.scatter_force(torch.from_numpy(f_elem), plan)
        assert plain.dtype == torch.from_numpy(f_elem).dtype
        np.testing.assert_array_equal(_m4_walk(f_elem, plan), plain.numpy())
        # femcy_tpu's segment-sum of the same forces
        seg = jax.ops.segment_sum(
            jnp.asarray(f_elem.reshape(-1)), jnp.asarray(targets),
            num_segments=plan.n_dof)
        np.testing.assert_array_equal(plain.numpy(), np.asarray(seg))
        if name == "orphan-tet4":
            assert not plain.numpy()[7 * tm.dm:8 * tm.dm].any()


def _m5_walk(f_elem, plan):
    """The first M5 kernel's rule in numpy: one grid node at a time, 3 sums
    from +0 over the 24 (orientation, local node) corner shifts in order,
    each adding the values of cell node - shift where that cell is in the
    box."""
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    shifts = plan.force_shifts
    fg = f_elem.reshape(nx * ny * nz, 24, 3)
    out = np.empty(((nx + 1) * (ny + 1) * (nz + 1), 3), dtype=f_elem.dtype)
    for node in range(out.shape[0]):
        ix, rem = divmod(node, (ny + 1) * (nz + 1))
        iy, iz = divmod(rem, nz + 1)
        acc = np.zeros(3, dtype=f_elem.dtype)
        for k, (dx, dy, dz) in enumerate(shifts):
            cx, cy, cz = ix - dx, iy - dy, iz - dz
            if 0 <= cx < nx and 0 <= cy < ny and 0 <= cz < nz:
                acc += fg[(cx * ny + cy) * nz + cz, k]
        out[node] = acc
    return out.reshape(-1)


def _m5_tile_walk(f_elem, plan, tile):
    """The M5 kernel's tiled slab march in numpy.  A block owns a (ty, tz)
    tile of grid nodes and node planes [x0, x0 + lx); a ring of three
    slabs holds the cells of x - 1 and x over the tile and one halo row at
    -1 in y and z, each cell padded to 16 bytes past its 72 values (NaN
    where nothing was copied: a cell outside the box, or padding).  After
    plane x's sums, slab x + 2 replaces slab x - 1.  Thread (i, y, z) adds
    value i of record k of cell node - shift k, for k in order, from +0,
    where that cell lies in the box."""
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    ty, tz, lx = tile
    S = 72 + 16 // f_elem.itemsize
    cells = f_elem.reshape(nx, ny, nz, 72)
    out = np.full((nx + 1, ny + 1, nz + 1, 3), np.nan, dtype=f_elem.dtype)
    i, yl, zl = np.meshgrid(np.arange(3), np.arange(ty), np.arange(tz),
                            indexing="ij")
    for y0 in range(0, ny + 1, ty):
        for z0 in range(0, nz + 1, tz):
            y, z = y0 + yl, z0 + zl
            mine = (y <= ny) & (z <= nz)
            cy_lo, cy_hi = max(y0 - 1, 0), min(y0 + ty - 1, ny - 1)
            cz_lo, cz_hi = max(z0 - 1, 0), min(z0 + tz - 1, nz - 1)
            for x0 in range(0, nx + 1, lx):
                x_end = min(x0 + lx, nx + 1)
                ring = np.full((3, ty + 1, tz + 1, S), np.nan, f_elem.dtype)

                def fetch(cx, b):
                    ring[b] = np.nan
                    if 0 <= cx < nx and cx < x_end:
                        ring[b, cy_lo - y0 + 1:cy_hi - y0 + 2,
                             cz_lo - z0 + 1:cz_hi - z0 + 2, :72] = cells[
                                 cx, cy_lo:cy_hi + 1, cz_lo:cz_hi + 1]

                for m in range(3):
                    fetch(x0 - 1 + m, m)
                for s in range(x_end - x0):
                    x = x0 + s
                    acc = np.zeros(i.shape, dtype=f_elem.dtype)
                    for k, (dx, dy, dz) in enumerate(plan.force_shifts):
                        use = ((0 <= x - dx < nx) & (y - dy >= 0)
                               & (y - dy < ny) & (z - dz >= 0) & (z - dz < nz))
                        slab = ring[s % 3] if dx else ring[(s + 1) % 3]
                        v = slab[yl + 1 - dy, zl + 1 - dz, 3 * k + i]
                        acc = np.where(use, acc + v, acc)
                    out[x, y[mine], z[mine], i[mine]] = acc[mine]
                    fetch(x + 2, s % 3)
    return out.reshape(-1)


@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 2, 4), (4, 3, 2)])
def test_structured_force_kernel_walk_is_bit_equal(dims):
    jm = F.meshgen.box_tets(*dims)
    tm = convert.mesh_from(jm)
    plan = tstr.build_structured_plan(tm, tdia.build_structured_dia_pattern(tm))
    shifts = plan.force_shifts
    assert shifts.shape == (24, 3) and shifts.dtype == np.int32
    assert shifts.flags["C_CONTIGUOUS"]
    kuhn, delta = tm.structure["kuhn"], np.asarray(tm.structure["corner_delta"])
    np.testing.assert_array_equal(
        shifts.reshape(6, 4, 3), delta[np.asarray(kuhn)])
    for dtype in (np.float32, np.float64):
        f_elem = np.random.default_rng(7).standard_normal(
            (tm.n_elements, 4, 3)).astype(dtype)
        plain = ksforce.force_scatter(torch.from_numpy(f_elem), plan, tm)
        assert plain.dtype == torch.from_numpy(f_elem).dtype
        np.testing.assert_array_equal(_m5_walk(f_elem, plan), plain.numpy())
        jplan = jstr.build_structured_plan(jm, jdia.build_structured_dia_pattern(jm))
        np.testing.assert_array_equal(
            plain.numpy(),
            np.asarray(jstr.structured_force_scatter(jnp.asarray(f_elem),
                                                     jplan, jm)))


@pytest.mark.parametrize("dims, tile", [
    ((1, 1, 1), None), ((3, 2, 4), None), ((4, 3, 2), None),
    ((5, 6, 19), None),            # no multiple of the plan's tiles
    ((5, 6, 19), (2, 3, 2)),       # nor of a small one
    ((3, 2, 4), (1, 1, 1)),
    ((2, 3, 1), (4, 16, 8)),       # thinner than the tile
])
def test_structured_force_tile_walk_is_bit_equal(dims, tile):
    jm = F.meshgen.box_tets(*dims)
    tm = convert.mesh_from(jm)
    plan = tstr.build_structured_plan(tm, tdia.build_structured_dia_pattern(tm))
    assert set(plan.force_shifts.reshape(-1)) <= {0, 1}  # one halo cell
    jplan = jstr.build_structured_plan(jm, jdia.build_structured_dia_pattern(jm))
    for dtype in (np.float32, np.float64):
        f_elem = np.random.default_rng(7).standard_normal(
            (tm.n_elements, 4, 3)).astype(dtype)
        walk = _m5_tile_walk(
            f_elem, plan, tile or plan.force_tile[np.dtype(dtype).name])
        plain = ksforce.force_scatter(torch.from_numpy(f_elem), plan, tm)
        np.testing.assert_array_equal(walk, plain.numpy())
        np.testing.assert_array_equal(
            walk, np.asarray(jstr.structured_force_scatter(
                jnp.asarray(f_elem), jplan, jm)))


def test_structured_force_tile_fills_the_card_in_one_wave():
    """The plan's M5 tile: FORCE_TILES' (ty, tz), and lx cut so that the
    blocks fill the card's SMs once where the box allows (an H100 SXM's
    132 where no card is visible)."""
    for dims in ((56, 56, 56), (16, 16, 16), (5, 6, 19), (1, 1, 1)):
        tm = convert.mesh_from(F.meshgen.box_tets(*dims))
        plan = tstr.build_structured_plan(
            tm, tdia.build_structured_dia_pattern(tm))
        nx, ny, nz = dims
        for name, (ty, tz, per_sm) in ksforce.FORCE_TILES.items():
            assert plan.force_tile[name][:2] == (ty, tz)
            lx = plan.force_tile[name][2]
            tiles = -(-(ny + 1) // ty) * -(-(nz + 1) // tz)
            blocks = tiles * -(-(nx + 1) // lx)
            slots = ksforce.card_sms() * per_sm
            assert blocks <= max(slots, tiles)
            assert lx == 1 or tiles * -(-(nx + 1) // (lx - 1)) > slots
    assert {name: ksforce.force_tile(56, 56, 56, name, ksforce.H100_SMS)
            for name in ksforce.FORCE_TILES} == {"float32": (8, 8, 10),
                                                 "float64": (6, 8, 19)}


def test_force_wrappers_reject_bad_operands():
    tm = convert.mesh_from(F.meshgen.box_tets(2, 2, 2))
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    splan = tstr.build_structured_plan(tm, tdia.build_structured_dia_pattern(tm))
    f = torch.zeros((tm.n_elements, 4, 3), dtype=torch.float64)
    for call in (lambda x: kforce.scatter_force(x, plan),
                 lambda x: ksforce.force_scatter(x, splan, tm)):
        with pytest.raises(ValueError):
            call(f[:-1])
        with pytest.raises(TypeError):
            call(f.to(torch.int64))
        with pytest.raises(ValueError):
            call(f.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):  # the launch takes CUDA tensors only
        ksforce.launch_at(f, splan, (1, 1, 1))


@pytest.mark.parametrize("name", ["tet4", "collapsed-hex8"])
def test_m4_read_sectors_match_a_count_load_by_load(name):
    """M4's sector bytes against a count in plain Python: the set of
    32-byte sectors that each record load and each node's run of pair
    ids touch, and the sum of their sizes alone."""
    tm = {"tet4": lambda: convert.mesh_from(F.meshgen.unstructured_box_tets(3)),
          "collapsed-hex8": _collapsed_hexes}[name]()
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    ptr, pairs = plan.node_ptr.numpy(), plan.pairs.numpy()
    for itemsize in (4, 8):
        rec = plan.dm * itemsize
        f_e, f_e_each, listed, listed_each = set(), 0, set(), 0
        for n in range(ptr.shape[0] - 1):
            run = set()
            for t in range(ptr[n], ptr[n + 1]):
                p = int(pairs[t]) if pairs[t] >= 0 else ~int(pairs[t])
                span = set(range(p * rec // 32, (p * rec + rec - 1) // 32 + 1))
                f_e |= span
                f_e_each += len(span)
                run.add(t * 4 // 32)
            listed |= run
            listed_each += len(run)
        assert kforce.m4_read_sectors(plan, itemsize) == {
            "f_e distinct": 32 * len(f_e), "f_e per thread": 32 * f_e_each,
            "pairs distinct": 32 * len(listed),
            "pairs per thread": 32 * listed_each}


def test_every_kernel_entry_binds_all_its_parameters():
    """Each wrapper's ctypes argtypes name every parameter of its C entry
    point, the stream last: ctypes passes an undeclared argument as a C
    int, which cuts a pointer (a stream cut so crashes the launch)."""
    import importlib
    import pathlib
    import re

    csrc = pathlib.Path(T.__file__).parent / "csrc"
    params = {}
    for src in csrc.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     src.read_text()):
            params[name] = [a.split()[-1] for a in args.split(",")]
    wrappers = ("dia_spmv", "structured_accumulate", "structured_fused",
                "ell_scatter", "ell_spmv", "internal_force",
                "structured_force")
    for mod in wrappers:
        m = importlib.import_module(f"femcy_tpu_torch.kernels.{mod}")
        for entry in m._ENTRY.values():
            names = params[entry]
            assert len(m._ARGTYPES) == len(names), (entry, names)
            assert names[-1] == "stream", entry
