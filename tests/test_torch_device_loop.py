"""The fused Newton step (``SolverConfig.fused_newton``) and the device loop
(``SolverConfig.device_loop``) of femcy_tpu_torch against femcy_tpu's, on
the CPU, in float64.

- fused_newton on cantilever_tets(6, 2) under a *Dsload, with the sparse
  (box DIA) and the dense CG at cg_eps 1e-10: the same records (kinc,
  time, dt, Newton loops, convergence; residuals within 1e-8 of the
  largest, as tests/test_torch_newton.py holds them) and dof within 1e-10
  relative.  (At the default cg_eps 1e-3
  each truncated CG turns the packages' roundoff differences into 3e-5
  relative residual differences, the records staying equal.)
- device_loop on a box_tets(3, 3, 3) twist by the default rotation hook,
  against femcy_tpu's one-program loop and the port's own host loop, as
  tests/test_device_loop.py holds femcy_tpu's: the host-loop match (the
  consistent tangent, no boost, the dense CG), a cutback forced by
  newton_max_iters=3, and the extrapolation predictor with the global
  residual reference under the secant tangent and the boost line search.
  Against femcy_tpu: the same records and dof within 1e-10.  Against the
  host loop: the same convergence flags, and on converged increments the
  same times, dt and Newton loops (a failed attempt's record carries
  time1 and max(k - 1, 0) here, time0 and k there), dof within 1e-8
  (1e-5 with the boost, whose undo keeps the pre-step state where the
  host loop steps back in floating point).
- the record capacity ends the analysis with status 3 and its message,
  no checkpoint; unsupported configurations raise ValueError with
  femcy_tpu's message and run nothing.
"""

import numpy as np
import pytest

import femcy_tpu as F
from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC

import femcy_tpu_torch as T
from femcy_tpu_torch import convert

BASE = dict(tangent="consistent", newton_boost_max=0, linear_solver="cg",
            dense_operator_max_dof=8192)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _port(jm, mat, cfg, nlgeom=True):
    return T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat),
                       nlgeom, T.SolverConfig(**cfg), device="cpu")


def _same_records(tr, jr, tol=1e-8):
    assert tr.success == jr.success and tr.message == jr.message
    assert len(tr.increments) == len(jr.increments)
    scale = max(abs(r.residual) for r in jr.increments) or 1.0
    for t, j in zip(tr.increments, jr.increments):
        assert (t.kinc, t.newton_iters, t.converged) == (
            j.kinc, j.newton_iters, j.converged)
        assert t.time == pytest.approx(j.time, abs=1e-12)
        assert t.dt == pytest.approx(j.dt, abs=1e-12)
        assert abs(t.residual - j.residual) <= tol * scale


def _cantilever():
    jm, fixed, loaded = F.meshgen.cantilever_tets(6, 2)
    lset = set(loaded.tolist())
    faces = [f for f in jm.boundary if all(n in lset for n in f)]
    inp = InpModel(
        nodes=jm.nodes, elements=jm.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(fixed, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(face_set=faces, traction=2.0,
                               direction=np.array([0.0, 0.0, 1.0]))],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5))
    return jm, F.LinearIsotropic(1000.0, 0.3), inp


@pytest.mark.parametrize("cg", ["sparse", "dense"])
def test_fused_step_matches_jax(cg):
    jm, mat, inp = _cantilever()
    cfg = dict(fused_newton=True, linear_solver="cg", newton_boost_max=0,
               cg_eps=1e-10)
    if cg == "dense":
        cfg["dense_operator_max_dof"] = 10_000
    js = F.FEMSystem(jm, mat, True, F.SolverConfig(**cfg))
    jr = js.solve(inp)
    ts = _port(jm, mat, cfg)
    tr = ts.solve(convert.inp_from(inp))
    assert tr.success and ts._use_dense_cg == (cg == "dense")
    assert ts.dia is not None
    _same_records(tr, jr)
    assert _rel(ts.dof, js.dof) < 1e-10
    # one fused step per evaluation, each with its CG; no separate solve
    steps = ts.timer.summary()["fused_step"]["count"]
    assert steps == len(ts._cg_iters_log) > 0
    assert "linear_solve" not in ts.timer.summary()


def _twist(max_time=0.125, ini_inc=0.03125, max_inc=0.0625):
    """box_tets(3, 3, 3) about the default hook's axis (40, 5): z=0
    clamped, the z=1 face turned by ``*Boundary, user`` (time * pi)."""
    base = F.meshgen.box_tets(3, 3, 3)
    jm = F.FEMesh(base.nodes + np.array([39.5, 4.5, 0.0]), base.elements,
                  base.element, structure=base.structure)
    z = jm.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > 1 - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
    inp = InpModel(
        nodes=jm.nodes, elements=jm.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=True,
        time_incs=dict(ini_inc=ini_inc, max_time=max_time, min_inc=1e-4,
                       max_inc=max_inc))
    return jm, F.LinearIsotropic(1000.0, 0.3), inp


_CASES = {
    "host match": (dict(), dict(BASE), 1e-8),
    "cutback": (dict(max_time=0.25, ini_inc=0.25, max_inc=0.25),
                dict(BASE, newton_max_iters=3), 1e-8),
    "extrapolate, global, boost": (
        dict(), dict(linear_solver="cg", dense_operator_max_dof=8192,
                     predictor="extrapolate", newton_residual_ref="global"),
        1e-5),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_device_loop_matches_jax_and_the_host_loop(case):
    schedule, cfg, host_tol = _CASES[case]
    jm, mat, inp = _twist(**schedule)
    js = F.FEMSystem(jm, mat, True, F.SolverConfig(device_loop=True, **cfg))
    jr = js.solve(inp)
    ts = _port(jm, mat, dict(device_loop=True, **cfg))
    t_inp = convert.inp_from(inp)
    tr = ts.solve(t_inp)
    assert tr.success
    _same_records(tr, jr)
    assert _rel(ts.dof, js.dof) < 1e-10
    assert ts.time0 == pytest.approx(js.time0) and ts.dt == pytest.approx(
        js.dt)
    assert ts._ini_residual == pytest.approx(js._ini_residual, rel=1e-10)
    assert abs(ts.elastic_energy() - js.elastic_energy()) <= (
        1e-10 * abs(js.elastic_energy()))
    conv = [r.converged for r in tr.increments]
    assert all(conv) == (case != "cutback")
    if case == "extrapolate, global, boost":
        assert max(r.newton_iters for r in tr.increments) > 1

    # the port's own host loop: the same schedule
    hs = _port(jm, mat, cfg)
    hr = hs.solve(t_inp)
    assert [r.converged for r in tr.increments] == [
        r.converged for r in hr.increments]
    for t, h in zip(tr.increments, hr.increments):
        if t.converged:
            assert t.newton_iters == h.newton_iters
            assert (t.time, t.dt) == pytest.approx((h.time, h.dt), abs=1e-12)
    assert _rel(ts.dof, hs.dof) < host_tol

    # a second solve of the same model reuses the program
    prog = ts._device_loop_prog
    assert ts.solve(t_inp).success and ts._device_loop_prog is prog


def test_device_loop_record_capacity_ends_with_status_3(tmp_path):
    jm, mat, inp = _twist()
    ckpt = str(tmp_path / "state")
    ts = _port(jm, mat, dict(BASE, device_loop=True,
                             device_loop_max_records=2,
                             checkpoint_path=ckpt))
    tr = ts.solve(convert.inp_from(inp))
    assert not tr.success and len(tr.increments) == 2
    assert tr.message == (
        "device loop hit its record capacity (2 increments attempted); "
        "raise device_loop_max_records")
    assert not (tmp_path / "state.npz").exists()  # success only
    full = _port(jm, mat, dict(BASE, device_loop=True, checkpoint_path=ckpt))
    fr = full.solve(convert.inp_from(inp))
    assert fr.success and len(fr.increments) == 3
    assert (tmp_path / "state.npz").exists()
    assert [r.time for r in tr.increments] == [
        r.time for r in fr.increments[:2]]


@pytest.mark.parametrize("case", ["linear", "stabilize", "refine",
                                  "on_increment", "on_newton"])
def test_device_loop_unsupported_raises_like_jax(case):
    jm, mat, inp = _twist()
    cfg = dict(BASE, device_loop=True)
    cfg.update({"stabilize": dict(stabilize_factor=1e-4),
                "refine": dict(mixed_precision_refine=True)}.get(case, {}))
    kw = {"on_increment": dict(on_increment=lambda s, r: None),
          "on_newton": dict(on_newton=lambda s, k, r: None)}.get(case, {})
    nlgeom = case != "linear"
    js = F.FEMSystem(jm, mat, nlgeom, F.SolverConfig(**cfg))
    with pytest.raises(ValueError, match="device_loop") as j_exc:
        js.solve(inp, **kw)
    ts = _port(jm, mat, cfg, nlgeom)
    with pytest.raises(ValueError, match="device_loop") as t_exc:
        ts.solve(convert.inp_from(inp), **kw)
    assert str(t_exc.value) == str(j_exc.value)
    assert not ts.timer.records and ts._device_loop_prog is None
    assert not ts.dof.any()
