"""The implicit-dynamics rescue (``SolverConfig(dynamic_rescue=True)``) of
femcy_tpu_torch against femcy_tpu's, on the CPU, in float64.

The model is femcy_tpu's snap-through fixture (tests/test_dynamic_rescue.py:
a shallow CPE4 arch, 64 x 2 elements, span 100, rise 8, thickness 0.8,
hinged at its mid-thickness ends, a pressure of 0.2 on its top face,
``tangent="consistent"``).  femcy_tpu's rescued run is made once for the
module, from t = 0, keeping the state after every converged increment.
The port's evaluation costs ~20 ms on the CPU (the consistent tangent's
op dispatches), so its runs here start from femcy_tpu's last converged
state before the snap (t ~ 0.02788, with the dt femcy_tpu had there) and
``resume=True``: the stepping from there on is the one femcy_tpu's run
took.  The port's whole run from t = 0 is held against femcy_tpu's
through both CLIs (tests/test_torch_cli.py) and on the card
(chip_smoke.py phase 31).

- The static control aborts (time0 < 0.1) with the within-increment-snap
  diagnosis, femcy_tpu's message for the same resumed run.
- The rescued run: success, time0 == 1.0, the apex below -2 * rise, the
  rescue's increment (t_resc = t0 + ini_inc, dt = ini_inc, its Newmark
  steps, residual 0.0, converged) recorded, and every record equal to
  femcy_tpu's from the same state on, field by field: kinc (offset by
  the increments before it), Newton loops and convergence equal, times
  and dt within 1e-12, converged residuals within 1e-8 of the largest
  residual (as tests/test_torch_newton.py holds them; a failed
  increment's residual is the last of 24 diverging iterates, which at the
  snap differs by up to half between the packages and is not compared).
  The Newmark loop turns roundoff into branch changes (h grows and shrinks
  on Newton loop counts), so two packages whose evaluations differ at
  1e-15 could part after many steps; here they do not part: the records
  are the same and the minimum uy agrees within 1e-6 relative (the
  tolerance of femcy_tpu's banded-sharding rescue test; measured ~1e-15).
- The rescued state is a static equilibrium: a static resume moves dof by
  at most 1e-9.
- A live stabilization's leftover C/dt scale is zeroed for the stiffness
  probe and the reference set to the entry state, and all three restored
  after the rescue, with femcy_tpu's outcome and detail (a rescue allowed
  one Newmark step).  The stabilized run, the multi-block rescue and the
  multi-block probes are in tests/test_torch_rescue_stabilized.py and
  tests/test_torch_rescue_blocks.py (each run costs ~30-60 s here).
- The rescue's two probes on the arch at a seeded state: the lumped
  volume diagonal within 1e-13 relative of femcy_tpu's and the
  Dirichlet-treated tangent diagonal within 1e-12 (the packages compute
  element volumes and matrices in other orders, so neither is bit for bit
  the other's).
- A rescue that fails (``dynamic_max_steps=1``) aborts with femcy_tpu's
  message: the base, then the diagnosis, then the rescue's detail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu import bc as jbc
from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC

import femcy_tpu_torch as T
from femcy_tpu_torch import convert

RISE = 8.0


def arch_inp(pressure=-0.2, nx=64, ny=2, span=100.0, rise=RISE, thick=0.8):
    """femcy_tpu's fixture arch (tests/test_dynamic_rescue.py::_arch_inp)."""
    radius = (span / 2) ** 2 / (2 * rise) + rise / 2
    th0 = np.arcsin((span / 2) / radius)
    nodes = np.zeros(((nx + 1) * (ny + 1), 2))

    def nid(i, j):
        return j * (nx + 1) + i

    for j in range(ny + 1):
        r = radius - thick / 2 + thick * j / ny
        for i in range(nx + 1):
            phi = -th0 + 2 * th0 * i / nx
            nodes[nid(i, j)] = [r * np.sin(phi), r * np.cos(phi)]
    elems = np.asarray(
        [[nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)]
         for j in range(ny) for i in range(nx)], dtype=np.int32)
    ends = np.array([nid(0, ny // 2), nid(nx, ny // 2)])
    bcs = [DirichletBC(ends, 0, 0.0), DirichletBC(ends, 1, 0.0)]
    top = [tuple(sorted((nid(i, ny), nid(i + 1, ny)))) for i in range(nx)]
    return InpModel(
        nodes=nodes, elements=elems, element_type="CPE4", node_sets={},
        ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[NeumannBC(face_set=top, traction=pressure,
                               direction=None)],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.05, max_time=1.0, min_inc=1e-5, max_inc=0.1),
    )


def jax_system(inp, **cfg):
    mat = F.materials.material_from_inp(inp.material_type,
                                        inp.material_params, inp.element_type)
    return F.FEMSystem(F.FEMesh(inp.nodes, inp.elements, inp.element), mat,
                       True, F.SolverConfig(tangent="consistent", **cfg))


def port_system(inp, **cfg):
    tinp = convert.inp_from(inp)
    mat = T.material_from_inp(tinp.material_type, tinp.material_params,
                              tinp.element_type)
    return T.FEMSystem(T.FEMesh(tinp.nodes, tinp.elements, tinp.element),
                       mat, True,
                       T.SolverConfig(tangent="consistent", **cfg),
                       device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: its runs are thousands of
    evaluations on 128 elements, where intra-op threads only add
    synchronisation, and beside other test workers they oversubscribe the
    cores (measured ~10x slower with three workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record_tuples(report, kinc0=0):
    return [(r.kinc - kinc0, r.newton_iters, r.converged)
            for r in report.increments]


@pytest.fixture(scope="module")
def jax_rescued():
    """femcy_tpu's rescued run from t = 0, and the state after every
    converged increment: {record index: dof}."""
    inp = arch_inp()
    system = jax_system(inp, dynamic_rescue=True)
    seen = []
    report = system.solve(inp, on_increment=lambda s, r: seen.append(
        (r, np.asarray(s.dof))))
    index = {id(r): i for i, r in enumerate(report.increments)}
    return system, report, {index[id(r)]: dof for r, dof in seen}


def pre_snap(jax_rescued, back=0):
    """(index of the record, its time, its dt, the dof after it) of
    femcy_tpu's last converged increment before the rescue, or ``back``
    converged increments earlier."""
    _, report, states = jax_rescued
    recs = report.increments
    k = next(i for i, r in enumerate(recs) if r.converged and r.residual == 0.0)
    conv = [i for i in range(k) if recs[i].converged]
    i = conv[-1 - back]
    return i, recs[i].time, recs[i].dt, states[i]


def resumed(system, state, inp, **kw):
    """``system.solve(resume=True)`` from femcy_tpu's state
    (index, time, dt, dof)."""
    _, t0, dt, dof = state
    system.dof = (torch.as_tensor(dof.copy()) if isinstance(system, T.FEMSystem)
                  else jnp.asarray(dof))
    system.time0 = system.time1 = t0
    system.dt = dt
    return system.solve(inp, resume=True, **kw)


def same_tail(report, jax_report, i):
    """report's records equal femcy_tpu's after its record i."""
    tail = jax_report.increments[i + 1:]
    kinc0 = tail[0].kinc
    assert record_tuples(report) == [
        (r.kinc - kinc0, r.newton_iters, r.converged) for r in tail]
    scale = max(abs(r.residual) for r in tail)
    for t, j in zip(report.increments, tail):
        assert t.time == pytest.approx(j.time, abs=1e-12)
        assert t.dt == pytest.approx(j.dt, abs=1e-12)
        if j.converged:
            assert abs(t.residual - j.residual) <= 1e-8 * scale


@pytest.fixture(scope="module")
def port_rescued(jax_rescued):
    inp = arch_inp()
    system = port_system(inp, dynamic_rescue=True)
    return system, resumed(system, pre_snap(jax_rescued),
                           convert.inp_from(inp))


def test_static_control_aborts_within_the_increment(jax_rescued):
    inp = arch_inp()
    state = pre_snap(jax_rescued)
    ts, js = port_system(inp), jax_system(inp)
    report = resumed(ts, state, convert.inp_from(inp))
    jreport = resumed(js, state, inp)
    assert not report.success
    assert ts.time0 < 0.1
    assert "WITHIN the increment" in report.message
    assert "inversion" not in report.message.split(";")[0]
    assert report.message == jreport.message
    assert record_tuples(report) == record_tuples(jreport)


def test_rescue_matches_jax(port_rescued, jax_rescued):
    system, report = port_rescued
    js, jr, _ = jax_rescued
    i, t0, _, _ = pre_snap(jax_rescued)
    assert report.success and jr.success
    assert system.time0 == 1.0
    uy = system.dof.numpy().reshape(-1, 2)[:, 1]
    assert uy.min() < -2 * RISE
    # the rescue's record: t_resc = t0 + ini_inc, past the static failure
    rescue = [r for r in report.increments
              if r.converged and r.residual == 0.0]
    assert len(rescue) == 1
    assert rescue[0].time == pytest.approx(t0 + 0.05, abs=1e-12)
    assert rescue[0].dt == 0.05 and rescue[0].newton_iters > 0
    same_tail(report, jr, i)
    uy_j = np.asarray(js.dof).reshape(-1, 2)[:, 1]
    assert uy.min() == pytest.approx(uy_j.min(), rel=1e-6)


def test_rescued_state_is_a_static_equilibrium(port_rescued):
    system, _ = port_rescued
    dof_end = system.dof.clone()
    system.config = T.SolverConfig(tangent="consistent")
    system.dt = 0.05
    report = system.solve(convert.inp_from(arch_inp()), resume=True)
    assert report.success
    assert float((system.dof - dof_end).abs().max()) <= 1e-9


def test_rescue_zeroes_and_restores_a_live_stabilization(jax_rescued):
    """A leftover C/dt scale is zeroed for the stiffness probe, the
    reference set to the entry state, and all three restored after the
    rescue (here one that fails: one Newmark step), as in femcy_tpu."""
    from femcy_tpu_torch.system import dynamic_traverse

    inp = arch_inp()
    _, t0, _, dof = pre_snap(jax_rescued)
    cfg = dict(dynamic_rescue=True, dynamic_max_steps=1)
    ts, js = port_system(inp, **cfg), jax_system(inp, **cfg)
    ts.dof, js.dof = torch.as_tensor(dof.copy()), jnp.asarray(dof)
    t_resc = t0 + 0.05
    fixed = np.zeros(js.mesh.n_dof, bool)
    fixed[[130, 131, 258, 259]] = True  # the hinges
    patterns, tractions = jbc.build_neumann_patterns(js.mesh,
                                                     inp.neumann_bcs)
    jrhs = (tractions * t_resc) @ patterns  # the load held at t_resc
    rng = np.random.default_rng(2)
    diag = rng.uniform(0.5, 1.5, js.mesh.n_dof)
    ref = dof + rng.normal(scale=1e-3, size=dof.shape)
    ts._stab_diag, ts._stab_ref = torch.as_tensor(diag), torch.as_tensor(ref)
    ts._stab_scale = ts._scalar(3.0e4)
    js._arrs.update(stab_diag=jnp.asarray(diag), stab_ref=jnp.asarray(ref),
                    stab_scale=jnp.asarray(3.0e4))
    saved = (ts._stab_diag, ts._stab_ref, ts._stab_scale)
    probed = []
    probe = ts._tangent_diag_host

    def spy(*a):
        probed.append((float(ts._stab_scale), ts._stab_ref))
        return probe(*a)

    ts._tangent_diag_host = spy
    out = dynamic_traverse(ts, torch.as_tensor(jrhs), torch.as_tensor(fixed),
                           torch.zeros(ts.mesh.n_dof, dtype=torch.float64),
                           None)
    jout = js._dynamic_traverse(jnp.asarray(jrhs), jnp.asarray(fixed),
                                jnp.zeros(js.mesh.n_dof), None)
    assert probed[0][0] == 0.0 and torch.equal(probed[0][1], ts.dof)
    assert (ts._stab_diag, ts._stab_ref, ts._stab_scale) == saved
    assert float(js._arrs["stab_scale"]) == 3.0e4
    assert out[:2] == tuple(jout[:2]) and not out[0]
    assert out[2] == jout[2]
    np.testing.assert_array_equal(ts.dof.numpy(), dof)  # rolled back


def test_rescue_probes_match_jax():
    inp = arch_inp()
    js, ts = jax_system(inp), port_system(inp)
    rng = np.random.default_rng(0)
    dof = rng.normal(scale=0.05, size=js.mesh.n_dof)
    js.dof, ts.dof = jnp.asarray(dof), torch.as_tensor(dof)
    fixed = np.zeros(js.mesh.n_dof, bool)
    fixed[[130, 131]] = True  # node 65, the left hinge
    sval = np.zeros(js.mesh.n_dof)
    rhs = rng.normal(size=js.mesh.n_dof)
    mj = np.asarray(js._lumped_volume_diag())
    mt = ts._lumped_volume_diag().numpy()
    assert np.abs(mt - mj).max() <= 1e-13 * np.abs(mj).max()
    kj = js._tangent_diag_host(jnp.asarray(rhs), jnp.asarray(fixed),
                               jnp.asarray(sval))
    kt = ts._tangent_diag_host(torch.as_tensor(rhs), torch.as_tensor(fixed),
                               torch.as_tensor(sval))
    assert np.abs(kt - kj).max() <= 1e-12 * np.abs(kj).max()


def test_failed_rescue_message_matches_jax(jax_rescued):
    """One Newmark step cannot settle: the abort message is the base, the
    diagnosis and the rescue's detail, in that order, and the dof is
    rolled back to the state the increment started from."""
    inp = arch_inp()
    state = pre_snap(jax_rescued)
    cfg = dict(dynamic_rescue=True, dynamic_max_steps=1)
    ts, js = port_system(inp, **cfg), jax_system(inp, **cfg)
    trep = resumed(ts, state, convert.inp_from(inp))
    jrep = resumed(js, state, inp)
    assert not trep.success and not jrep.success
    assert trep.message == jrep.message
    msg = trep.message
    assert msg.startswith("allowable minimum dt reached; Newton's method "
                          "did not converge; tangent positive definite")
    detail = "; dynamic rescue: kinetic energy did not settle within 1 steps"
    assert msg.index("WITHIN the increment") < msg.index(detail)
    assert msg.count("dynamic rescue") == 1
    np.testing.assert_array_equal(ts.dof.numpy(), state[3])
