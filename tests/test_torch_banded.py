"""The port's RCM block-tridiagonal sharded solve (``femcy_tpu_torch.
parallel.banded``, ``SolverConfig(sharding="banded")``) against femcy_tpu's,
on the CPU, in float64.  The port runs its shards in one process, all on
the CPU; femcy_tpu's on XLA's virtual host devices (tests/conftest.py).

- ``build_banded_operands`` equals femcy_tpu's array for array (perm, B,
  nb, nbl, element shards and targets), ``build_coarse_basis`` within
  1e-15.
- M8's plan gives back its targets, and its plain version is a host
  segment-sum (``np.add.at``, entry order) bit for bit; the port's
  assembly (M8 on every shard, the halo-add, the Dirichlet elimination)
  equals femcy_tpu's ``_assemble`` V and b within 1e-13 (relative to the
  largest entry over the shards).
- The four preconditioners on cantilever_tets(10, 3) in 4 shards at
  cg_eps 1e-6: x within 1e-9 of femcy_tpu's (relative to max|x|); the
  iterations equal for twolevel, tridiag and block, and within 1% for
  jacobi (~300 iterations on operators that differ from femcy_tpu's in
  the last bits, which XLA sums in another order; 303 against 304 here);
  twolevel < tridiag < jacobi, as tests/test_banded.py holds them.
- One ``newton_eval`` with stabilization operands (secant and consistent)
  within 1e-12 of femcy_tpu's, the rms within 1e-12 relative.
- ``FEMSystem(sharding="banded", sharding_devices=4)``, secant and
  consistent, on tests/test_banded.py's nlgeom cantilever at cg_eps
  1e-10: the increments and Newton loops of femcy_tpu's banded run, dof
  within 1e-8 and the elastic energy within 1e-10 relative.
- The same answer on 1, 2, 4 and 8 shards; bad options raise.

The module runs on one torch thread (small shards, many small ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC
from femcy_tpu.parallel import banded as jb

import femcy_tpu_torch as T
from femcy_tpu_torch import convert
from femcy_tpu_torch.kernels import btd_scatter
from femcy_tpu_torch.parallel import banded as tb

from test_torch_rescue import one_thread  # noqa: F401  (autouse fixture)

D = 4


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _cantilever(nx=10, n=3):
    """tests/test_banded.py's Neumann cantilever: one end clamped, uy = 1
    on the loaded end's nodes."""
    jm, fixed_nodes, loaded = F.meshgen.cantilever_tets(nx, n)
    fixed = np.zeros(jm.n_dof, bool)
    for d in range(3):
        fixed[fixed_nodes * 3 + d] = True
    rhs = np.zeros(jm.n_dof)
    rhs[loaded * 3 + 1] = 1.0
    return jm, F.LinearIsotropic(1000.0, 0.3), fixed, rhs, np.zeros(jm.n_dof)


def _port(jm, mat, n=D, **kw):
    return tb.BandedShardedSolver(convert.mesh_from(jm),
                                  convert.material_from(mat),
                                  devices=["cpu"] * n, **kw)


@pytest.mark.parametrize("case", ["cantilever", "tri3", "box"])
def test_banded_operands_match_jax(case):
    if case == "cantilever":
        jm, mat = _cantilever()[:2]
    elif case == "tri3":
        jm, mat = F.meshgen.rect_tris(14, 9), F.LinearIsotropicPlaneStress(
            100.0, 0.3)
    else:
        jm, mat = F.meshgen.box_tets(4, 3, 3), F.LinearIsotropic(100.0, 0.3)
    jo = jb.build_banded_operands(jm, mat, D)
    tm = convert.mesh_from(jm)
    to_ = tb.build_banded_operands(tm, convert.material_from(mat), D)
    for f in ("n_devices", "n_dof", "B", "nb", "nbl"):
        assert getattr(to_, f) == getattr(jo, f), f
    for f in ("perm", "iperm", "elements", "ele_weight", "scatter_targets",
              "force_targets", "nodes", "dshape_gp", "weights_gp", "C"):
        a, b = getattr(to_, f), getattr(jo, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    zj = jb.build_coarse_basis(jo, jm.nodes, jm.dm)
    zt = tb.build_coarse_basis(to_, tm.nodes, tm.dm)
    assert zt.shape == zj.shape
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-15)


def test_m8_plan_and_plain_version():
    """The plan's targets round trip and its plain version is the host
    segment-sum over femcy_tpu's targets, both plans, bit for bit."""
    jm, mat = _cantilever()[:2]
    ops = jb.build_banded_operands(jm, mat, D)
    edof, nbl, B = jm.element.edof, ops.nbl, ops.B
    rng = np.random.default_rng(0)
    for d in range(D):
        ne = int(ops.ele_weight[d].sum())
        for tgt, n_out in ((ops.scatter_targets[d, : ne * edof * edof],
                            (nbl + 1) * 3 * B * B),
                           (ops.force_targets[d, : ne * edof],
                            (nbl + 1) * B)):
            plan = btd_scatter.build_plan(tgt, n_out, "cpu")
            np.testing.assert_array_equal(
                btd_scatter.targets_of(plan).numpy(), tgt)
            assert plan.order.dtype == torch.int32
            vals = rng.standard_normal(tgt.shape[0])
            host = np.zeros(n_out)
            np.add.at(host, tgt, vals)
            out = btd_scatter.scatter(torch.as_tensor(vals), plan)
            np.testing.assert_array_equal(out.numpy(), host)
    with pytest.raises(ValueError, match="outside"):
        btd_scatter.build_plan(np.array([0, 5]), 5, "cpu")


def test_m8_assembly_matches_jax():
    """V and b after the assembly (M8), the halo-add and the elimination,
    against femcy_tpu's ``_assemble``, per shard."""
    jm, mat, fixed, rhs, sval = _cantilever()
    sval[np.nonzero(fixed)[0][::3]] = 0.01  # a nonzero BC
    sj = jb.BandedShardedSolver(jm, mat, devices=jax.devices()[:D])
    Vj, bj = sj._assemble(
        sj._elements, sj._ele_weight, sj._targets, sj._nodes, sj._dN,
        sj._w, sj._C, sj._stack(rhs), sj._stack(fixed, fill=True),
        sj._stack(sval), jnp.zeros(sj.ops.n_dof))
    st = _port(jm, mat)
    V = st.assemble()
    b = tb._btd_dirichlet(V, list(st._stack(fixed, fill=True)),
                          list(st._stack(rhs)), list(st._stack(sval)))
    V = np.stack([v.numpy() for v in V])
    b = np.stack([x.numpy() for x in b])
    assert V.shape == np.shape(Vj) and b.shape == np.shape(bj)
    assert _rel(V, Vj) <= 1e-13
    assert _rel(b, bj) <= 1e-13


@pytest.fixture(scope="module")
def preconditioned():
    """{kind: ((x, iterations) of femcy_tpu, (x, iterations) of the
    port)} at cg_eps 1e-6."""
    jm, mat, fixed, rhs, sval = _cantilever()
    out = {}
    for kind in tb.PRECONDITIONERS:
        sj = jb.BandedShardedSolver(jm, mat, devices=jax.devices()[:D],
                                    cg_eps=1e-6, preconditioner=kind)
        st = _port(jm, mat, cg_eps=1e-6, preconditioner=kind)
        out[kind] = (sj.solve(rhs, fixed, sval), st.solve(rhs, fixed, sval))
    return out


@pytest.mark.parametrize("kind", tb.PRECONDITIONERS)
def test_banded_preconditioner_matches_jax(preconditioned, kind):
    (xj, ij), (xt, it) = preconditioned[kind]
    assert _rel(xt, xj) <= 1e-9
    if kind == "jacobi":
        assert abs(it - ij) <= 0.01 * ij
    else:
        assert it == ij > 0


def test_banded_preconditioner_ordering(preconditioned):
    it = {k: v[1][1] for k, v in preconditioned.items()}
    assert it["twolevel"] < it["tridiag"] < it["jacobi"], it


@pytest.mark.parametrize("tangent", ["secant", "consistent"])
def test_banded_newton_eval_matches_jax(tangent):
    jm, mat, fixed, rhs, sval = _cantilever()
    rng = np.random.default_rng(0)
    dof = rng.normal(scale=0.01, size=jm.n_dof)
    diag = rng.uniform(0.5, 1.5, jm.n_dof)
    ref = rng.normal(scale=0.01, size=jm.n_dof)
    sj = jb.BandedShardedSolver(jm, mat, devices=jax.devices()[:D],
                                tangent=tangent)
    jo = sj.newton_eval(sj.stack(dof), sj.stack(rhs), sj.stack(fixed),
                        sj.stack(sval),
                        stab_s=(sj.stack(diag), sj.stack(ref),
                                jnp.asarray([3.0])))
    st = _port(jm, mat, tangent=tangent)
    to_ = st.newton_eval(st.stack(dof), st.stack(rhs), st.stack(fixed),
                         st.stack(sval),
                         stab_s=(st.stack(diag), st.stack(ref),
                                 torch.tensor(3.0, dtype=torch.float64)))
    for a, b in zip(jo[:3], to_[:3]):
        assert _rel(np.stack([x.numpy() for x in b]), a) <= 1e-12
    assert float(to_[3]) == pytest.approx(float(jo[3]), rel=1e-12)


def _nl_inp(jm, fixed_nodes, loaded):
    """tests/test_banded.py's nlgeom cantilever: a traction of 2 along z on
    the loaded end's faces, two increments."""
    lset = set(loaded.tolist())
    faces = [f for f in jm.boundary if all(n in lset for n in f)]
    return InpModel(
        nodes=jm.nodes, elements=jm.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(fixed_nodes, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(face_set=faces, traction=2.0,
                               direction=np.array([0.0, 0.0, 1.0]))],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5),
    )


@pytest.mark.parametrize("tangent", ["secant", "consistent"])
def test_femsystem_banded_matches_jax(tangent):
    jm, fixed_nodes, loaded = F.meshgen.cantilever_tets(6, 2)
    mat = F.LinearIsotropic(1000.0, 0.3)
    inp = _nl_inp(jm, fixed_nodes, loaded)
    kw = dict(sharding="banded", sharding_devices=D, newton_boost_max=0,
              tangent=tangent, cg_eps=1e-10)
    js = F.FEMSystem(jm, mat, True, config=F.SolverConfig(**kw))
    rj = js.solve(inp)
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat), True,
                     config=T.SolverConfig(**kw), device="cpu")
    rt = ts.solve(convert.inp_from(inp))
    assert rt.success and rj.success
    assert isinstance(ts._shard_sys, tb.BandedShardedSolver)
    assert [(r.newton_iters, r.converged) for r in rt.increments] == [
        (r.newton_iters, r.converged) for r in rj.increments]
    assert _rel(ts.dof.numpy(), np.asarray(js.dof)) <= 1e-8
    assert ts.elastic_energy() == pytest.approx(js.elastic_energy(),
                                                rel=1e-10)


def test_banded_device_counts():
    jm, mat, fixed, rhs, sval = _cantilever()
    sols = [_port(jm, mat, n, cg_eps=1e-10).solve(rhs, fixed, sval)[0]
            for n in (1, 2, 4, 8)]
    for s in sols[1:]:
        assert _rel(s, sols[0]) <= 1e-8


def test_banded_refusals():
    jm, mat = _cantilever(6, 2)[:2]
    with pytest.raises(ValueError, match="preconditioner"):
        _port(jm, mat, preconditioner="amg")
    with pytest.raises(ValueError, match="tangent"):
        _port(jm, mat, tangent="exact")
    with pytest.raises(ValueError, match="smaller than the RCM bandwidth"):
        _port(jm, mat, block=8)
