"""The port's slab-sharded structured solve (``femcy_tpu_torch.parallel.
structured``, ``SolverConfig(sharding="slab")``) against femcy_tpu's, on the
CPU, in float64.  The port runs its shards in one process, all on the CPU;
femcy_tpu's on XLA's virtual host devices (tests/conftest.py).

- The shard plan, ``stack_rows`` and ``unstack_rows`` equal femcy_tpu's, and
  a slab's shared plane is the same array on both owners.
- ``ShardedStructuredSolver`` on box_tets(8, 2, 2) with two shards: one
  ``solve`` (Jacobi and multigrid, cg_eps 1e-10) within 1e-12 of
  femcy_tpu's (relative to the largest entry; both iterate the same
  arithmetic, summed in another order), the same iterations; one
  ``newton_eval`` with nonzero stabilization operands (secant and
  consistent tangents) within 1e-12, the rms within 1e-12 relative, and
  the shared plane of its tangent and residual bit for bit equal on both
  owners.
- ``FEMSystem(sharding="slab")`` on box_tets(16, 4, 4), as
  tests/test_sharded_structured.py holds femcy_tpu's slab: linear over 8
  shards within 1e-8 of femcy_tpu's single-device ``FEMSystem``, Newton
  over 2 shards (the plain P2 on the CPU walks its 864 planes once a
  shard, so 8 shards take four times as long) with the secant and with
  the consistent tangent within 1e-7 with the same increments and Newton
  counts, the energy within 1e-6 and Mises within 1e-5.
- The multigrid slab on box_tets(16, 8, 8) within 1e-6 of the Jacobi slab
  in fewer than a quarter of its iterations; odd slabs, an nx the shards
  do not divide and an unstructured mesh are refused with ValueError.
- The plain windowed DIA SpMV equals the dense product of the same rows
  to 1e-13 relative; a window that leaves x raises.

The module runs on one torch thread (small shards, many launches: beside
other test workers, intra-op threads oversubscribe the cores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu.io.inp import DirichletBC, InpModel
from femcy_tpu.parallel import structured as jps

import femcy_tpu_torch as T
from femcy_tpu_torch import convert
from femcy_tpu_torch.kernels import dia_spmv as k_spmv
from femcy_tpu_torch.parallel import structured as tps
from femcy_tpu_torch.solvers.dia import (
    build_structured_dia_pattern,
    dia_spmv_window,
)

from test_torch_rescue import one_thread  # noqa: F401  (autouse fixture)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _problem(dims):
    jm = F.meshgen.box_tets(*dims)
    fixed = np.zeros(jm.n_dof, bool)
    bottom = np.nonzero(jm.nodes[:, 2] < 1e-12)[0]
    top = np.nonzero(jm.nodes[:, 2] > 1 - 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(jm.n_dof)
    rhs[top * 3] = 1.0
    return jm, F.LinearIsotropic(1000.0, 0.3), fixed, rhs, np.zeros(jm.n_dof)


def _blocks(b):
    return np.stack([x.numpy() for x in b])


@pytest.mark.parametrize("dims, D", [((16, 3, 2), 8), ((8, 2, 2), 2)])
def test_slab_plan_stack_unstack_match_jax(dims, D):
    jm = F.meshgen.box_tets(*dims)
    jp = jps.build_structured_shard_plan(jm, D)
    tp = tps.build_structured_shard_plan(convert.mesh_from(jm), D)
    assert _plan_fields(tp) == _plan_fields(jp)
    v = np.arange(jm.n_dof, dtype=float)
    blocks = tps.stack_rows(tp, v)
    np.testing.assert_array_equal(blocks, jps.stack_rows(jp, v))
    for d in range(D - 1):  # the shared plane, on both owners
        np.testing.assert_array_equal(blocks[d, -tp.ps:],
                                      blocks[d + 1, :tp.ps])
    np.testing.assert_array_equal(tps.unstack_rows(tp, blocks), v)


def _plan_fields(plan):
    return {f: getattr(plan, f) for f in (
        "n_devices", "nx", "ny", "nz", "nxl", "ps", "local_rows", "offsets",
        "diag_idx", "n_dof")}


@pytest.mark.parametrize("preconditioner", ["jacobi", "multigrid"])
def test_slab_solve_matches_jax(preconditioner):
    jm, mat, fixed, rhs, sval = _problem((8, 2, 2))
    sval[np.nonzero(jm.nodes[:, 2] < 1e-12)[0] * 3] = 0.01  # a nonzero BC
    js = jps.ShardedStructuredSolver(jm, mat, devices=jax.devices()[:2],
                                     cg_eps=1e-10,
                                     preconditioner=preconditioner)
    xj, ij = js.solve(rhs, fixed, sval)
    ts = tps.ShardedStructuredSolver(
        convert.mesh_from(jm), convert.material_from(mat),
        devices=["cpu", "cpu"], cg_eps=1e-10, preconditioner=preconditioner)
    xt, it = ts.solve(rhs, fixed, sval)
    assert it == ij > 0
    assert _rel(xt, xj) <= 1e-12


@pytest.mark.parametrize("tangent", ["secant", "consistent"])
def test_slab_newton_eval_matches_jax(tangent):
    jm, mat, fixed, rhs, sval = _problem((8, 2, 2))
    rng = np.random.default_rng(0)
    dof = rng.normal(scale=0.01, size=jm.n_dof)
    diag = rng.uniform(0.5, 1.5, jm.n_dof)
    ref = rng.normal(scale=0.01, size=jm.n_dof)
    js = jps.ShardedStructuredSolver(jm, mat, devices=jax.devices()[:2],
                                     tangent=tangent)
    jo = js.newton_eval(js.stack(dof), js.stack(rhs), js.stack(fixed),
                        js.stack(sval),
                        stab_s=(js.stack(diag), js.stack(ref),
                                jnp.asarray([3.0])))
    ts = tps.ShardedStructuredSolver(
        convert.mesh_from(jm), convert.material_from(mat),
        devices=["cpu", "cpu"], tangent=tangent)
    to = ts.newton_eval(ts.stack(dof), ts.stack(rhs), ts.stack(fixed),
                        ts.stack(sval),
                        stab_s=(ts.stack(diag), ts.stack(ref),
                                torch.tensor(3.0, dtype=torch.float64)))
    for a, b in zip(jo[:3], to[:3]):
        assert _rel(_blocks(b), a) <= 1e-12
    assert float(to[3]) == pytest.approx(float(jo[3]), rel=1e-12)
    ps = ts.plan.ps
    for blocks in (to[1], to[2]):  # the shared plane stays bitwise equal
        assert torch.equal(blocks[0][-ps:], blocks[1][:ps])


def _nl_inp(jm, uz=0.3):
    """Clamp x=0, prescribe a transverse displacement on x=lx, two nominal
    increments (tests/test_sharded_structured.py's model)."""
    lx = jm.nodes[:, 0].max()
    left = np.nonzero(jm.nodes[:, 0] < 1e-12)[0]
    right = np.nonzero(jm.nodes[:, 0] > lx - 1e-12)[0]
    bcs = [DirichletBC(left, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(right, 0, 0.0), DirichletBC(right, 1, 0.0),
            DirichletBC(right, 2, uz)]
    return InpModel(
        nodes=jm.nodes, elements=jm.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5),
    )


def _slab_system(jm, mat, nlgeom, shards, **cfg):
    return T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat),
                       nlgeom, T.SolverConfig(sharding="slab",
                                              sharding_devices=shards, **cfg),
                       device="cpu")


def test_femsystem_slab_linear_matches_single_device_jax():
    jm = F.meshgen.box_tets(16, 4, 4)
    mat = F.LinearIsotropic(1000.0, 0.3)
    inp = _nl_inp(jm)
    inp.geometric_nonlinear = False
    js = F.FEMSystem(jm, mat, False,
                     F.SolverConfig(linear_solver="cg", cg_eps=1e-10))
    assert js.solve(inp).success
    ts = _slab_system(jm, mat, False, 8, linear_solver="cg", cg_eps=1e-10)
    assert ts.solve(convert.inp_from(inp)).success
    assert len(ts._shard_sys.devices) == 8 and ts._last_cg_iters > 0
    assert _rel(ts.dof.numpy(), js.dof) <= 1e-8
    assert {r.name for r in ts.timer.records} == {"sharded_linear"}


@pytest.mark.parametrize("tangent", ["secant", "consistent"])
def test_femsystem_slab_newton_matches_single_device_jax(tangent):
    jm = F.meshgen.box_tets(16, 4, 4)
    mat = F.LinearIsotropic(1000.0, 0.3)
    inp = _nl_inp(jm)
    cfg = dict(linear_solver="cg", cg_eps=1e-10, tangent=tangent)
    if tangent == "consistent":
        cfg["newton_boost_max"] = 0
    js = F.FEMSystem(jm, mat, True, F.SolverConfig(**cfg))
    jr = js.solve(inp)
    ts = _slab_system(jm, mat, True, 2, **cfg)
    tr = ts.solve(convert.inp_from(inp))
    assert jr.success and tr.success
    assert [(r.kinc, r.newton_iters, r.converged) for r in tr.increments] == [
        (r.kinc, r.newton_iters, r.converged) for r in jr.increments]
    u = ts.dof.numpy()
    assert np.abs(np.asarray(js.dof)).max() > 0.1  # it deformed
    assert _rel(u, js.dof) <= 1e-7
    assert ts.elastic_energy() == pytest.approx(js.elastic_energy(), rel=1e-6)
    _, _, mj = js.compute_strain_stress()
    _, _, mt = ts.compute_strain_stress()
    mj = np.asarray(mj)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-5,
                               atol=1e-8 * mj.max())
    names = {r.name for r in ts.timer.records}
    assert names == {"newton_eval", "linear_solve"}


def test_slab_multigrid_matches_jacobi_in_fewer_iterations():
    jm, mat, fixed, rhs, sval = _problem((16, 8, 8))
    tm, tmat = convert.mesh_from(jm), convert.material_from(mat)
    jac = tps.ShardedStructuredSolver(tm, tmat, devices=["cpu"] * 4,
                                      cg_eps=1e-8)
    x_j, it_j = jac.solve(rhs, fixed, sval)
    mg = tps.ShardedStructuredSolver(tm, tmat, devices=["cpu"] * 4,
                                     cg_eps=1e-8, preconditioner="multigrid")
    x_m, it_m = mg.solve(rhs, fixed, sval)
    assert _rel(x_m, x_j) <= 1e-6
    assert it_m < it_j / 4, (it_m, it_j)


def test_slab_refusals():
    mat = T.LinearIsotropic(1000.0, 0.3)
    with pytest.raises(ValueError, match="even"):  # odd ny cannot coarsen
        tps.ShardedStructuredSolver(T.meshgen.box_tets(16, 5, 4), mat,
                                    devices=["cpu"] * 8,
                                    preconditioner="multigrid")
    with pytest.raises(ValueError, match="even"):  # odd slab width
        tps.ShardedStructuredSolver(T.meshgen.box_tets(12, 4, 4), mat,
                                    devices=["cpu"] * 4,
                                    preconditioner="multigrid")
    with pytest.raises(ValueError, match="divisible"):
        tps.build_structured_shard_plan(T.meshgen.box_tets(10, 3, 3), 8)
    jm, _, _ = F.meshgen.cantilever_tets(4, 2)
    with pytest.raises(ValueError, match="slab"):
        T.FEMSystem(convert.mesh_from(jm), mat,
                    config=T.SolverConfig(sharding="slab"), device="cpu")


def test_windowed_spmv_plain_matches_dense():
    mesh = T.meshgen.box_tets(4, 3, 3)
    dia = build_structured_dia_pattern(mesh)
    rng = np.random.default_rng(1)
    n = 60
    values = torch.as_tensor(rng.standard_normal((n, dia.n_offsets)))
    x_ext = torch.as_tensor(rng.standard_normal(n + 300))
    plan = k_spmv.spmv_plan(n, dia.offsets, "cpu")
    lo = -min(dia.offsets)
    for base in (lo, lo + 7):
        dense = np.zeros((n, x_ext.shape[0]))
        for k, off in enumerate(dia.offsets):
            dense[np.arange(n), base + np.arange(n) + off] += values[:, k].numpy()
        y = dia_spmv_window(values, dia.offsets, x_ext, base)
        assert _rel(y.numpy(), dense @ x_ext.numpy()) <= 1e-13
        # the kernel wrapper runs the plain version on CPU tensors
        yk = k_spmv.spmv_window(plan, values.t().contiguous(), x_ext, base)
        assert torch.equal(yk, y)
    for bad in (lo - 1, x_ext.shape[0]):
        with pytest.raises(ValueError, match="window"):
            dia_spmv_window(values, dia.offsets, x_ext, bad)
        with pytest.raises(ValueError, match="window"):
            k_spmv.spmv_window(plan, values.t().contiguous(), x_ext, bad)
