"""The port's element-sharded general-mesh solve (``femcy_tpu_torch.parallel.
sharded``) against femcy_tpu's, on the CPU, in float64.  The port runs its
shards in one process, all on the CPU; femcy_tpu's on XLA's virtual host
devices (tests/conftest.py).

- ``build_sharded_operands`` equals femcy_tpu's array for array (dtype
  too), padded rows and padded elements included.
- M7 (M1 and M4 on a plan per element shard): each shard's stiffness and
  force partials equal a host segment-sum (``np.add.at``, in entry order)
  of the shard's element values over femcy_tpu's targets, padded elements
  (zero values) included, bit for bit; the reduce-scatter's row blocks
  equal the partials' sum in shard order, bit for bit.
- ``ShardedLinearSolver`` on box_tets(4, 4, 4) and rect_tris(10, 7) in 4
  shards at cg_eps 1e-10: x within 1e-9 of femcy_tpu's (relative to
  max|x|) in the same iterations; padded rows are inert (5 shards on
  box_tets(3, 3, 3), dof 0 free: within 1e-7 of femcy_tpu's direct
  oracle, tests/test_sharded.py's bound); the same answer within 1e-8 on
  1, 2, 4 and 8 shards.
- ``ShardedNewtonStep`` in 5 shards (row padding included): the new dof
  within 1e-9 (relative to max|dof|), the rms within 1e-12 relative and
  the CG iterations within one of femcy_tpu's (70 against 71 here: its
  operands differ from femcy_tpu's in the last bits, which XLA sums in
  another order, and the Jacobi CG runs ~70 iterations to 1e-10).
- ``femcy_tpu_torch.parallel.__all__`` names femcy_tpu.parallel's.
"""

import jax
import numpy as np
import pytest
import torch

import femcy_tpu as F
import femcy_tpu.parallel as jparallel
from femcy_tpu.parallel import sharded as jsh
from femcy_tpu.solvers.direct import direct_solve

import femcy_tpu_torch.parallel as tparallel
from femcy_tpu_torch import assembly, convert
from femcy_tpu_torch.kernels.ell_scatter import scatter
from femcy_tpu_torch.kernels.internal_force import scatter_force
from femcy_tpu_torch.parallel import sharded as tsh

from test_torch_rescue import one_thread  # noqa: F401  (autouse fixture)

MESHES = {
    "tet4": (lambda: F.meshgen.box_tets(4, 4, 4), lambda: F.LinearIsotropic(
        100.0, 0.3)),
    "tri3": (lambda: F.meshgen.rect_tris(10, 7),
             lambda: F.LinearIsotropicPlaneStress(100.0, 0.3)),
}


def _tension(mesh):
    """tests/test_sharded.py's problem: x=0 clamped, ux = 0.05 at x=max."""
    fixed = np.zeros(mesh.n_dof, dtype=bool)
    sval = np.zeros(mesh.n_dof)
    dm = mesh.dm
    left = np.nonzero(mesh.nodes[:, 0] < 1e-9)[0]
    right = np.nonzero(mesh.nodes[:, 0] > mesh.nodes[:, 0].max() - 1e-9)[0]
    for d in range(dm):
        fixed[left * dm + d] = True
    fixed[right * dm] = True
    sval[right * dm] = 0.05
    return fixed, sval, np.zeros(mesh.n_dof)


def _port(jm, jmat, D, cls=tsh.ShardedLinearSolver, **kw):
    return cls(convert.mesh_from(jm), convert.material_from(jmat),
               devices=["cpu"] * D, **kw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name, D", [("tet4", 4), ("tet4", 5), ("tri3", 3)])
def test_sharded_operands_match_jax(name, D):
    make_mesh, make_mat = MESHES[name]
    jm, mat = make_mesh(), make_mat()
    jo = jsh.build_sharded_operands(jm, mat, D)
    to_ = tsh.build_sharded_operands(convert.mesh_from(jm),
                                     convert.material_from(mat), D)
    for f in ("n_devices", "n_dof", "n_dof_pad", "width", "rows_per_dev"):
        assert getattr(to_, f) == getattr(jo, f), f
    for f in ("elements", "ele_weight", "scatter_targets", "force_targets",
              "colidx", "diag_local", "nodes", "dshape_gp", "weights_gp",
              "C"):
        a, b = getattr(to_, f), getattr(jo, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_m7_partials_are_the_host_segment_sum():
    """Each shard's M7 partials (the kernels' plain versions on the CPU)
    against np.add.at over femcy_tpu's targets, and the row blocks
    against the partials summed in shard order: bit for bit."""
    jm = F.meshgen.box_tets(3, 3, 3)
    mat = F.LinearIsotropic(100.0, 0.3)
    D = 5  # 162 elements in shards of 33, the last padded
    ops = jsh.build_sharded_operands(jm, mat, D)
    sv = _port(jm, mat, D, cls=tsh.ShardedNewtonStep)
    rng = np.random.default_rng(0)
    dof = torch.as_tensor(0.01 * rng.standard_normal(jm.n_dof))
    E_s, edof = ops.elements.shape[1], jm.element.edof
    npad, W = ops.n_dof_pad, ops.width
    partials, f_parts = [], []
    for d, s in enumerate(sv.shards):
        ne = s.elements.shape[0]
        u = dof.reshape(-1, 3)
        dsdx, vol = assembly.gradients_and_volume(s.nodes + u, s.elements,
                                                  s.dN, s.w)
        F_ = assembly.deformation_gradient_u(u[s.elements], s.dsdX0)
        sigma = assembly.gp_stress(F_, sv.material, large=True)
        Ke = assembly.element_stiffness(dsdx, vol, s.C)
        f_e = assembly.element_internal_force(dsdx, sigma, vol).contiguous()
        part = scatter(Ke, s.plan)
        f_part = scatter_force(f_e, s.plan)
        host = np.zeros(npad * W)
        ke = np.zeros((E_s, edof, edof))
        ke[:ne] = Ke.numpy()  # the padded elements' values are 0
        np.add.at(host, ops.scatter_targets[d], ke.reshape(-1))
        np.testing.assert_array_equal(
            part.numpy(), host.reshape(npad, W)[: ops.n_dof])
        host_f = np.zeros(npad)
        fe = np.zeros((E_s, edof))
        fe[:ne] = f_e.reshape(ne, edof).numpy()
        np.add.at(host_f, ops.force_targets[d], fe.reshape(-1))
        np.testing.assert_array_equal(f_part.numpy(), host_f[: ops.n_dof])
        partials.append(part)
        f_parts.append(f_part)
    rows = tsh.psum_scatter(sv.ops, partials)
    full = np.zeros((npad, W))
    full[: ops.n_dof] = partials[0].numpy()
    for p in partials[1:]:  # shard order
        full[: ops.n_dof] += p.numpy()
    rpd = ops.rows_per_dev
    for d, r in enumerate(rows):
        np.testing.assert_array_equal(r.numpy(), full[d * rpd:(d + 1) * rpd])
    assert all(r.shape == (rpd, W) for r in rows)


@pytest.mark.parametrize("name", ["tet4", "tri3"])
def test_sharded_linear_matches_jax(name):
    make_mesh, make_mat = MESHES[name]
    jm, mat = make_mesh(), make_mat()
    fixed, sval, rhs = _tension(jm)
    js = jsh.ShardedLinearSolver(jm, mat, devices=jax.devices()[:4],
                                 cg_eps=1e-10)
    xj, ij = js.solve(rhs, fixed, sval)
    xt, it = _port(jm, mat, 4, cg_eps=1e-10).solve(rhs, fixed, sval)
    assert it == ij > 0
    assert _rel(xt, xj) <= 1e-9


def _direct_oracle(jm, mat, rhs, fixed, sval):
    system = F.FEMSystem(jm, mat, False,
                         F.SolverConfig(linear_solver="direct"))
    values, rhs_bc, _ = system._jit_linear_system(
        system._arrs, jax.numpy.asarray(rhs), jax.numpy.asarray(fixed),
        jax.numpy.asarray(sval))
    pat = system.dia if system.dia is not None else system.pattern
    return np.asarray(direct_solve(pat, values, rhs_bc))


def test_sharded_solve_padded_rows_are_inert():
    """n_dof = 192 in 5 shards (3 padded rows) with dof 0 FREE: the padded
    rows must not couple to column 0."""
    jm = F.meshgen.box_tets(3, 3, 3)
    mat = F.LinearIsotropic(100.0, 0.3)
    fixed = np.zeros(jm.n_dof, dtype=bool)
    sval = np.zeros(jm.n_dof)
    right = np.nonzero(jm.nodes[:, 0] > jm.nodes[:, 0].max() - 1e-9)[0]
    for d in range(3):
        fixed[right * 3 + d] = True  # node 0 (x=0 corner) stays free
    sval[right * 3] = 0.05
    rhs = np.zeros(jm.n_dof)
    solver = _port(jm, mat, 5, cg_eps=1e-10)
    assert solver.ops.n_dof_pad - solver.ops.n_dof == 3
    x, _ = solver.solve(rhs, fixed, sval)
    x_ref = _direct_oracle(jm, mat, rhs, fixed, sval)
    assert _rel(x, x_ref) <= 1e-7


def test_sharded_solve_on_1_2_4_8_shards():
    jm = F.meshgen.box_tets(3, 3, 3)
    mat = F.LinearIsotropic(100.0, 0.3)
    fixed, sval, rhs = _tension(jm)
    sols = [_port(jm, mat, n, cg_eps=1e-10).solve(rhs, fixed, sval)[0]
            for n in (1, 2, 4, 8)]
    for s in sols[1:]:
        np.testing.assert_allclose(s, sols[0], atol=1e-8)


def test_sharded_newton_step_matches_jax():
    jm = F.meshgen.box_tets(3, 3, 3)
    mat = F.LinearIsotropic(100.0, 0.3)
    fixed = np.zeros(jm.n_dof, dtype=bool)
    left = np.nonzero(jm.nodes[:, 0] < 1e-9)[0]
    for d in range(3):
        fixed[left * 3 + d] = True
    right = np.nonzero(jm.nodes[:, 0] > jm.nodes[:, 0].max() - 1e-9)[0]
    rhs = np.zeros(jm.n_dof)
    rhs[right * 3 + 1] = 0.2
    sval = np.zeros(jm.n_dof)
    dof0 = 0.01 * np.random.default_rng(0).standard_normal(jm.n_dof)
    js = jsh.ShardedNewtonStep(jm, mat, devices=jax.devices()[:5],
                               cg_eps=1e-10)
    dj, rj, kj = js.step(dof0, rhs, fixed, sval)
    ts = _port(jm, mat, 5, cls=tsh.ShardedNewtonStep, cg_eps=1e-10)
    dt, rt, kt = ts.step(dof0, rhs, fixed, sval)
    # the Jacobi CG runs ~70 iterations to 1e-10 on operands that differ
    # from femcy_tpu's in the last bits (XLA sums the shards' partials and
    # the SpMV rows in another order): one iteration either way
    assert kj > 0 and abs(kt - kj) <= 1
    assert float(rt) == pytest.approx(float(rj), rel=1e-12)
    assert _rel(dt.numpy(), dj) <= 1e-9


def test_parallel_names_match_jax():
    assert set(tparallel.__all__) == set(jparallel.__all__)
    for name in tparallel.__all__:
        assert callable(getattr(tparallel, name))
