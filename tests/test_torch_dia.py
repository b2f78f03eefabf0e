"""The port's DIA layer against femcy_tpu's: the plain SpMV (against the
JAX shifted-slice SpMV and the Pallas kernel in interpret mode), the
Dirichlet elimination, the PCG (scalar and block Jacobi), and the SpMV
kernel wrapper's CPU behaviour.

Tolerances: float64 results agree to 1e-13 relative to the largest entry
(the same sums in the same order, up to the last bits); the f32 Pallas
kernel to 1e-5 (its own f32 rounding, as tests/test_kernels.py states);
PCG solutions to 1e-10 relative with equal iteration counts (f64 dot
products in another order move x by roundoff, far below cg_eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femcy_tpu.kernels.dia_spmv import pallas_spmv, pallas_spmv_plan
from femcy_tpu.kernels.dia_spmv import prep_values as j_prep
from femcy_tpu.materials import LinearIsotropic
from femcy_tpu.meshgen import box_tets
from femcy_tpu.solvers import dia as jdia
from femcy_tpu.structured import (
    analytic_structured_dia_values,
    dia_dirichlet_linear_numpy,
)

from femcy_tpu_torch.kernels import dia_spmv as kspmv
from femcy_tpu_torch.linalg import det_small, inv_small
from femcy_tpu_torch.solvers import dia as tdia


def _operator(dims, eliminate=True):
    mesh = box_tets(*dims)
    dia = jdia.build_structured_dia_pattern(mesh)
    vals = analytic_structured_dia_values(
        mesh, LinearIsotropic(1000.0, 0.3).C, dia
    )
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    if eliminate:
        vals = dia_dirichlet_linear_numpy(vals, dia.offsets, dia.diag_idx, fixed)
    return mesh, dia, vals, fixed


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dims", [(3, 3, 3), (5, 4, 3)])
def test_dia_spmv_matches_jax(dims):
    mesh, dia, vals, _ = _operator(dims)
    x = np.random.default_rng(0).standard_normal(mesh.n_dof)
    y_t = tdia.dia_spmv(torch.from_numpy(vals), dia.offsets, torch.from_numpy(x))
    j_spmv = jax.jit(lambda v, x: jdia.dia_spmv(v, dia.offsets, x))
    y_j = j_spmv(jnp.asarray(vals), jnp.asarray(x))
    assert _rel(y_t, y_j) < 1e-13


def test_dia_spmv_matches_pallas_interpret():
    """The Pallas kernel, interpreted on the CPU in its f32 operand type,
    as tests/test_kernels.py runs it."""
    mesh, dia, vals, _ = _operator((3, 3, 3))
    x = np.random.default_rng(0).standard_normal(mesh.n_dof)
    plan = pallas_spmv_plan(mesh.n_dof, dia.offsets, interpret=True)
    v32 = jnp.asarray(vals, jnp.float32)
    y_p = pallas_spmv(plan, j_prep(plan, v32), jnp.asarray(x, jnp.float32))
    y_t32 = tdia.dia_spmv(torch.from_numpy(vals).float(), dia.offsets,
                          torch.from_numpy(x).float())
    assert _rel(y_t32, y_p) < 1e-5


def test_spmv_wrapper_cpu_runs_plain_and_launches_nothing():
    mesh, dia, vals, _ = _operator((3, 4, 2))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(mesh.n_dof))
    before = kspmv.spmv.launches
    prep, apply_fn = kspmv.make_spmv(mesh.n_dof, dia.offsets, "cpu")
    vt = prep(torch.from_numpy(vals))
    assert tuple(vt.shape) == (dia.n_offsets, mesh.n_dof) and vt.is_contiguous()
    y = apply_fn(vt, x)
    assert torch.equal(y, tdia.dia_spmv(torch.from_numpy(vals), dia.offsets, x))
    assert kspmv.spmv.launches == before


def test_spmv_wrapper_rejects_bad_operands():
    mesh, dia, vals, _ = _operator((3, 3, 2))
    plan = kspmv.spmv_plan(mesh.n_dof, dia.offsets, "cpu")
    vt = kspmv.prep_values(plan, torch.from_numpy(vals))
    x = torch.zeros(mesh.n_dof, dtype=torch.float64)
    with pytest.raises(ValueError):
        kspmv.spmv(plan, vt[:, :-1], x[:-1])
    with pytest.raises(TypeError):
        kspmv.spmv(plan, vt, x.float())
    with pytest.raises(ValueError):
        kspmv.spmv(plan, vt.t().contiguous().t(), x)  # not contiguous
    with pytest.raises(ValueError):
        kspmv.prep_values(plan, torch.from_numpy(vals)[:-1])


def test_dia_dirichlet_linear_matches_jax():
    mesh, dia, vals, fixed = _operator((3, 4, 2), eliminate=False)
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal(mesh.n_dof)
    sval = np.where(fixed, rng.standard_normal(mesh.n_dof), 0.0)
    vj, rj = jdia.dia_dirichlet_linear(
        jnp.asarray(vals), dia.offsets, dia.diag_idx, jnp.asarray(rhs),
        jnp.asarray(fixed), jnp.asarray(sval),
    )
    vals_t = torch.from_numpy(vals)
    vt, rt = tdia.dia_dirichlet_linear(
        vals_t, dia.offsets, dia.diag_idx, torch.from_numpy(rhs),
        torch.from_numpy(fixed), torch.from_numpy(sval),
    )
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert _rel(rt, rj) < 1e-13
    np.testing.assert_array_equal(vals_t.numpy(), vals)  # input untouched


@pytest.mark.parametrize("n", [2, 3])
def test_small_linalg_matches_numpy(n):
    a = np.random.default_rng(n).standard_normal((7, 5, n, n))
    t = torch.from_numpy(a)
    np.testing.assert_allclose(det_small(t).numpy(), np.linalg.det(a), rtol=1e-12)
    np.testing.assert_allclose(inv_small(t).numpy(), np.linalg.inv(a),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("block_dm", [0, 3])
def test_dia_pcg_matches_jax(block_dm):
    mesh, dia, vals, fixed = _operator((4, 3, 3))
    b = np.where(fixed, 0.0, np.random.default_rng(3).standard_normal(mesh.n_dof))
    xj, kj, rj = jdia.dia_pcg_solve(
        jnp.asarray(vals), dia.offsets, dia.diag_idx, jnp.asarray(b),
        eps=1e-8, block_dm=block_dm,
    )
    xt, kt, rt = tdia.dia_pcg_solve(
        torch.from_numpy(vals), dia.offsets, dia.diag_idx, torch.from_numpy(b),
        eps=1e-8, block_dm=block_dm,
    )
    assert kt == int(kj) > 0
    assert _rel(xt, xj) < 1e-10
    assert float(rt) < 1e-8 * np.abs(b).max()


def test_dia_pcg_with_spmv_pair_and_cap():
    """The (prep, apply) pair gives the plain-SpMV iterates on the CPU, and
    max_iters caps the loop as in JAX."""
    mesh, dia, vals, fixed = _operator((3, 3, 3))
    b = torch.from_numpy(
        np.where(fixed, 0.0, np.random.default_rng(4).standard_normal(mesh.n_dof))
    )
    v = torch.from_numpy(vals)
    x0, k0, _ = tdia.dia_pcg_solve(v, dia.offsets, dia.diag_idx, b)
    pair = kspmv.make_spmv(mesh.n_dof, dia.offsets, "cpu")
    x1, k1, _ = tdia.dia_pcg_solve(v, dia.offsets, dia.diag_idx, b, spmv=pair)
    assert k0 == k1 and torch.equal(x0, x1)
    _, k2, _ = tdia.dia_pcg_solve(v, dia.offsets, dia.diag_idx, b, max_iters=3)
    _, kj, _ = jdia.dia_pcg_solve(jnp.asarray(vals), dia.offsets, dia.diag_idx,
                                  jnp.asarray(b.numpy()), max_iters=3)
    assert k2 == int(kj) == 3
    # a zero right-hand side runs no iteration
    x3, k3, r3 = tdia.dia_pcg_solve(v, dia.offsets, dia.diag_idx, torch.zeros_like(b))
    assert k3 == 0 and float(r3) == 0.0 and not x3.any()
