"""The small-model dense CG (``SolverConfig.dense_operator_max_dof``) of
femcy_tpu_torch against femcy_tpu's, on the CPU, in float64.

- ``ell_to_dense`` and ``dia_to_dense_device``: bit-equal to femcy_tpu's,
  on a pattern whose row 0 holds a true nonzero (0, 0) entry beside its
  padding slots (padding points at column 0 with value 0), and on DIA
  slots clipped onto columns 0 and n - 1;
- ``dense_pcg_solve``, Jacobi and node-block Jacobi (block_dm 3, with a
  node that no element names, whose empty block takes the identity): the
  same iterations as femcy_tpu's, x within 1e-10 relative (max |x|) at
  eps 1e-10;
- ``FEMSystem`` with ``dense_operator_max_dof`` on the ELL, box-DIA and
  general-DIA layouts, and ``MultiBlockSystem``'s dense branch: the same
  iterations as femcy_tpu's dense CG and dof within 1e-10 relative at
  cg_eps 1e-8.  At 1e-10 the two packages' stops land one iteration apart
  on the ELL mesh on the sparse path as on the dense one (64 against 63:
  their operators and products differ by roundoff; ROADMAP.md section 3),
  so the counts are compared where both stop on the same iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu import multiblock as jmb
from femcy_tpu import structured as jstr
from femcy_tpu.io.inp import DirichletBC, InpModel
from femcy_tpu.solvers import cg as jcg
from femcy_tpu.solvers.dia import build_structured_dia_pattern as j_dia_pattern
from femcy_tpu.topology import build_pattern as j_build_pattern

import femcy_tpu_torch as T
from femcy_tpu_torch import convert
from femcy_tpu_torch import multiblock as tmb
from femcy_tpu_torch import structured as tstr
from femcy_tpu_torch.solvers import cg as tcg

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ell(nx=3):
    """The ELL pattern of unstructured_box_tets(nx) and seeded values, 0
    in the padding slots."""
    pattern = j_build_pattern(F.meshgen.unstructured_box_tets(nx))
    colidx = np.asarray(pattern.colidx)
    valid = np.asarray(pattern.valid)
    values = np.random.default_rng(0).standard_normal(colidx.shape) * valid
    return values, colidx, valid


def test_ell_to_dense_bit_equal_with_padding_at_column_0():
    values, colidx, valid = _ell()
    n = values.shape[0]
    # rows whose true (r, 0) entry is nonzero and which carry padding: a
    # plain indexed write could let a padding zero overwrite that entry
    row0 = [r for r in range(n)
            if (~valid[r]).any() and (valid[r] & (colidx[r] == 0)).any()]
    assert row0 and values[row0[0], colidx[row0[0]] == 0][0] != 0.0
    want = np.asarray(jcg.ell_to_dense(jnp.asarray(values),
                                       jnp.asarray(colidx), n))
    got = tcg.ell_to_dense(_t(values), _t(colidx, torch.int64), n).numpy()
    assert np.array_equal(got, want)
    assert all(got[r, 0] == values[r][valid[r] & (colidx[r] == 0)][0]
               for r in row0)


def test_dia_to_dense_bit_equal():
    mesh = F.meshgen.box_tets(3, 2, 2)
    dia = j_dia_pattern(mesh)
    values = np.random.default_rng(1).standard_normal(
        (dia.n_dof, dia.n_offsets))
    want = np.asarray(jstr.dia_to_dense_device(jnp.asarray(values),
                                               dia.offsets))
    got = tstr.dia_to_dense_device(_t(values), dia.offsets).numpy()
    assert np.array_equal(got, want)
    # the clipped slots landed on columns 0 and n - 1 and added nothing
    assert got[0, 0] == values[0, dia.diag_idx]
    assert got[-1, -1] == values[-1, dia.diag_idx]


def _spd(n_nodes=20, dm=3, seed=2):
    """A seeded SPD operator over n_nodes nodes of dm dofs, the last
    node's rows and columns zero (a node no element names), and a b that
    is 0 there."""
    rng = np.random.default_rng(seed)
    n = n_nodes * dm
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + 4.0 * np.eye(n)
    A[-dm:, :] = 0.0
    A[:, -dm:] = 0.0
    b = rng.standard_normal(n)
    b[-dm:] = 0.0
    return A, b


@pytest.mark.parametrize("block_dm", [0, 3])
def test_dense_pcg_matches_jax(block_dm):
    A, b = _spd()
    xj, kj, rj = jcg.dense_pcg_solve(jnp.asarray(A), jnp.asarray(b),
                                     eps=1e-10, block_dm=block_dm)
    xt, kt, rt = tcg.dense_pcg_solve(_t(A), _t(b), eps=1e-10,
                                     block_dm=block_dm)
    assert kt == int(kj) > 0
    assert _rel(xt, xj) < TOL
    assert np.isfinite(xt.numpy()).all() and not xt[-3:].any()


def _linear_inp(mesh, ux=0.01):
    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, ux))
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=False,
        time_incs=dict(ini_inc=1.0, max_time=1.0, min_inc=1e-5,
                       max_inc=1.0))


@pytest.mark.parametrize("layout, precond", [
    ("ell", "jacobi"), ("box dia", "jacobi"), ("box dia", "block_jacobi"),
    ("general dia", "jacobi")])
def test_femsystem_dense_cg_matches_jax(layout, precond):
    if layout == "ell":
        jm = F.meshgen.unstructured_box_tets(3)
    elif layout == "box dia":
        jm = F.meshgen.box_tets(3, 3, 2)
    else:
        jm = F.meshgen.box_hexes(3, 2, 2)
    cfg = dict(linear_solver="cg", cg_eps=1e-8, dense_operator_max_dof=4096,
               preconditioner=precond)
    inp = _linear_inp(jm)
    mat = F.LinearIsotropic(1000.0, 0.3)
    js = F.FEMSystem(jm, mat, False, F.SolverConfig(**cfg))
    assert js.solve(inp).success
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat), False,
                     T.SolverConfig(**cfg), device="cpu")
    assert ts.solve(convert.inp_from(inp)).success
    assert ts._use_dense_cg and (ts.dia is None) == (layout == "ell")
    assert (js.dia is None) == (ts.dia is None)
    assert ts._last_cg_iters == js._last_cg_iters > 0
    assert _rel(ts.dof, js.dof) < TOL


def test_multiblock_dense_cg_matches_jax():
    mesh = F.meshgen.unstructured_box_tets(3)
    low = mesh.nodes[mesh.elements].mean(axis=1)[:, 2] < 0.5
    jblocks = [
        jmb.ElementBlock(mesh.elements[low], mesh.element,
                         F.LinearIsotropic(100.0, 0.3), "soft"),
        jmb.ElementBlock(mesh.elements[~low], mesh.element,
                         F.LinearIsotropic(300.0, 0.3), "stiff")]
    cfg = dict(linear_solver="cg", cg_eps=1e-8, dense_operator_max_dof=4096)
    js = jmb.MultiBlockSystem(mesh.nodes, jblocks, F.SolverConfig(**cfg))
    ts = tmb.MultiBlockSystem(mesh.nodes, convert.blocks_from(js),
                              T.SolverConfig(**cfg), device="cpu")
    fixed = np.zeros(mesh.n_dof, bool)
    for d in range(3):
        fixed[np.nonzero(mesh.nodes[:, 2] < 1e-9)[0] * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    rhs[np.nonzero(mesh.nodes[:, 2] > 1 - 1e-9)[0] * 3] = 1.0
    sval = np.zeros(mesh.n_dof)
    xj = np.asarray(js.solve(rhs, fixed, sval))
    values, b = js._jit_system(js._arrs, jnp.asarray(rhs), jnp.asarray(fixed),
                               jnp.asarray(sval))
    _, j_iters, _ = js._jit_dense_cg(values, b, js._arrs["colidx"])
    xt = ts.solve(rhs, fixed, sval)
    assert ts._cg_iters_log == [int(j_iters)] and int(j_iters) > 0
    assert _rel(xt, xj) < TOL
