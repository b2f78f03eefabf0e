"""The algebraic-multigrid path of femcy_tpu_torch against femcy_tpu's, on
the CPU: the block-ELL format (solvers/bell.py) and its SpMV wrapper
(kernels/bell_spmv.py, M3), the smoothed-aggregation hierarchy and V-cycle
(solvers/amg.py), and ``preconditioner="amg"`` through FEMSystem (linear
and Newton) and the CLI.

Inputs are made with numpy from a seed (or assembled by femcy_tpu) and
handed to both packages.  Tolerances, float64:
- the block plan, node graph, block values and CSR conversions: equal;
- the block SpMV: 1e-13 relative to max|y| (the same products summed in
  another order);
- the hierarchy built from one host operator: bit-equal, every level
  array compared as bf16, and the coarsest inverse (the same numpy and
  scipy code on the same input);
- one V-cycle on the same hierarchy: 1e-12 relative (dense and sparse
  products summed in another order);
- the PCG: the same iteration count (or one apart, the CG parity limit of
  ROADMAP.md section 3), x within 1e-5 of the scipy direct solve;
- FEMSystem and the CLI: dof within 1e-6 relative and equal iteration
  counts, the Newton history equal.  Each package builds its hierarchy
  from its own operator rounded to bf16, so these are not bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import femcy_tpu as F
from femcy_tpu import assembly as jasm
from femcy_tpu import bc as jbc
from femcy_tpu import cli as jcli
from femcy_tpu import user as juser
from femcy_tpu.io.inp import DirichletBC, InpModel
from femcy_tpu.solvers import bell as jbell
from femcy_tpu.solvers.amg import AlgebraicMultigrid as JAMG
from femcy_tpu.solvers.cg import ell_spmv as j_ell_spmv
from femcy_tpu.topology import build_pattern as j_build_pattern

import femcy_tpu_torch as T
from femcy_tpu_torch import cli as tcli
from femcy_tpu_torch import convert
from femcy_tpu_torch import user as tuser
from femcy_tpu_torch.kernels import bell_spmv as kb
from femcy_tpu_torch.solvers import bell as tbell
from femcy_tpu_torch.solvers.amg import AlgebraicMultigrid as TAMG
from femcy_tpu_torch.solvers.cg import ell_spmv as t_ell_spmv
from femcy_tpu_torch.topology import build_pattern as t_build_pattern

MAT = F.LinearIsotropic(1000.0, 0.3)
SETUP_KEYS = {"prep", "lmax", "bell", "aggregate", "qr", "rap", "coarse_inv",
              "tobsr", "upload", "other", "total"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _bf16_bits(a):
    """float64 -> bf16 through torch, as float32 numpy (exact), so both
    packages get the same bf16 values."""
    return torch.as_tensor(np.array(a)).to(torch.bfloat16).float().numpy()


# --------------------------------------------------------------------------- #
# operators
# --------------------------------------------------------------------------- #
def _operator(mesh):
    """tests/test_amg.py's operator, rebuilt: the BC-eliminated ELL
    operator of femcy_tpu's assembly, z=0 clamped, a unit x-load on the
    top face.  Returns (pattern, values_bc, b, fixed) as numpy."""
    pattern = j_build_pattern(mesh)
    dsdx, vol = jasm.gradients_and_volume(
        jnp.asarray(mesh.nodes), jnp.asarray(mesh.elements),
        jnp.asarray(mesh.element.dshape_at_gp),
        jnp.asarray(mesh.element.gauss_weights))
    Ke = jasm.element_stiffness(dsdx, vol, jnp.asarray(MAT.C))
    values = jasm.scatter_stiffness(
        Ke, jnp.asarray(pattern.ensure_scatter_targets()), mesh.n_dof,
        pattern.width)
    fixed = np.zeros(mesh.n_dof, dtype=bool)
    bot = np.nonzero(mesh.nodes[:, 2] < 1e-9)[0]
    for d in range(3):
        fixed[bot * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    top = np.nonzero(mesh.nodes[:, 2] > mesh.nodes[:, 2].max() - 1e-9)[0]
    rhs[top * 3] = 1.0
    values_bc, b = jbc.apply_dirichlet_linear(
        values, jnp.asarray(pattern.colidx), jnp.asarray(pattern.diag_slot),
        jnp.asarray(rhs), jnp.asarray(fixed), jnp.zeros(mesh.n_dof))
    return pattern, np.asarray(values_bc), np.asarray(b), fixed


_OPERATORS = {}


def _cached_operator(name):
    if name not in _OPERATORS:
        mesh = {"uniform6": lambda: F.meshgen.unstructured_box_tets(6),
                "uniform10": lambda: F.meshgen.unstructured_box_tets(10),
                "graded10": lambda: F.meshgen.graded_box_tets(10, ratio=12.0),
                "uniform5": lambda: F.meshgen.unstructured_box_tets(5)}[name]()
        _OPERATORS[name] = (mesh, *_operator(mesh))
    return _OPERATORS[name]


def _both(name, **kw):
    """The same host operator into both AlgebraicMultigrid classes."""
    mesh, pattern, values, b, fixed = _cached_operator(name)
    A = pattern.to_scipy(values)
    j = JAMG(A, mesh.dm, mesh.nodes, fixed, **kw)
    t = TAMG(A, mesh.dm, mesh.nodes, fixed, device="cpu", **kw)
    return mesh, pattern, values, b, fixed, j, t


def _fine_applies(pattern, values):
    colidx = jnp.asarray(pattern.colidx)
    vj = jnp.asarray(values)
    vt, ct = _t(values), torch.as_tensor(pattern.colidx.astype(np.int64))
    return (lambda x: j_ell_spmv(vj, colidx, x),
            lambda x: t_ell_spmv(vt, ct, x))


def _direct(pattern, values, b):
    A = pattern.to_scipy(values.astype(np.float64))
    return spla.spsolve(A.tocsc(), b.astype(np.float64))


# --------------------------------------------------------------------------- #
# block-ELL (solvers/bell.py)
# --------------------------------------------------------------------------- #
BELL_MESHES = {"tet4": lambda: F.meshgen.unstructured_box_tets(6),
               "tri3": lambda: F.meshgen.rect_tris(6, 5)}


def _bell_case(name):
    jm = BELL_MESHES[name]()
    jp = j_build_pattern(jm)
    tp = t_build_pattern(convert.mesh_from(jm))
    rng = np.random.default_rng(3)
    values = np.where(jp.valid, rng.standard_normal(jp.valid.shape), 0.0)
    return jm, jp, tp, values


@pytest.mark.parametrize("name", list(BELL_MESHES))
def test_bell_plan_graph_and_conversions_match_jax(name):
    jm, jp, tp, values = _bell_case(name)
    jplan = jbell.build_bell_plan(jp, jm.dm)
    tplan = tbell.build_bell_plan(tp, jm.dm)
    assert (tplan.n_nodes, tplan.dm, tplan.width) == (
        jplan.n_nodes, jplan.dm, jplan.width)
    assert np.array_equal(tplan.ncol, jplan.ncol)
    assert np.array_equal(tplan.valid, jplan.valid)
    assert tplan.ncol.dtype == np.int32
    assert dataclasses.astuple(convert.bell_plan_from(jplan))[:3] == (
        tplan.n_nodes, tplan.dm, tplan.width)
    assert np.array_equal(convert.bell_plan_from(jplan).ncol, tplan.ncol)

    fixed = np.zeros(jm.n_dof, bool)
    low = np.nonzero(jm.nodes[:, jm.dm - 1] < 1e-9)[0]
    fixed[(low[:, None] * jm.dm + np.arange(jm.dm)).ravel()] = True
    fixed[jm.dm * 7] = True  # one dof of one node: that node stays linked
    gj, gt = jbell.plan_node_graph(jplan, fixed), tbell.plan_node_graph(
        tplan, fixed)
    assert np.array_equal(gt.indptr, gj.indptr)
    assert np.array_equal(gt.indices, gj.indices)
    assert gt.nnz > 0 and gt[low[0]].nnz == 0

    bj = np.asarray(jbell.bell_from_ell(jnp.asarray(values), jplan))
    bt = tbell.bell_from_ell(_t(values), tplan)
    assert np.array_equal(bt.numpy(), bj)
    assert not bt.numpy()[~tplan.valid].any()

    A = jp.to_scipy(values)
    vj, cj = jbell.csr_to_bell(A, jm.dm, jm.dm)
    vt, ct = tbell.csr_to_bell(A, jm.dm, jm.dm)
    assert np.array_equal(vt, vj) and np.array_equal(ct, cj)
    # rectangular: a prolongator-shaped (n_dof, nb * m) operator
    nb = 6 if jm.dm == 3 else 3
    R = sp.random(jm.n_dof, nb * 9, density=0.05, random_state=4,
                  format="csr")
    vj, cj = jbell.csr_to_bell(R, jm.dm, nb)
    vt, ct = tbell.csr_to_bell(R, jm.dm, nb)
    assert np.array_equal(vt, vj) and np.array_equal(ct, cj)
    assert vt.shape[2:] == (jm.dm, nb)


@pytest.mark.parametrize("name", list(BELL_MESHES))
def test_bell_plan_rejects_a_scrambled_pattern(name):
    jm, jp, tp, _ = _bell_case(name)
    row = jm.dm * 5
    colidx = tp.colidx.copy()
    colidx[row, [0, 1]] = colidx[row, [1, 0]]
    with pytest.raises(ValueError, match="blockwise expansion"):
        tbell.build_bell_plan(dataclasses.replace(tp, colidx=colidx), jm.dm)
    with pytest.raises(ValueError, match="blockwise expansion"):
        jbell.build_bell_plan(dataclasses.replace(jp, colidx=colidx), jm.dm)
    counts = tp.row_counts.copy()
    counts[row + 1] -= jm.dm
    with pytest.raises(ValueError, match="disagree"):
        tbell.build_bell_plan(dataclasses.replace(tp, row_counts=counts), jm.dm)
    # a count that is no whole node block: caught before the expansion
    counts = tp.row_counts.copy()
    counts[row: row + jm.dm] -= 1
    with pytest.raises(ValueError, match="whole"):
        tbell.build_bell_plan(dataclasses.replace(tp, row_counts=counts), jm.dm)
    with pytest.raises(ValueError, match="not a multiple"):
        tbell.build_bell_plan(tp, jm.dm + 1 if tp.width % (jm.dm + 1) else 7)


def _spmv_operands(name, shape):
    """(bvalues, ncol, n_cols) of a square block operator (the plan's) or
    a rectangular one (csr_to_bell of a random prolongator shape)."""
    jm, jp, _, values = _bell_case(name)
    plan = jbell.build_bell_plan(jp, jm.dm)
    if shape == "square":
        return np.asarray(jbell.bell_from_ell(jnp.asarray(values), plan)), \
            plan.ncol, plan.n_nodes
    nb = 6 if jm.dm == 3 else 3
    R = sp.random(jm.n_dof, nb * 9, density=0.05, random_state=5,
                  format="csr")
    if shape == "wide":  # restriction-shaped: (nb * 9, n_dof)
        v, c = jbell.csr_to_bell(R.T.tocsr(), nb, jm.dm)
        return v, c, jm.n_nodes
    v, c = jbell.csr_to_bell(R, jm.dm, nb)
    return v, c, 9


@pytest.mark.parametrize("name", list(BELL_MESHES))
@pytest.mark.parametrize("shape", ["square", "tall", "wide"])
@pytest.mark.parametrize("vdtype", ["bfloat16", "float64"])
def test_bell_spmv_matches_jax(name, shape, vdtype):
    bv, ncol, n_cols = _spmv_operands(name, shape)
    if vdtype == "bfloat16":
        bv = _bf16_bits(bv)
    x = np.random.default_rng(6).standard_normal(n_cols * bv.shape[-1])
    jv = jnp.asarray(bv, jnp.bfloat16 if vdtype == "bfloat16" else jnp.float64)
    yj = np.asarray(jbell.bell_spmv(jv, jnp.asarray(ncol), jnp.asarray(x)))
    tv = _t(bv, getattr(torch, vdtype))
    yt = tbell.bell_spmv(tv, torch.as_tensor(ncol), _t(x))
    assert yt.dtype == torch.float64 and yt.shape == (bv.shape[0] * bv.shape[2],)
    assert _rel(yt, yj) <= 1e-13
    # the kernel wrapper on CPU tensors: the plain version on its operand
    op = kb.operand(tv, torch.as_tensor(ncol), n_cols)
    assert _rel(kb.spmv(op, _t(x)), yj) <= 1e-13


# --------------------------------------------------------------------------- #
# M3's wrapper and operand layout (kernels/bell_spmv.py)
# --------------------------------------------------------------------------- #
def _walk(op, x):
    """The kernel's indexing, restated in numpy: output row r = n*br + i
    sums values_t[k, j, r] * x[ncol_t[k, n]*bc + j] for k < counts[n], k
    then j."""
    vt = op.values_t.double().numpy()
    ncol_t, counts = op.ncol_t.numpy(), op.counts.numpy()
    K, bc, m = vt.shape
    y = np.zeros(m)
    for r in range(m):
        n = r // op.br
        acc = 0.0
        for k in range(counts[n]):
            for j in range(bc):
                acc += vt[k, j, r] * x[ncol_t[k, n] * bc + j]
        y[r] = acc
    return y


@pytest.mark.parametrize("name", list(BELL_MESHES))
def test_fine_operand_is_the_transposed_ell_values(name):
    """from_ell's operand is the transposed dof-ELL values with the plan's
    valid counts: garbage in the pad slots is masked as bell_from_ell
    masks it, and the kernel's indexing walks it to the plain result."""
    jm, _, tp, values = _bell_case(name)
    plan = tbell.build_bell_plan(tp, jm.dm)
    garbage = np.where(tp.valid, values, 7.0)
    fine = kb.fine_plan(plan, "cpu")
    op = kb.from_ell(fine, _t(garbage))
    assert op.values_t.shape == (plan.width, jm.dm, jm.n_dof)
    assert np.array_equal(op.counts.numpy(), plan.valid.sum(1))
    assert torch.equal(op.bvalues * _t(plan.valid)[:, :, None, None],
                       tbell.bell_from_ell(_t(garbage), plan))
    x = np.random.default_rng(7).standard_normal(jm.n_dof)
    want = tbell.bell_spmv(tbell.bell_from_ell(_t(values), plan),
                           torch.as_tensor(plan.ncol), _t(x)).numpy()
    assert _rel(kb.spmv(op, _t(x)), want) <= 1e-14
    assert _rel(_walk(op, x), want) <= 1e-13
    with pytest.raises(ValueError, match="values shape"):
        kb.from_ell(fine, _t(garbage[:-1]))


@pytest.mark.parametrize("shape", ["tall", "wide"])
def test_operand_counts_skip_only_zero_blocks(shape):
    bv, ncol, n_cols = _spmv_operands("tet4", shape)
    op = kb.operand(_t(bv), torch.as_tensor(ncol), n_cols)
    counts = op.counts.numpy()
    K = bv.shape[1]
    live = (np.abs(bv).reshape(*bv.shape[:2], -1).sum(2) > 0) | (ncol != 0)
    for n in range(bv.shape[0]):
        assert not live[n, counts[n]:].any()
        assert counts[n] == 0 or live[n, counts[n] - 1]
    assert counts.max() <= K and counts.min() < K  # the rows are ragged
    assert torch.equal(op.bvalues, _t(bv)) and torch.equal(
        op.ncol, torch.as_tensor(ncol, dtype=torch.int32))
    x = np.random.default_rng(8).standard_normal(n_cols * bv.shape[-1])
    want = np.asarray(jbell.bell_spmv(jnp.asarray(bv), jnp.asarray(ncol),
                                      jnp.asarray(x)))
    assert _rel(_walk(op, x), want) <= 1e-13


def test_bell_spmv_wrapper_rejects_bad_operands():
    bv, ncol, n_cols = _spmv_operands("tet4", "tall")
    op = kb.operand(_t(bv), torch.as_tensor(ncol), n_cols)
    x = torch.zeros(n_cols * bv.shape[-1], dtype=torch.float64)
    with pytest.raises(ValueError, match="disagree"):
        kb.spmv(op, x[:-1])
    with pytest.raises(ValueError, match="disagree"):
        kb.spmv(op, x.reshape(1, -1))
    with pytest.raises(TypeError, match="no wider than x"):
        kb.spmv(op, x.float())
    with pytest.raises(TypeError, match="no wider than x"):
        kb.spmv(op, x.long())
    with pytest.raises(TypeError, match="int32"):
        kb.spmv(dataclasses.replace(op, ncol_t=op.ncol_t.long()), x)
    with pytest.raises(ValueError, match="share a device"):
        kb.spmv(op, torch.zeros(x.shape[0], dtype=x.dtype, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        kb.spmv(dataclasses.replace(op, values_t=op.values_t.transpose(1, 2)
                                    .contiguous().transpose(1, 2)), x)
    with pytest.raises(ValueError, match="ncol shape"):
        kb.operand(_t(bv), torch.as_tensor(ncol[:-1]), n_cols)
    # bf16 and float32 blocks against float32 and float64 vectors
    for vdt, xdt in ((torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.float64),
                     (torch.float32, torch.float64)):
        o = kb.operand(_t(bv, vdt), torch.as_tensor(ncol), n_cols)
        y = kb.spmv(o, torch.ones(x.shape[0], dtype=xdt))
        assert y.dtype == xdt
    assert kb.spmv.launches == 0  # CPU tensors never launch the kernel


# --------------------------------------------------------------------------- #
# the hierarchy (solvers/amg.py)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name, kw", [
    ("uniform6", dict(coarse_max_dof=200)),
    ("uniform6", dict(coarse_max_dof=400)),
    ("graded10", dict(coarse_max_dof=400)),
    ("graded10", dict(coarse_max_dof=400, fine_strength_theta=0.12)),
])
def test_hierarchy_is_bit_equal_to_jax(name, kw):
    mesh, pattern, values, b, fixed, j, t = _both(name, **kw)
    assert t.n_levels == j.n_levels >= 2
    assert [(lv.n_dof, lv.bs, lv.lmax) for lv in t.levels] == [
        (lv.n_dof, lv.bs, lv.lmax) for lv in j.levels]
    assert t.complexity == j.complexity
    assert (t._single, t._coarse_smooth_only) == (j._single,
                                                  j._coarse_smooth_only)
    for lt, lj in zip(t.levels, j.levels):
        for attr in ("values", "inv_diag", "P_values", "R_values"):
            a, ref = getattr(lt, attr), getattr(lj, attr)
            assert (a is None) == (ref is None), attr
            if ref is not None:
                assert a.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
                assert np.array_equal(a.float().numpy(),
                                      np.asarray(ref, np.float32)), attr
        for attr in ("colidx", "P_colidx", "R_colidx"):
            a, ref = getattr(lt, attr), getattr(lj, attr)
            assert (a is None) == (ref is None), attr
            if ref is not None:
                assert np.array_equal(a.numpy(), np.asarray(ref)), attr
    assert t._coarse_inv.dtype == torch.float64
    assert np.array_equal(t._coarse_inv.numpy(), np.asarray(j._coarse_inv))
    assert set(t.setup_seconds) == set(j.setup_seconds) == SETUP_KEYS
    assert all(v >= 0.0 for k, v in t.setup_seconds.items() if k != "other")


def test_vcycle_matches_jax_and_contracts_energy_error():
    mesh, pattern, values, b, fixed, j, t = _both("uniform6",
                                                  coarse_max_dof=200)
    apply_j, apply_t = _fine_applies(pattern, values)
    r = np.random.default_rng(0).standard_normal(mesh.n_dof)
    zj = np.asarray(j.precondition(jnp.asarray(r), apply0=apply_j))
    port = convert.amg_from(j, device="cpu")
    assert [lv.n_dof for lv in port.levels] == [lv.n_dof for lv in j.levels]
    assert _rel(port.precondition(_t(r), apply0=apply_t), zj) <= 1e-12
    # the port's own hierarchy is the same arrays
    assert _rel(t.precondition(_t(r), apply0=apply_t), zj) <= 1e-12
    # test_amg_vcycle_contracts_energy_error's statement, on the port
    e = _t(np.random.default_rng(0).standard_normal(mesh.n_dof))
    e_new = e - t.precondition(apply_t(e), apply0=apply_t)

    def energy(v):
        return float(torch.dot(v, apply_t(v)))

    assert 0.0 <= energy(e_new) / energy(e) < 0.25
    with pytest.raises(ValueError, match="fine-operator apply"):
        t.precondition(_t(r))


@pytest.mark.parametrize("kw, single, smooth_only", [
    (dict(coarse_max_dof=1, max_levels=2), False, True),
    (dict(coarse_max_dof=10**6), True, False),
    (dict(coarse_max_dof=1, max_levels=1), True, True),
])
def test_single_and_smoother_only_branches_match_jax(kw, single, smooth_only):
    """The dense-inverse-only and smoother-only bottoms, mirroring
    test_amg_oversized_coarsest_falls_back_to_smoother."""
    mesh, pattern, values, b, fixed, j, t = _both("uniform5", **kw)
    assert (t._single, t._coarse_smooth_only) == (single, smooth_only) == (
        j._single, j._coarse_smooth_only)
    assert t._coarse_inv.numel() == (0 if smooth_only else mesh.n_dof ** 2
                                     if single else t._coarse_inv.numel())
    apply_j, apply_t = _fine_applies(pattern, values)
    r = np.random.default_rng(1).standard_normal(mesh.n_dof)
    zj = np.asarray(j.precondition(jnp.asarray(r), apply0=apply_j))
    assert _rel(t.precondition(_t(r), apply0=apply_t), zj) <= 1e-12
    x, iters, _ = t.pcg_solve(_t(b), apply_t, eps=1e-6)
    assert np.isfinite(x.numpy()).all()
    x_ref = _direct(pattern, values, b)
    assert _rel(x, x_ref) < 1e-4


@pytest.mark.parametrize("name", ["uniform6", "uniform10"])
def test_pcg_matches_jax_and_direct(name):
    mesh, pattern, values, b, fixed, j, t = _both(name, coarse_max_dof=400)
    apply_j, apply_t = _fine_applies(pattern, values)
    xj, kj, _ = j.pcg_solve(jnp.asarray(b), apply_j, eps=1e-8)
    xt, kt, rmax = t.pcg_solve(_t(b), apply_t, eps=1e-8)
    assert abs(kt - int(kj)) <= 1 and kt < 60
    x_ref = _direct(pattern, values, b)
    assert _rel(xt, x_ref) < 1e-5
    assert _rel(xt, xj) < 1e-6
    assert float(rmax) < 1e-8 * np.abs(b).max()
    # b = 0: no iteration, as femcy_tpu's rmax0 > 0 guard
    x0, k0, _ = t.pcg_solve(torch.zeros(mesh.n_dof, dtype=torch.float64),
                            apply_t, eps=1e-8)
    assert k0 == 0 and not x0.any()


def test_amg_defaults_to_the_card(monkeypatch):
    mesh, pattern, values, b, fixed = _cached_operator("uniform5")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        TAMG(pattern.to_scipy(values), 3, mesh.nodes, fixed)


# --------------------------------------------------------------------------- #
# FEMSystem with preconditioner="amg"
# --------------------------------------------------------------------------- #
def _model(mesh, nlgeom=False, ini_inc=1.0, max_time=1.0):
    """z=0 clamped; the top face pulled along x by 0.01 (linear) or
    turned about (0.5, 0.5) by ``*Boundary, user`` (nonlinear)."""
    z = mesh.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    if nlgeom:
        bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
    else:
        bcs.append(DirichletBC(top, 0, 0.01))
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=nlgeom,
        time_incs=dict(ini_inc=ini_inc, max_time=max_time, min_inc=1e-5,
                       max_inc=ini_inc),
    )


def _systems(jm, cfg, nlgeom=False):
    js = F.FEMSystem(jm, MAT, nlgeom, F.SolverConfig(**cfg))
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(MAT), nlgeom,
                     T.SolverConfig(**cfg), device="cpu")
    return js, ts


AMG_CG = dict(preconditioner="amg", linear_solver="cg", cg_eps=1e-8)


@pytest.mark.parametrize("name", ["uniform", "graded"])
def test_femsystem_amg_solve_matches_jax(name):
    if name == "uniform":
        jm, cfg = F.meshgen.unstructured_box_tets(6), AMG_CG
    else:
        jm = F.meshgen.graded_box_tets(10, ratio=12.0)
        cfg = dict(AMG_CG, amg_fine_theta=0.12)
    js, ts = _systems(jm, cfg)
    inp = _model(jm)
    jr, tr = js.solve(inp), ts.solve(convert.inp_from(inp))
    assert tr.success and jr.success
    assert ts.dia is None and ts._amg is not None
    assert [lv.n_dof for lv in ts._amg.levels] == [
        lv.n_dof for lv in js._amg.levels]
    assert ts._amg.n_levels >= (2 if jm.n_dof > 2400 else 1)
    assert ts._last_cg_iters == js._last_cg_iters > 0
    assert ts._cg_iters_log == [ts._last_cg_iters]
    assert _rel(ts.dof, js.dof) < 1e-6
    assert set(ts._amg_host_seconds) == {
        "fixed_key", "bell_plan", "pullback", "bsr", "fine_graph",
        "unattributed"}
    assert all(v >= 0.0 for v in ts._amg_host_seconds.values())
    for t_out, j_out in zip(ts.compute_strain_stress(),
                            js.compute_strain_stress()):
        assert _rel(t_out, j_out) < 1e-5


def test_femsystem_amg_forces_ell_on_a_banded_mesh():
    base = F.meshgen.box_tets(6, 6, 6)
    jm = F.FEMesh(base.nodes, base.elements, base.element)  # no structure
    js, ts = _systems(jm, AMG_CG)
    assert ts.dia is None and js.dia is None and ts.pattern is not None
    plain = T.FEMSystem(convert.mesh_from(jm), convert.material_from(MAT),
                        config=T.SolverConfig(), device="cpu")
    assert plain.dia is not None  # the detection would have fired
    mesh, pattern, values, b, fixed = (jm, *_operator(jm))
    x = ts._solve_linear_system(_t(values), _t(b), torch.from_numpy(fixed))
    assert np.isfinite(x.numpy()).all()
    assert _rel(x, _direct(pattern, values, b)) < 1e-5


def test_femsystem_amg_rejects_dia_and_the_structured_box():
    base = F.meshgen.box_tets(4, 4, 4)
    plain = convert.mesh_from(F.FEMesh(base.nodes, base.elements, base.element))
    mat = convert.material_from(MAT)
    with pytest.raises(ValueError, match="amg"):
        T.FEMSystem(plain, mat, config=T.SolverConfig(
            preconditioner="amg", sparse_format="dia"), device="cpu")
    with pytest.raises(ValueError, match="amg"):
        T.FEMSystem(convert.mesh_from(base), mat, config=T.SolverConfig(
            preconditioner="amg"), device="cpu")


def test_hierarchy_is_frozen_while_the_mask_holds():
    jm = F.meshgen.unstructured_box_tets(6)
    _, ts = _systems(jm, AMG_CG)
    mesh, pattern, values, b, fixed = (jm, *_operator(jm))
    ts._solve_linear_system(_t(values), _t(b), torch.from_numpy(fixed))
    first = ts._amg
    # another tensor with the same mask, and other values: no rebuild
    ts._solve_linear_system(_t(2.0 * values), _t(b),
                            torch.from_numpy(fixed.copy()))
    assert ts._amg is first and ts._cg_iters_log[0] == ts._cg_iters_log[1]
    fixed2 = fixed.copy()
    fixed2[np.nonzero(~fixed)[0][:3]] = True
    ts._solve_linear_system(_t(values), _t(b), torch.from_numpy(fixed2))
    assert ts._amg is not first
    assert "bell_plan" not in ts._amg_host_seconds  # the plan is kept


def test_host_twin_fallback_matches_jax():
    """Without ``values`` both build from the f64 host twin: the same
    hierarchy, and the twin's wall has its own key."""
    jm = F.meshgen.unstructured_box_tets(6)
    js, ts = _systems(jm, AMG_CG)
    fixed = _operator(jm)[3]
    js._ensure_amg(jnp.asarray(fixed))
    ts._ensure_amg(torch.from_numpy(fixed))
    for lt, lj in zip(ts._amg.levels, js._amg.levels):
        assert np.array_equal(lt.inv_diag.float().numpy(),
                              np.asarray(lj.inv_diag, np.float32))
        if lj.P_values is not None:
            assert np.array_equal(lt.P_values.float().numpy(),
                                  np.asarray(lj.P_values, np.float32))
    assert np.array_equal(ts._amg._coarse_inv.numpy(),
                          np.asarray(js._amg._coarse_inv))
    host = ts._amg_host_seconds
    assert "host_twin" in host and "pullback" not in host
    assert host["unattributed"] >= 0.0


def test_newton_with_amg_matches_jax():
    jm = F.meshgen.unstructured_box_tets(10)
    cfg = dict(AMG_CG)
    js, ts = _systems(jm, cfg, nlgeom=True)
    inp = _model(jm, nlgeom=True, ini_inc=0.004, max_time=0.012)
    jr = js.solve(inp, user_dirichlet=juser.make_rotation_dirichlet(
        (0.5, 0.5, 0.0)))
    builds = []
    orig = T.FEMSystem._ensure_amg

    def counting(self, fixed, values=None):
        before = self._amg
        orig(self, fixed, values)
        builds.append(self._amg is not before)

    ts._ensure_amg = counting.__get__(ts)
    tr = ts.solve(convert.inp_from(inp),
                  user_dirichlet=tuser.make_rotation_dirichlet((0.5, 0.5, 0.0)))
    assert tr.success and jr.success
    assert [(r.kinc, r.time, r.dt, r.newton_iters, r.converged)
            for r in tr.increments] == [
        (r.kinc, r.time, r.dt, r.newton_iters, r.converged)
        for r in jr.increments]
    assert len(tr.increments) == 3
    assert sum(builds) == 1 and len(builds) >= 3  # one frozen hierarchy
    assert ts._amg.n_levels >= 2
    assert _rel(ts.dof, js.dof) < 1e-6


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
def _inp_text(mesh):
    """``mesh`` as a C3D4 .inp: z=0 clamped, ux = 0.01 on z=max."""
    z = mesh.nodes[:, 2]
    lines = ["*Heading", "amg cli model", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(mesh.nodes)]
    lines.append("*Element, type=C3D4")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in conn)
              for e, conn in enumerate(mesh.elements)]
    for name, sel in (("fix", z < 1e-9), ("top", z > z.max() - 1e-9)):
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in np.nonzero(sel)[0])]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              "*Step, name=s, nlgeom=NO", "*Static", "1., 1., 1e-05, 1.",
              "*Boundary", "fix, 1, 1", "fix, 2, 2", "fix, 3, 3",
              "top, 1, 1, 0.01", "*End Step"]
    return "\n".join(lines) + "\n"


def test_cli_amg_matches_jax(tmp_path, capsys, monkeypatch):
    """The port's ``--preconditioner amg`` against femcy_tpu's CLI, whose
    parser has no "amg": its SolverConfig is made to take the AMG for the
    run, so both CLIs solve the same configuration."""
    path = tmp_path / "model.inp"
    path.write_text(_inp_text(F.meshgen.unstructured_box_tets(10)))
    common = [str(path), "--platform", "cpu", "--solver", "cg", "--cg-eps",
              "1e-8", "--stress", "0"]
    real = F.SolverConfig
    monkeypatch.setattr(F, "SolverConfig", lambda **kw: real(
        **{**kw, "preconditioner": "amg"}))
    assert jcli.main(common) == 0
    j_out = capsys.readouterr().out
    monkeypatch.setattr(F, "SolverConfig", real)
    assert tcli.main(common + ["--preconditioner", "amg"]) == 0
    t_out = capsys.readouterr().out
    t_lines, j_lines = t_out.splitlines(), j_out.splitlines()
    assert t_lines[0] == j_lines[0] and "converged in 1 increment" in t_out
    t_obs = dict(ln.rsplit(" = ", 1) for ln in t_lines if " = " in ln)
    j_obs = dict(ln.rsplit(" = ", 1) for ln in j_lines if " = " in ln)
    assert list(t_obs) == list(j_obs) and len(t_obs) >= 4
    for key, val in j_obs.items():
        assert abs(float(t_obs[key]) - float(val)) <= 1e-6 * abs(float(val))
