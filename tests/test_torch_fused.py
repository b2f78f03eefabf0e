"""The port's coordinates-to-DIA assembly (P3 and its routes) against
femcy_tpu's.

- ``isotropic_lame`` against the JAX package's;
- the isotropic 3-term prep against the generic B^T C B prep;
- ``fused_assemble_plain`` (P3's plain version) against the f64 analytic
  operator and against JAX's fused Pallas kernel, run in interpret mode;
- P3's gather rule and sum order, emulated in numpy, against the plain
  version (the CUDA kernel itself runs only on the card, in chip_smoke.py);
- the routes of ``structured_assemble_coords`` and the wrapper's checks.

Tolerances: float64 results agree to 1e-12 relative to the largest entry
(the same arithmetic in another order, f64 roundoff ~1e-16 per operation).
JAX's fused kernel runs in float32 only; against it the port's float32
plain version is held to 1e-5 of the largest entry (f32 roundoff ~6e-8,
grown by the sums of up to 24 element entries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu.materials as jmat
from femcy_tpu.kernels.structured_fused import (
    build_fused_plan as j_build_fused_plan,
    isotropic_lame as j_isotropic_lame,
)
from femcy_tpu.meshgen import box_tets as j_box
from femcy_tpu.solvers.dia import build_structured_dia_pattern as j_pattern
from femcy_tpu.structured import (
    build_structured_plan as j_plan,
    structured_assemble_coords as j_assemble,
)

from femcy_tpu_torch import convert
from femcy_tpu_torch.kernels import structured_accumulate as kacc
from femcy_tpu_torch.kernels import structured_fused as kfused
from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
from femcy_tpu_torch.structured import (
    accumulate_planes,
    analytic_structured_dia_values,
    auto_accumulate,
    build_structured_plan,
    fused_assemble_plain,
    isotropic_lame,
    stiffness_planes,
    structured_assemble_coords,
)

TOL = 1e-12
BOXES = [(3, 4, 2), (4, 3, 5, 2.0, 1.5, 1.0)]
MAT = jmat.LinearIsotropic(1000.0, 0.3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _setup(dims):
    tm = convert.mesh_from(j_box(*dims))
    td = build_structured_dia_pattern(tm)
    return tm, td, build_structured_plan(tm, td)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _anisotropic():
    C = np.array(MAT.C)
    C[0, 0] *= 1.5  # transversely stiffer along x
    return C


@pytest.mark.parametrize(
    "C",
    [
        MAT.C,
        jmat.NeoHookean(0.4, 0.00025).C,
        _anisotropic(),
        jmat.LinearIsotropicPlaneStress(200.0, 0.25).C,
        np.zeros((6, 6)),
    ],
    ids=["isotropic", "neohookean", "anisotropic", "plane_stress", "zero"],
)
def test_isotropic_lame_matches_jax(C):
    assert isotropic_lame(C) == j_isotropic_lame(C)


@pytest.mark.parametrize("dims", BOXES)
def test_isotropic_planes_match_generic(dims):
    tm, _, _ = _setup(dims)
    rng = np.random.default_rng(2)
    coords = _t(tm.nodes + 0.02 * rng.standard_normal(tm.nodes.shape))
    dN, w = _t(tm.element.dshape_at_gp), _t(tm.element.gauss_weights)
    generic = stiffness_planes(coords, tm, dN, w, _t(MAT.C))
    iso = stiffness_planes(coords, tm, dN, w, None, lame=isotropic_lame(MAT.C))
    assert _rel(iso, generic) < TOL


@pytest.mark.parametrize("dims", BOXES)
def test_fused_plain_matches_analytic(dims):
    tm, td, plan = _setup(dims)
    out = fused_assemble_plain(_t(tm.nodes), tm, *isotropic_lame(MAT.C), plan)
    oracle = analytic_structured_dia_values(tm, MAT.C, td)
    assert out.shape == oracle.shape == (tm.n_dof, td.n_offsets)
    assert _rel(out, oracle) < TOL


def test_fused_matches_jax_pallas_interpret():
    """One call of JAX's fused Pallas kernel (interpret mode, f32): the
    port's float32 plain version agrees to 1e-5 of the largest entry, and
    P3's table holds the same rows and corner shifts as JAX's plan."""
    dims = (4, 3, 5)
    jm = j_box(*dims)
    jp = j_plan(jm, j_pattern(jm))
    ref = np.asarray(j_assemble(
        jnp.asarray(jm.nodes, jnp.float32), jm,
        jnp.asarray(jm.element.dshape_at_gp, jnp.float32),
        jnp.asarray(jm.element.gauss_weights, jnp.float32),
        jnp.asarray(MAT.C, jnp.float32), jp, accumulate="fused", C_host=MAT.C,
    ))
    tm, _, plan = _setup(dims)
    out = fused_assemble_plain(_t(tm.nodes, torch.float32), tm,
                               *isotropic_lame(MAT.C), plan)
    assert out.dtype == torch.float32
    assert _rel(out, ref) < 1e-5

    jfp = j_build_fused_plan(jp, MAT.C, jm.element, interpret=True)
    table = plan.fused_table
    np.testing.assert_array_equal(table.rows, np.asarray(jfp.rows))
    np.testing.assert_array_equal(table.shift[..., 0],
                                  np.asarray(jfp.ashift)[..., 0])


def _emulate_kernel(coords, fp):
    """numpy re-statement of csrc/structured_fused.cu, block by block: the
    32-node tile, the four 33-slot cell windows staged one orientation at a
    time (closed-form cofactors), and the per-(orientation, column) sums
    added into the tile in CSR order."""
    table, plan = fp.table, fp.plan
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    sy = nz + 1
    sx = (ny + 1) * sy
    n_nodes, n_cols = (nx + 1) * sx, table.n_cols
    T, W = 32, 33
    x = coords.numpy()
    lane = np.arange(T)
    out = np.zeros((n_nodes, n_cols))
    for node0 in range(0, n_nodes, T):
        tile = np.zeros((T, n_cols))
        for o in range(6):
            grad = np.zeros((13, 4 * W))
            for s in range(4 * W):
                w = s // W
                m = node0 - (w >> 1) * sx - (w & 1) * sy - 1 + (s - w * W)
                if not 0 <= m < n_nodes:
                    continue
                cx, rem = divmod(m, sx)
                cy, cz = divmod(rem, sy)
                if cx >= nx or cy >= ny or cz >= nz:
                    continue
                xs = x[m + table.corner_off[o]]  # (4, 3) corner coordinates
                J = xs.T @ fp.dN0  # dxdn[D, d]
                cof = np.array([[J[(D + 1) % 3, (d + 1) % 3] * J[(D + 2) % 3, (d + 2) % 3]
                                 - J[(D + 1) % 3, (d + 2) % 3] * J[(D + 2) % 3, (d + 1) % 3]
                                 for d in range(3)] for D in range(3)])
                det = J[0] @ cof[0]
                grad[:12, s] = ((fp.dN0 @ cof.T) * (1.0 / det)).ravel()
                grad[12, s] = det * fp.w0
            for c in range(n_cols):
                lo, hi = table.col_start[o * n_cols + c: o * n_cols + c + 2]
                if lo == hi:
                    continue
                acc = np.zeros(T)
                for p, q, w, dz in table.entries[lo:hi]:
                    a, i = divmod(p, 3)
                    b, j = divmod(q, 3)
                    s = w * W + lane + 1 - dz
                    ga, gb = grad[3 * a:3 * a + 3, s], grad[3 * b:3 * b + 3, s]
                    term = fp.lam * (ga[i] * gb[j]) + fp.mu * (ga[j] * gb[i])
                    if i == j:
                        term = term + fp.mu * (ga * gb).sum(0)
                    acc = acc + term * grad[12, s]
                tile[:, c] += acc
        rows = min(T, n_nodes - node0)
        out[node0:node0 + rows] = tile[:rows]
    return out.reshape(-1, K)


@pytest.mark.parametrize("dims", BOXES)
def test_fused_table_and_kernel_rule(dims):
    tm, td, plan = _setup(dims)
    fp = kfused.build_fused_plan(tm, plan, MAT.C)
    table = fp.table
    K = td.n_offsets
    assert table is plan.fused_table  # built once per plan
    assert table.n_cols == 3 * K
    assert table.col_start.shape == (6 * 3 * K + 1,)
    assert table.col_start[-1] == 864 and (np.diff(table.col_start) >= 0).all()
    assert table.entries.shape == (864, 4) and table.entries.dtype == np.int32
    coords = _t(tm.nodes + 0.01 * np.random.default_rng(4).standard_normal(
        tm.nodes.shape))
    ref = fused_assemble_plain(coords, tm, fp.lam, fp.mu, plan).numpy()
    assert _rel(_emulate_kernel(coords, fp), ref) < TOL


def test_routes(monkeypatch):
    """Each mode goes where it should; a forced "fused" with a
    non-isotropic tangent raises; the default route by device."""
    tm, td, plan = _setup((3, 2, 2))
    args = (_t(tm.nodes), tm, _t(tm.element.dshape_at_gp),
            _t(tm.element.gauss_weights), _t(MAT.C), plan)
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(kfused, "fused_assemble",
                        spy("fused", kfused.fused_assemble))
    monkeypatch.setattr(kacc, "accumulate", spy("pallas", kacc.accumulate))
    oracle = analytic_structured_dia_values(tm, MAT.C, td)
    for mode, expect in ((None, []), ("xla", []), ("fused", ["fused"]),
                         ("pallas", ["pallas"])):
        calls.clear()
        out = structured_assemble_coords(*args, accumulate=mode, C_host=MAT.C)
        assert calls == expect, mode
        assert _rel(out, oracle) < TOL, mode
    with pytest.raises(ValueError, match="fused"):
        structured_assemble_coords(*args, accumulate="fused",
                                   C_host=_anisotropic())
    with pytest.raises(ValueError, match="fused"):
        structured_assemble_coords(*args, accumulate="fused")
    with pytest.raises(ValueError):
        structured_assemble_coords(*args, accumulate="interpret")
    # "pallas" with an anisotropic tangent takes the generic prep
    C = _anisotropic()
    calls.clear()
    out = structured_assemble_coords(*args[:4], _t(C), plan,
                                     accumulate="pallas", C_host=C)
    assert calls == ["pallas"]
    assert _rel(out, analytic_structured_dia_values(tm, C, td)) < TOL

    lame = isotropic_lame(MAT.C)
    assert auto_accumulate("cuda", lame, 1) == "fused"
    assert auto_accumulate("cuda:0", None, 1) == "pallas"
    assert auto_accumulate("cuda", lame, 4) == "pallas"
    assert auto_accumulate("cpu", lame, 1) == "xla"


def test_fused_wrapper_cpu_and_checks():
    tm, _, plan = _setup((3, 2, 2))
    fp = kfused.build_fused_plan(tm, plan, MAT.C)
    assert kfused.build_fused_plan(tm, plan, _anisotropic()) is None
    assert kfused.build_fused_plan(tm, plan, None) is None
    coords = _t(tm.nodes)
    before = kfused.fused_assemble.launches
    out = kfused.fused_assemble(coords, fp)
    assert torch.equal(out, fused_assemble_plain(coords, tm, fp.lam, fp.mu, plan))
    assert kfused.fused_assemble.launches == before  # the plain version ran
    assert kfused.fused_assemble(coords.float(), fp).dtype == torch.float32
    with pytest.raises(ValueError):
        kfused.fused_assemble(coords[:-1], fp)
    with pytest.raises(ValueError):
        kfused.fused_assemble(coords.t().contiguous().t(), fp)
    with pytest.raises(TypeError):
        kfused.fused_assemble(coords.to(torch.int64), fp)
    with pytest.raises(ValueError, match="unsupported device"):
        kfused.fused_assemble(coords.to("meta"), fp)
    col_start, entries = fp.table.on("cpu")
    assert col_start.dtype == entries.dtype == torch.int32
    # the two-stage pieces it replaces give the same operator
    planes = stiffness_planes(coords, tm, _t(tm.element.dshape_at_gp),
                              _t(tm.element.gauss_weights), None,
                              lame=(fp.lam, fp.mu))
    assert torch.equal(accumulate_planes(planes, plan), out)
