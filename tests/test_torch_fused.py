"""The port's coordinates-to-DIA assembly (P3 and its routes) against
femcy_tpu's.

- ``isotropic_lame`` against the JAX package's;
- the isotropic 3-term prep against the generic B^T C B prep;
- ``fused_assemble_plain`` (P3's plain version) against the f64 analytic
  operator and against JAX's fused Pallas kernel, run in interpret mode;
- P3's brick rule, pre-decoded column table and sum order, emulated in
  numpy, against the plain version (the CUDA kernel itself runs only on
  the card, in chip_smoke.py);
- the Kuhn tables compiled into the kernel, read from its source, against
  the host's;
- the routes of ``structured_assemble_coords`` and the wrapper's checks.

Tolerances: float64 results agree to 1e-12 relative to the largest entry
(the same arithmetic in another order, f64 roundoff ~1e-16 per operation).
JAX's fused kernel runs in float32 only; against it the port's float32
plain version is held to 1e-5 of the largest entry (f32 roundoff ~6e-8,
grown by the sums of up to 24 element entries).
"""

import dataclasses
import itertools
import pathlib
import re

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
    """numpy re-statement of csrc/structured_fused.cu, brick by brick: each
    4^3-node brick's 5^3 cells with the gradients and volume of all six
    tets (closed-form cofactors), then, for each row i and over the brick's
    nodes at once, the 45 sums of (neighbour slot, dof j) in the kernel's
    order -- orientation by orientation, the node's own block summed over
    the corners a first -- written to the pre-decoded DIA columns."""
    table, plan = fp.table, fp.plan
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    B, C = 4, 5
    x = coords.numpy().reshape(nx + 1, ny + 1, nz + 1, 3)
    kuhn = [[kfused.corner_delta(c) for c in t] for t in kfused.KUHN]
    self_slot = kfused.slot_of((0, 0, 0), (0, 0, 0))
    out = np.full((nx + 1 + B, ny + 1 + B, nz + 1 + B, 3, K), np.nan)
    lam, mu = fp.lam, fp.mu
    for x0, y0, z0 in itertools.product(range(0, nx + 1, B),
                                        range(0, ny + 1, B),
                                        range(0, nz + 1, B)):
        g = np.zeros((6, C, C, C, 4, 3))
        vol = np.zeros((6, C, C, C))
        for cx, cy, cz in itertools.product(range(C), repeat=3):
            gx, gy, gz = x0 - 1 + cx, y0 - 1 + cy, z0 - 1 + cz
            if not (0 <= gx < nx and 0 <= gy < ny and 0 <= gz < nz):
                continue
            for o in range(6):
                xs = np.array([x[gx + d[0], gy + d[1], gz + d[2]]
                               for d in kuhn[o]])  # (4, 3) corner coordinates
                J = xs.T @ fp.dN0  # J[D, d]
                cof = np.array([[J[(D + 1) % 3, (d + 1) % 3] * J[(D + 2) % 3, (d + 2) % 3]
                                 - J[(D + 1) % 3, (d + 2) % 3] * J[(D + 2) % 3, (d + 1) % 3]
                                 for d in range(3)] for D in range(3)])
                det = J[0] @ cof[0]
                g[o, cx, cy, cz] = (fp.dN0 @ cof.T) * (1.0 / det)
                vol[o, cx, cy, cz] = det * fp.w0
        for i in range(3):
            acc = np.zeros((45, B, B, B))
            for o in range(6):
                own = np.zeros((3, B, B, B))
                for a in range(4):
                    d = kuhn[o][a]  # the node is corner a of the cell at -d
                    cells = (o, slice(1 - d[0], 1 - d[0] + B),
                             slice(1 - d[1], 1 - d[1] + B),
                             slice(1 - d[2], 1 - d[2] + B))
                    gc, v = g[cells], vol[cells]  # (B, B, B, 4, 3), (B, B, B)
                    la = lam * v * gc[..., a, i]
                    ma = [mu * v * gc[..., a, dd] for dd in range(3)]
                    for b in range(4):
                        gb = gc[..., b, :]
                        gm = ma[0] * gb[..., 0] + ma[1] * gb[..., 1] + ma[2] * gb[..., 2]
                        for j in range(3):
                            t = la * gb[..., j] + ma[j] * gb[..., i]
                            if j == i:
                                t = t + gm
                            if b == a:
                                own[j] += t
                            else:
                                acc[3 * kfused.slot_of(d, kuhn[o][b]) + j] += t
                for j in range(3):
                    acc[3 * self_slot + j] += own[j]
            out[x0:x0 + B, y0:y0 + B, z0:z0 + B, i] = 0.0  # unreached columns
            for s in range(45):
                out[x0:x0 + B, y0:y0 + B, z0:z0 + B, i, table.colk[i, s]] = acc[s]
    return out[:nx + 1, :ny + 1, :nz + 1].reshape(-1, K)


@pytest.mark.parametrize("dims", BOXES + [(9, 7, 5), (4, 3, 6)])
def test_fused_table_and_kernel_rule(dims):
    tm, td, plan = _setup(dims)
    fp = kfused.build_fused_plan(tm, plan, MAT.C)
    table = fp.table
    K = td.n_offsets
    assert table is plan.fused_table  # built once per plan
    assert table.n_cols == 3 * K
    assert table.colk.shape == (3, 45) and table.colk.dtype == np.int32
    # each row's 45 entries reach distinct columns, exactly the plan's
    for i in range(3):
        assert len(set(table.colk[i])) == 45
        assert set(table.colk[i]) == {k for (ii, k) in plan.groups if ii == i}
    coords = _t(tm.nodes + 0.01 * np.random.default_rng(4).standard_normal(
        tm.nodes.shape))
    ref = fused_assemble_plain(coords, tm, fp.lam, fp.mu, plan).numpy()
    assert _rel(_emulate_kernel(coords, fp), ref) < TOL


def test_kernel_source_stencil_matches_table():
    """The kernel's kuhn() and slot_of() (csrc/structured_fused.cu),
    read from the source, are KUHN and SLOTS27, from which FusedTable
    builds the column table the kernel indexes: the host's slot order and
    the kernel's registers agree."""
    src = (pathlib.Path(kfused.__file__).parent.parent / "csrc"
           / "structured_fused.cu").read_text()
    kuhn_fn = re.search(r"int kuhn\(int o, int a\) \{(.*?)\n\}", src, re.S)
    words = [int(w, 8) for w in re.findall(r"\b0[0-7]{4}\b", kuhn_fn.group(1))]
    assert tuple(tuple((w >> (3 * a)) & 7 for a in range(4))
                 for w in words) == kfused.KUHN
    slot_fn = re.search(r"int slot_of\(int ca, int cb\) \{(.*?)\n\}", src, re.S)
    ladder = [(int(v), int(s)) for v, s in
              re.findall(r"v == (\d+)\s*\?\s*(\d+)", slot_fn.group(1))]
    assert [s for _, s in ladder] == list(range(len(kfused.SLOTS27)))
    assert tuple(v for v, _ in ladder) == kfused.SLOTS27


def test_fused_table_needs_the_kuhn_box():
    """The kernel compiles in meshgen.box_tets' Kuhn subdivision: a box
    whose cells are cut otherwise is refused when the table is built."""
    tm, td, _ = _setup((3, 2, 2))
    info = dict(tm.structure)
    info["kuhn"] = info["kuhn"][1:] + info["kuhn"][:1]  # tets renumbered
    other = dataclasses.replace(tm, structure=info)
    with pytest.raises(ValueError, match="Kuhn"):
        kfused.FusedTable(build_structured_plan(other, td))


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
    assert fp.table.colk.dtype == np.int32 and fp.table.colk.flags.c_contiguous
    # the two-stage pieces it replaces give the same operator
    planes = stiffness_planes(coords, tm, _t(tm.element.dshape_at_gp),
                              _t(tm.element.gauss_weights), None,
                              lame=(fp.lam, fp.mu))
    assert torch.equal(accumulate_planes(planes, plan), out)
