"""The port's general sparse layer against femcy_tpu's, on the CPU: the ELL
pattern (native and numpy routes), the general DIA pattern, the plain
scatters, the ELL Dirichlet elimination, the ELL SpMV and PCG, the host
operator, and the two kernel wrappers' CPU behaviour with numpy
emulations of the kernels (M1's row-band walk, M2 SpMV).

Tolerances: pattern arrays are integers and equal exactly.  Scatters sum
the same contributions in the same (element) order, so they agree with
femcy_tpu's segment-sum to 1e-15 relative, and the M1 row-band walk with
the plain version and with femcy_tpu's segment-sum exactly.  ELL SpMVs
sum a row in another order: 1e-13 relative to the largest entry.  PCG: equal iteration counts and x within
1e-10 relative (f64 dot products in another order move x by roundoff, far
below cg_eps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femcy_tpu import assembly as jasm
from femcy_tpu import assembly_host as jhost
from femcy_tpu import bc as jbc
from femcy_tpu import mesh as jmesh
from femcy_tpu import meshgen as jmg
from femcy_tpu.solvers import cg as jcg
from femcy_tpu.solvers import dia as jdia
from femcy_tpu.topology import build_pattern as j_build_pattern

from femcy_tpu_torch import assembly as tasm
from femcy_tpu_torch import assembly_host as thost
from femcy_tpu_torch import bc as tbc
from femcy_tpu_torch import convert
from femcy_tpu_torch.kernels import ell_scatter as kscat
from femcy_tpu_torch.materials import LinearIsotropic
from femcy_tpu_torch.kernels import ell_spmv as kspmv
from femcy_tpu_torch.native import loader
from femcy_tpu_torch.solvers import cg as tcg
from femcy_tpu_torch.solvers import dia as tdia
from femcy_tpu_torch.topology import ELLPattern, build_pattern

#: the PCG's default cg_eps; at tighter ones roundoff in the dot products
#: can move the stopping test by one iteration (42 against 43 at 1e-8 on
#: rect_tris(5, 4))
EPS = 1e-3

MESHES = {
    "tri3": lambda g: g.rect_tris(5, 4),
    "quad4": lambda g: g.rect_quads(4, 3),
    "hex8": lambda g: g.box_hexes(3, 3, 2),
    "hex20": lambda g: g.box_hexes20(2, 2, 1),
    "wedge6": lambda g: g.box_wedges(2, 2, 2),
    "tet4_unstructured": lambda g: g.unstructured_box_tets(4),
}


def _meshes(name):
    import femcy_tpu_torch.meshgen as tmg

    jm = MESHES[name](jmg)
    return jm, convert.mesh_from(jm), tmg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _same_pattern(t: ELLPattern, j):
    for f in dataclasses.fields(ELLPattern):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("n_dof", "width", "node_width"):
            assert a == b, f.name
        elif b is None:
            assert a is None, f.name
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _ke(mesh, seed=0):
    edof = mesh.element.n_nodes * mesh.dm
    return np.random.default_rng(seed).standard_normal(
        (mesh.n_elements, edof, edof))


# --------------------------------------------------------------------------- #
# patterns
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(MESHES))
def test_native_pattern_matches_jax(name):
    jm, tm, _ = _meshes(name)
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    assert tp.scatter_targets is None  # the native route defers it
    _same_pattern(tp, jp)
    np.testing.assert_array_equal(tp.ensure_scatter_targets(),
                                  jp.ensure_scatter_targets())


@pytest.mark.parametrize("name", list(MESHES))
def test_numpy_pattern_matches_jax(name, monkeypatch):
    """FEMCY_TPU_NATIVE=0 selects the numpy route in both packages; it
    gives the native route's arrays too."""
    jm, tm, _ = _meshes(name)
    native = build_pattern(tm)
    monkeypatch.setenv("FEMCY_TPU_NATIVE", "0")
    assert loader.get_lib() is None
    assert loader.build_pattern_native(tm.elements, tm.dm, tm.n_dof) is None
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    assert tp.scatter_targets is not None
    _same_pattern(tp, jp)
    for f in ("colidx", "row_counts", "diag_slot", "block_targets",
              "csr_indptr", "csr_indices", "csr_slots"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(native, f))
    np.testing.assert_array_equal(tp.scatter_targets,
                                  native.ensure_scatter_targets())


def test_sorted_scatter_validate_and_dense_match_jax():
    jm, tm, _ = _meshes("hex8")
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    for a, b in zip(tp.ensure_sorted_scatter(), jp.ensure_sorted_scatter()):
        np.testing.assert_array_equal(a, b)
    tp.validate()
    v = np.random.default_rng(1).standard_normal((tp.n_dof, tp.width)) * tp.valid
    np.testing.assert_array_equal(tp.to_dense(v), jp.to_dense(v))
    bad = dataclasses.replace(tp, diag_slot=tp.diag_slot + 1)
    with pytest.raises(AssertionError):
        bad.validate()


def test_to_scipy_copies_the_pattern():
    """A scipy mutator on the returned matrix leaves the pattern intact."""
    jm, tm, _ = _meshes("quad4")
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    v = np.random.default_rng(2).standard_normal((tp.n_dof, tp.width)) * tp.valid
    K = tp.to_scipy(v)
    np.testing.assert_array_equal(K.toarray(), jp.to_scipy(v).toarray())
    indices = tp.csr_indices.copy()
    K.data[:5] = 0.0
    K.eliminate_zeros()
    np.testing.assert_array_equal(tp.csr_indices, indices)


@pytest.mark.parametrize("name", list(MESHES))
def test_dia_pattern_matches_jax(name):
    jm, tm, _ = _meshes(name)
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    td = tdia.build_dia_pattern(tm, ell=tp)
    jd = jdia.build_dia_pattern(jm, ell=jp)
    assert (td is None) == (jd is None)
    if jd is None:
        return
    assert td.offsets == jd.offsets and td.diag_idx == jd.diag_idx
    assert td.n_dof == jd.n_dof
    assert td.scatter_targets is None  # derived on first use
    targets = td.ensure_scatter_targets()
    assert targets.dtype == jd.scatter_targets.dtype
    np.testing.assert_array_equal(targets, jd.scatter_targets)
    # a cap below the offset count gives no pattern, as in JAX
    cap = td.n_offsets - 1
    assert tdia.build_dia_pattern(tm, max_offsets=cap, ell=tp) is None
    assert jdia.build_dia_pattern(jm, max_offsets=cap, ell=jp) is None


def test_ell_to_dia_slots_points_at_the_same_columns():
    _, tm, _ = _meshes("hex8")
    tp = build_pattern(tm)
    td = tdia.build_dia_pattern(tm, ell=tp)
    m = tdia.ell_to_dia_slots(tp, td.offsets)
    valid = tp.valid.reshape(-1)
    assert (m[~valid] == -1).all() and (m[valid] >= 0).all()
    rows, k = np.divmod(m[valid], td.n_offsets)
    cols = rows + np.asarray(td.offsets)[k]
    np.testing.assert_array_equal(cols, tp.colidx.reshape(-1)[valid])
    assert np.unique(m[valid]).shape[0] == valid.sum()  # injective


def test_convert_carries_patterns_across():
    jm, tm, _ = _meshes("hex8")
    jp = j_build_pattern(jm)
    jp.ensure_scatter_targets()
    tp = convert.ell_pattern_from(jp)
    _same_pattern(tp, jp)
    assert tp.colidx is not jp.colidx
    jd = jdia.build_dia_pattern(jm, ell=jp)
    td = convert.dia_pattern_from(jd)
    assert (td.offsets, td.diag_idx, td.n_dof) == (jd.offsets, jd.diag_idx, jd.n_dof)
    np.testing.assert_array_equal(td.scatter_targets, jd.scatter_targets)
    sd = convert.dia_pattern_from(jdia.build_structured_dia_pattern(
        jmg.box_tets(2, 2, 2)))
    assert sd.scatter_targets is None


# --------------------------------------------------------------------------- #
# native loader
# --------------------------------------------------------------------------- #
def _isolated_build(monkeypatch, tmp_path):
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(loader, "_loaded", {})


def test_native_build_failure_raises_with_stderr(tmp_path, monkeypatch):
    """A compiler that fails surfaces its stderr; no numpy fallback."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'fake g++: error in pattern.cpp' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    _isolated_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="fake g\\+\\+: error in pattern.cpp"):
        loader.get_lib()
    assert list((tmp_path / "build").iterdir()) == []  # no partial library
    mesh = _meshes("tri3")[1]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build_pattern(mesh)


def test_native_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    _isolated_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        loader.get_lib()


def test_native_library_name_tracks_source(tmp_path, monkeypatch):
    _isolated_build(monkeypatch, tmp_path)
    a = loader.library_path()
    assert a.parent == tmp_path / "build"
    assert a.name.startswith("libfemcy_pattern-") and a.suffix == ".so"
    monkeypatch.setattr(loader, "CXX_FLAGS", loader.CXX_FLAGS + ("-g",))
    assert loader.library_path() != a


def test_native_int32_guard_hands_over_to_numpy():
    """Past 2^31 dof-level contributions or dofs the native route
    declines (None), and build_pattern takes the int64 numpy route."""
    assert loader.build_pattern_native(
        np.zeros((1, 4), np.int32), 3, 2**31) is None
    # 596,524 C3D20 elements have 596,524 * 60^2 >= 2^31 contributions
    assert loader.build_pattern_native(
        np.zeros((596_524, 20), np.int32), 3, 60) is None


# --------------------------------------------------------------------------- #
# plain scatters and the M1 kernel's emulation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["tri3", "hex8", "hex20", "tet4_unstructured"])
def test_plain_scatters_match_jax(name):
    jm, tm, _ = _meshes(name)
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    Ke = _ke(tm)
    bt = torch.from_numpy(tp.block_targets)
    npe = tm.element.n_nodes
    exp_t = tasm.expand_block_targets(bt, tp.node_width, tm.dm, tp.width, npe)
    exp_j = jasm.expand_block_targets(jnp.asarray(jp.block_targets),
                                      jp.node_width, jm.dm, jp.width, npe)
    np.testing.assert_array_equal(exp_t.numpy(), np.asarray(exp_j))
    vt = tasm.scatter_stiffness_blocks(torch.from_numpy(Ke), bt, tp.n_dof,
                                       tp.width, tp.node_width, tm.dm)
    vj = jasm.scatter_stiffness_blocks(jnp.asarray(Ke), jnp.asarray(jp.block_targets),
                                       jp.n_dof, jp.width, jp.node_width, jm.dm)
    assert _rel(vt, vj) < 1e-15
    st = torch.from_numpy(tp.ensure_scatter_targets())
    assert torch.equal(tasm.scatter_stiffness(torch.from_numpy(Ke), st,
                                              tp.n_dof, tp.width), vt)
    jd = jdia.build_dia_pattern(jm, ell=jp)
    if jd is not None:
        td = tdia.build_dia_pattern(tm, ell=tp)
        dt = tdia.dia_scatter(torch.from_numpy(Ke),
                              torch.from_numpy(td.ensure_scatter_targets()),
                              td.n_dof, td.n_offsets)
        dj = jdia.dia_scatter(jnp.asarray(Ke), jnp.asarray(jd.scatter_targets),
                              jd.n_dof, jd.n_offsets)
        assert _rel(dt, dj) < 1e-15


def _collapsed_hexes():
    """box_hexes(2, 2, 2) with one hex collapsed: its local node 7 is
    replaced by its node 6 (the box's centre), so the element names one
    node twice; the replaced corner stays in three other hexes."""
    jm = jmg.box_hexes(2, 2, 2)
    elements = np.array(jm.elements)
    assert np.bincount(elements.ravel())[elements[0, 7]] > 1
    elements[0, 7] = elements[0, 6]
    jm = jmesh.FEMesh(jm.nodes, elements, jm.element)
    return jm, convert.mesh_from(jm)


def _row_band_walk(Ke, plan):
    """The M1 kernel's rule in numpy: one node row at a time, zeroed, its
    pairs walked in order, each pair's band Ke[e, a*dm:(a+1)*dm, :] added
    into the slots (di, pos_b, dj) -- one b at a time where the element
    names a node twice -- then, on the DIA layout, each ELL value moved to
    its DIA column in a zeroed DIA row.  A wide plan on the DIA layout sums
    straight into the zeroed DIA row, each value at its slot's column."""
    ptr, pairs = plan.node_ptr.numpy(), plan.pairs.numpy()
    pos = plan.positions.numpy().astype(np.int64).reshape(-1, plan.npe)
    dm, npe, W = plan.dm, plan.npe, plan.width
    cols = None if plan.dia_columns is None else plan.dia_columns.numpy()
    in_dia = plan.wide and cols is not None
    out = np.empty(plan.out_shape, dtype=Ke.dtype)
    di = np.arange(dm)[:, None]
    for n in range(ptr.shape[0] - 1):
        k = (None if cols is None else
             cols[n * dm * W:(n + 1) * dm * W].reshape(dm, W).astype(np.int64))
        row = np.zeros((dm, plan.out_shape[1] if in_dia else W), Ke.dtype)
        for t in range(ptr[n], ptr[n + 1]):
            p = int(pairs[t])
            e, a = divmod(~p if p < 0 else p, npe)
            band = Ke[e, a * dm:(a + 1) * dm].reshape(dm, npe, dm)
            slots = pos[t][:, None] * dm + np.arange(dm)  # (b, dj)
            # (di, b, dj): where each value of the band is summed
            at = k[:, slots] if in_dia else np.broadcast_to(slots, band.shape)
            if p < 0:
                for b in range(npe):
                    row[di, at[:, b]] += band[:, b]
            else:
                row[di[..., None], at] += band
        rows = slice(n * dm, (n + 1) * dm)
        if cols is None or in_dia:
            out[rows] = row
            continue
        dia_row = np.zeros((dm, plan.out_shape[1]), dtype=Ke.dtype)
        for d in range(dm):
            dia_row[d, k[d][k[d] >= 0]] = row[d][k[d] >= 0]
        out[rows] = dia_row
    return out


def _jax_scatter(jm, Ke, layout, offsets=None):
    """femcy_tpu's plain scatter of Ke into ``layout``; on the DIA layout,
    its columns placed among ``offsets`` (by default its own)."""
    jp = j_build_pattern(jm)
    if layout == "ell":
        return np.asarray(jasm.scatter_stiffness_blocks(
            jnp.asarray(Ke), jnp.asarray(jp.block_targets), jp.n_dof,
            jp.width, jp.node_width, jm.dm))
    jd = jdia.build_dia_pattern(jm, ell=jp)
    vals = np.asarray(jdia.dia_scatter(jnp.asarray(Ke),
                                       jnp.asarray(jd.scatter_targets),
                                       jd.n_dof, jd.n_offsets))
    if offsets is None:
        return vals
    out = np.zeros((jd.n_dof, len(offsets)), vals.dtype)
    out[:, np.searchsorted(offsets, jd.offsets)] = vals
    return out


def _check_row_band_walk(jm, tm, layout, offsets=None):
    """The row-band walk is bit-equal to the wrapper's plain version and
    to femcy_tpu's plain scatter, in f32 and f64; the CPU wrapper counts
    no launch.  On the DIA layout ``offsets`` replaces the pattern's own
    (a superset of them).  Returns the plan."""
    tp = build_pattern(tm)
    dia = tdia.build_dia_pattern(tm, ell=tp) if layout == "dia" else None
    assert layout == "ell" or dia is not None
    if offsets is not None:
        assert set(dia.offsets) <= set(offsets)
        dia = dataclasses.replace(dia, offsets=tuple(offsets),
                                  diag_idx=list(offsets).index(0))
    plan = kscat.build_scatter_plan(tp, "cpu", dia=dia)
    for dtype in (np.float32, np.float64):
        Ke = _ke(tm, seed=3).astype(dtype)
        before = kscat.scatter.launches
        plain = kscat.scatter(torch.from_numpy(Ke), plan)
        assert kscat.scatter.launches == before
        assert plain.dtype == torch.from_numpy(Ke).dtype
        walk = _row_band_walk(Ke, plan)
        np.testing.assert_array_equal(walk, plain.numpy())
        np.testing.assert_array_equal(
            walk, _jax_scatter(jm, Ke, layout, offsets))
        if dia is None:
            assert (walk[~tp.valid] == 0).all()
        else:
            ref = tdia.dia_scatter(torch.from_numpy(Ke),
                                   torch.from_numpy(dia.ensure_scatter_targets()),
                                   dia.n_dof, dia.n_offsets)
            assert torch.equal(plain, ref)
    return plan


@pytest.mark.parametrize("name", ["tri3", "quad4", "hex8", "hex20",
                                  "tet4_unstructured"])
@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_scatter_kernel_emulation_matches_plain(name, layout):
    jm, tm, _ = _meshes(name)
    _check_row_band_walk(jm, tm, layout)


@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_scatter_kernel_emulation_on_a_collapsed_hex(layout):
    """An element that names a node twice: its pairs take the flagged
    path (one b at a time), and the walk still equals both plain scatters
    bit for bit."""
    jm, tm = _collapsed_hexes()
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    assert (plan.pairs < 0).sum() == tm.element.n_nodes  # element 0's pairs
    _check_row_band_walk(jm, tm, layout)


def _fan(n_ring):
    """A disc of n_ring triangles around one centre node: the centre's
    node-ELL row has n_ring + 1 slots."""
    angle = np.linspace(0.0, 2.0 * np.pi, n_ring, endpoint=False)
    nodes = np.concatenate([[[0.0, 0.0]],
                            np.stack([np.cos(angle), np.sin(angle)], 1)])
    ring = np.arange(1, n_ring + 1)
    elements = np.stack([np.zeros(n_ring, np.int64), ring,
                         np.roll(ring, -1)], 1).astype(np.int32)
    jm = jmesh.FEMesh(nodes, elements, jmg.rect_tris(1, 1).element)
    return jm, convert.mesh_from(jm)


@pytest.mark.parametrize("case", ["fan-1535-ell", "fan-1536-ell",
                                  "hex8-dia-32768", "hex8-dia-32769"])
def test_scatter_kernel_emulation_on_wide_rows(case):
    """Either side of the wide plan's thresholds: a node row of
    SHARED_ROW_BYTES (a fan's centre, 1536 node slots in 2-D) and one
    slot more; 2^15 DIA columns and one more.  A wide plan has int32
    indices, and the walk stays bit-equal to both plain scatters."""
    if case.startswith("fan"):
        n_ring = int(case.split("-")[1])
        jm, tm = _fan(n_ring)
        plan = _check_row_band_walk(jm, tm, "ell")
        assert plan.node_width == n_ring + 1
        wide = n_ring + 1 > kscat.SHARED_ROW_BYTES // (8 * tm.dm * tm.dm)
    else:
        n_cols = int(case.split("-")[2])
        jm, tm, _ = _meshes("hex8")
        lo = -(n_cols // 2)
        plan = _check_row_band_walk(jm, tm, "dia",
                                    offsets=range(lo, lo + n_cols))
        assert plan.out_shape[1] == n_cols
        wide = n_cols > 2**15
    assert plan.wide == wide
    index = torch.int32 if wide else torch.int16
    assert plan.positions.dtype == index
    assert plan.dia_columns is None or plan.dia_columns.dtype == index


def test_block_inverse_lists_each_slot_in_element_order():
    """The plan's pair list: each node's pairs in ascending e * npe + a,
    its positions those of the block map, flags exactly on the pairs of
    elements that name a node twice; the plain version recovers the block
    map from the plan."""
    for tm in (_meshes("tet4_unstructured")[1], _collapsed_hexes()[1]):
        tp = build_pattern(tm)
        npe = tm.element.n_nodes
        plan = kscat.build_scatter_plan(tp, "cpu")
        ptr, pairs = plan.node_ptr.numpy(), plan.pairs.numpy()
        assert plan.positions.dtype == torch.int16 and not plan.wide
        pos = plan.positions.numpy().astype(np.int64).reshape(-1, npe)
        assert pairs.dtype == np.int32 and ptr.dtype == np.int64
        assert ptr[0] == 0 and ptr[-1] == tm.n_elements * npe
        p = np.where(pairs < 0, ~pairs, pairs)
        np.testing.assert_array_equal(np.sort(p), np.arange(p.shape[0]))
        repeated = np.array([np.unique(el).shape[0] < npe for el in tm.elements])
        np.testing.assert_array_equal(pairs < 0, repeated[p // npe])
        bt = tp.block_targets.reshape(-1, npe)
        for n in range(tm.n_nodes):
            lst = p[ptr[n]:ptr[n + 1]]
            assert (np.diff(lst) > 0).all()
            e, a = np.divmod(lst, npe)
            assert (tm.elements[e, a] == n).all()
            np.testing.assert_array_equal(
                n * tp.node_width + pos[ptr[n]:ptr[n + 1]], bt[lst])
        np.testing.assert_array_equal(kscat.block_targets(plan).numpy(),
                                      tp.block_targets)


def test_scatter_plan_narrows_the_dia_columns():
    """On the DIA layout the plan stores each ELL slot's DIA column within
    its row: int16 up to 2^15 columns (int32 past it, a wide plan), -1 on
    padding, and row * K + column is ``ell_to_dia_slots``."""
    _, tm, _ = _meshes("hex8")
    tp = build_pattern(tm)
    dia = tdia.build_dia_pattern(tm, ell=tp)
    rows = np.arange(tp.n_dof * tp.width) // tp.width
    wide_offsets = tuple(range(-20_000, 20_000))  # 40,000 columns
    assert set(dia.offsets) <= set(wide_offsets)
    wide = dataclasses.replace(dia, offsets=wide_offsets, diag_idx=20_000)
    for d, dtype in ((dia, torch.int16), (wide, torch.int32)):
        plan = kscat.build_scatter_plan(tp, "cpu", dia=d)
        assert plan.out_shape == (tp.n_dof, d.n_offsets)
        cols = plan.dia_columns
        assert cols.dtype == dtype and cols.shape == (tp.n_dof * tp.width,)
        assert plan.wide == (dtype == torch.int32)
        cols = cols.numpy().astype(np.int64)
        valid = tp.valid.reshape(-1)
        assert (cols[~valid] == -1).all() and (cols[valid] >= 0).all()
        np.testing.assert_array_equal(
            np.where(valid, rows * d.n_offsets + cols, -1),
            tdia.ell_to_dia_slots(tp, d.offsets))


def test_scatter_wrapper_rejects_bad_operands():
    _, tm, _ = _meshes("tri3")
    plan = kscat.build_scatter_plan(build_pattern(tm), "cpu")
    Ke = torch.from_numpy(_ke(tm))
    with pytest.raises(ValueError):
        kscat.scatter(Ke[:-1], plan)
    with pytest.raises(TypeError):
        kscat.scatter(Ke.to(torch.int64), plan)
    with pytest.raises(ValueError):
        kscat.scatter(Ke.transpose(1, 2), plan)  # not contiguous


# --------------------------------------------------------------------------- #
# Dirichlet, SpMV and PCG on ELL
# --------------------------------------------------------------------------- #
def _operator(name="tet4_unstructured", eliminate=True):
    """ELL operator of a mesh (numpy), the z=0 (3D) or y=0 (2D) face
    clamped, and the same through femcy_tpu."""
    jm, tm, _ = _meshes(name)
    tp = build_pattern(tm)
    C = LinearIsotropic(1000.0, 0.3).C if tm.dm == 3 else np.asarray(
        [[1.0, 0.3, 0.0], [0.3, 1.0, 0.0], [0.0, 0.0, 0.35]]) * 1000.0
    K = thost.assemble_csr_host(tm, tp, C)
    values = np.zeros(tp.n_dof * tp.width)
    values[tp.csr_slots] = K.data
    values = values.reshape(tp.n_dof, tp.width)
    fixed = np.zeros(tm.n_dof, bool)
    base = np.nonzero(tm.nodes[:, tm.dm - 1] < 1e-9)[0]
    for d in range(tm.dm):
        fixed[base * tm.dm + d] = True
    if eliminate:
        v, _ = tbc.apply_dirichlet_linear(
            torch.from_numpy(values), torch.from_numpy(tp.colidx.astype(np.int64)),
            torch.from_numpy(tp.diag_slot), torch.zeros(tm.n_dof),
            torch.from_numpy(fixed), torch.zeros(tm.n_dof, dtype=torch.float64))
        values = v.numpy()
    return tm, tp, values, fixed


def test_apply_dirichlet_linear_matches_jax():
    tm, tp, values, fixed = _operator(eliminate=False)
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal(tm.n_dof)
    sval = np.where(fixed, rng.standard_normal(tm.n_dof), 0.0)
    fixed[0] = True  # padding slots point at column 0: they must stay 0
    sval[0] = 0.7
    colidx = tp.colidx.astype(np.int64)
    vj, rj = jbc.apply_dirichlet_linear(
        jnp.asarray(values), jnp.asarray(tp.colidx), jnp.asarray(tp.diag_slot),
        jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval))
    values_t = torch.from_numpy(values)
    vt, rt = tbc.apply_dirichlet_linear(
        values_t, torch.from_numpy(colidx), torch.from_numpy(tp.diag_slot),
        torch.from_numpy(rhs), torch.from_numpy(fixed), torch.from_numpy(sval))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert _rel(rt, rj) < 1e-13
    assert (vt.numpy()[~tp.valid] == 0).all()
    np.testing.assert_array_equal(values_t.numpy(), values)  # input untouched


def _emulate_ell_spmv(values_t, colidx_t, row_counts, x):
    """The M2 kernel's rule in numpy: one row at a time over its valid
    slots of the (W, n) transposed operands, in slot order."""
    n = x.shape[0]
    y = np.zeros(n)
    for r in range(n):
        acc = 0.0
        for w in range(row_counts[r]):
            acc += values_t[w, r] * x[colidx_t[w, r]]
        y[r] = acc
    return y


@pytest.mark.parametrize("name", ["tri3", "hex20", "tet4_unstructured"])
def test_ell_spmv_matches_jax_and_the_kernel_emulation(name):
    tm, tp, values, _ = _operator(name)
    x = np.random.default_rng(6).standard_normal(tm.n_dof)
    colidx = torch.from_numpy(tp.colidx.astype(np.int64))
    y_t = tcg.ell_spmv(torch.from_numpy(values), colidx, torch.from_numpy(x))
    y_j = jcg.ell_spmv(jnp.asarray(values), jnp.asarray(tp.colidx), jnp.asarray(x))
    assert _rel(y_t, y_j) < 1e-13
    plan = kspmv.spmv_plan(tp, "cpu")
    vt = kspmv.prep_values(plan, torch.from_numpy(values))
    assert tuple(vt.shape) == (tp.width, tp.n_dof) and vt.is_contiguous()
    assert plan.colidx_t.dtype == torch.int32 and plan.colidx_t.is_contiguous()
    y_e = _emulate_ell_spmv(vt.numpy(), plan.colidx_t.numpy(),
                            plan.row_counts.numpy(), x)
    assert _rel(y_e, y_t) < 1e-13
    before = kspmv.spmv.launches
    y_w = kspmv.spmv(plan, vt, torch.from_numpy(x))
    assert kspmv.spmv.launches == before
    assert _rel(y_w, y_t) < 1e-13


def test_ell_spmv_wrapper_rejects_bad_operands():
    tm, tp, values, _ = _operator("tri3")
    plan = kspmv.spmv_plan(tp, "cpu")
    vt = kspmv.prep_values(plan, torch.from_numpy(values))
    x = torch.zeros(tm.n_dof, dtype=torch.float64)
    with pytest.raises(ValueError):
        kspmv.spmv(plan, vt[:, :-1], x[:-1])
    with pytest.raises(TypeError):
        kspmv.spmv(plan, vt, x.float())
    with pytest.raises(ValueError):
        kspmv.spmv(plan, vt.t().contiguous().t(), x)  # not contiguous
    with pytest.raises(ValueError):
        kspmv.prep_values(plan, torch.from_numpy(values)[:-1])


@pytest.mark.parametrize("name", ["tri3", "tet4_unstructured"])
def test_pcg_solve_matches_jax(name):
    tm, tp, values, fixed = _operator(name)
    b = np.where(fixed, 0.0, np.random.default_rng(7).standard_normal(tm.n_dof))
    xj, kj, _ = jcg.pcg_solve(jnp.asarray(values), jnp.asarray(tp.colidx),
                              jnp.asarray(tp.diag_slot), jnp.asarray(b), eps=EPS)
    colidx = torch.from_numpy(tp.colidx.astype(np.int64))
    args = (torch.from_numpy(values), colidx, torch.from_numpy(tp.diag_slot),
            torch.from_numpy(b))
    xt, kt, rt = tcg.pcg_solve(*args, eps=EPS)
    assert kt == int(kj) > 0
    assert _rel(xt, xj) < 1e-10
    assert float(rt) < EPS * np.abs(b).max()
    # the (prep, apply) pair runs the plain SpMV on the CPU, summing the
    # transposed operand's rows in another order: same count, roundoff
    xp, kp, _ = tcg.pcg_solve(*args, eps=EPS, spmv=kspmv.make_spmv(tp, "cpu"))
    assert kp == kt and _rel(xp, xt) < 1e-10


def test_pcg_solve_cap_and_zero_rhs():
    tm, tp, values, fixed = _operator("tri3")
    b = np.where(fixed, 0.0, np.random.default_rng(8).standard_normal(tm.n_dof))
    colidx = torch.from_numpy(tp.colidx.astype(np.int64))
    v, ds = torch.from_numpy(values), torch.from_numpy(tp.diag_slot)
    _, k, _ = tcg.pcg_solve(v, colidx, ds, torch.from_numpy(b), max_iters=3)
    _, kj, _ = jcg.pcg_solve(jnp.asarray(values), jnp.asarray(tp.colidx),
                             jnp.asarray(tp.diag_slot), jnp.asarray(b), max_iters=3)
    assert k == int(kj) == 3
    x0, k0, r0 = tcg.pcg_solve(v, colidx, ds, torch.zeros(tm.n_dof, dtype=torch.float64))
    assert k0 == 0 and float(r0) == 0.0 and not x0.any()


# --------------------------------------------------------------------------- #
# host operator
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["quad4", "hex8", "tet4_unstructured"])
def test_host_operator_matches_jax(name):
    jm, tm, _ = _meshes(name)
    tp, jp = build_pattern(tm), j_build_pattern(jm)
    C = (LinearIsotropic(1000.0, 0.3).C if tm.dm == 3
         else np.asarray([[1.0, 0.25, 0.0], [0.25, 1.0, 0.0], [0.0, 0.0, 0.375]]))
    np.testing.assert_array_equal(thost.element_stiffness_host(tm, C),
                                  jhost.element_stiffness_host(jm, C))
    Kt, Kj = thost.assemble_csr_host(tm, tp, C), jhost.assemble_csr_host(jm, jp, C)
    np.testing.assert_array_equal(Kt.toarray(), Kj.toarray())
    rng = np.random.default_rng(9)
    fixed = rng.uniform(size=tm.n_dof) < 0.2
    sval = np.where(fixed, rng.standard_normal(tm.n_dof), 0.0)
    rhs = rng.standard_normal(tm.n_dof)
    (Bt, bt), (Bj, bj) = (thost.dirichlet_csr_host(Kt, rhs, fixed, sval),
                          jhost.dirichlet_csr_host(Kj, rhs, fixed, sval))
    np.testing.assert_array_equal(Bt.toarray(), Bj.toarray())
    np.testing.assert_array_equal(bt, bj)
    # the device path's Ke scattered by the plain scatter gives the same
    # operator (f64 einsum against numpy matmul: 1e-12 relative)
    a = {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in (
        ("nodes", tm.nodes), ("dN", tm.element.dshape_at_gp),
        ("w", tm.element.gauss_weights), ("C", C))}
    dsdx, vol = tasm.gradients_and_volume(
        a["nodes"], torch.from_numpy(tm.elements.astype(np.int64)), a["dN"], a["w"])
    Ke = tasm.element_stiffness(dsdx, vol, a["C"])
    plan = kscat.build_scatter_plan(tp, "cpu")
    vals = kscat.scatter(Ke, plan).numpy()
    assert _rel(tp.to_scipy(vals).toarray(), Kt.toarray()) < 1e-12
