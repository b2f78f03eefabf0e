"""Multi-block models (femcy_tpu_torch.multiblock) against femcy_tpu's, on
the CPU, in float64.

The same blocks (femcy_tpu's, carried over by ``convert.blocks_from``) go
through both packages: a CPS4 + CPS3 plate of two materials, a C3D8 + C3D6
box (hexes on one half, the other half split into wedges as
``meshgen.box_wedges`` splits it) and a two-material
``unstructured_box_tets``.  Tolerances:
- the union pattern (colidx, row counts, valid mask, diagonal slots, CSR
  arrays) and each block's dof-level targets: equal;
- the host f64 twin of the union operator: bit-equal to femcy_tpu's
  ``np.add.at`` over its targets;
- each block's plain M1 values: bit-equal to femcy_tpu's segment sum of the
  same Ke; the assembled union system: 1e-13 relative (each package's Ke
  from its own einsums);
- a one-block system: its pattern equal to ``topology.build_pattern``'s and
  its values and solution bit-equal to ``FEMSystem``'s on the ELL layout;
- linear solves, direct: dof, stress, Mises within 1e-10 relative, energy
  within 1e-10; CG at cg_eps 1e-10: both within 1e-7 of the direct dof and
  the iteration counts at most one apart (ROADMAP.md section 3);
- the AMG hierarchy: bit-equal to femcy_tpu's (its bf16 level arrays and
  the coarsest inverse), the solution within 1e-6 of the direct one;
- Newton: the increment/Newton history equal, dof, stress and energy within
  1e-8 relative (direct linear solves).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu import assembly as jasm
from femcy_tpu import multiblock as jmb
from femcy_tpu.elements import get_element as j_get_element
from femcy_tpu.io.inp import DirichletBC

import femcy_tpu_torch as T
from femcy_tpu_torch import convert
from femcy_tpu_torch import multiblock as tmb
from femcy_tpu_torch.assembly import expand_block_targets
from femcy_tpu_torch.io.inp import DirichletBC as TDirichletBC
from femcy_tpu_torch.kernels import ell_scatter as kscat

TOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# --------------------------------------------------------------------------- #
# models (femcy_tpu's blocks; the port gets convert.blocks_from of them)
# --------------------------------------------------------------------------- #
def _mixed_rect(nx=4, ny=2, lx=2.0, ly=1.0):
    """[0,lx] x [0,ly]: CPS4 quads on the left half, CPS3 triangles (two a
    cell) on the right.  Returns (nodes, quads, tris)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    nodes = np.array([[x, y] for x in xs for y in ys])

    def nid(i, j):
        return i * (ny + 1) + j

    quads, tris = [], []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)
            if i < nx // 2:
                quads.append([a, b, c, d])
            else:
                tris += [[a, b, c], [a, c, d]]
    return nodes, np.asarray(quads, np.int32), np.asarray(tris, np.int32)


def hex_wedge_box(nx, ny, nz):
    """box_hexes' node grid: cells with i < nx // 2 as C3D8, the others
    split into two C3D6 as box_wedges splits them (its first wedges, then
    its second ones).  Returns (nodes, hexes, wedges)."""
    hexes = F.meshgen.box_hexes(nx, ny, nz)
    wedges = F.meshgen.box_wedges(nx, ny, nz)
    cells = nx * ny * nz
    left = np.arange(cells) // (ny * nz) < nx // 2
    w = wedges.elements
    return (hexes.nodes, hexes.elements[left],
            np.concatenate([w[:cells][~left], w[cells:][~left]]))


def _blocks(name):
    """(nodes, femcy_tpu blocks) of a named model."""
    if name == "plate":
        nodes, quads, tris = _mixed_rect(6, 4)
        return nodes, [
            jmb.ElementBlock(quads, j_get_element("CPS4"),
                             F.LinearIsotropicPlaneStress(200.0, 0.25), "soft"),
            jmb.ElementBlock(tris, j_get_element("CPS3"),
                             F.LinearIsotropicPlaneStress(600.0, 0.25), "stiff"),
        ]
    if name == "hex+wedge":
        nodes, hexes, wedges = hex_wedge_box(4, 3, 3)
        return nodes, [
            jmb.ElementBlock(hexes, j_get_element("C3D8"),
                             F.LinearIsotropic(1000.0, 0.3), "hex"),
            jmb.ElementBlock(wedges, j_get_element("C3D6"),
                             F.NeoHookean(C1=192.3, D1=288.5), "wedge"),
        ]
    mesh = F.meshgen.unstructured_box_tets(int(name.split("tets")[1]))
    low = mesh.nodes[mesh.elements].mean(axis=1)[:, 2] < 0.5
    return mesh.nodes, [
        jmb.ElementBlock(mesh.elements[low], mesh.element,
                         F.LinearIsotropic(100.0, 0.3), "soft"),
        jmb.ElementBlock(mesh.elements[~low], mesh.element,
                         F.LinearIsotropic(300.0, 0.3), "stiff"),
    ]


def _pair(name, **cfg):
    nodes, jblocks = _blocks(name)
    js = jmb.MultiBlockSystem(nodes, jblocks, F.SolverConfig(**cfg))
    ts = tmb.MultiBlockSystem(nodes, convert.blocks_from(js),
                              T.SolverConfig(**cfg), device="cpu")
    return js, ts


def _linear_bcs(nodes):
    """x=0 (2-D) or z=0 (3-D) clamped; a unit load along x on the opposite
    face.  Returns (rhs, fixed, sval) as numpy."""
    dm = nodes.shape[1]
    axis = nodes[:, 0] if dm == 2 else nodes[:, 2]
    fixed = np.zeros(nodes.shape[0] * dm, bool)
    for d in range(dm):
        fixed[np.nonzero(axis < 1e-9)[0] * dm + d] = True
    rhs = np.zeros(nodes.shape[0] * dm)
    rhs[np.nonzero(axis > axis.max() - 1e-9)[0] * dm + dm - 1] = 1.0
    return rhs, fixed, np.zeros(nodes.shape[0] * dm)


# --------------------------------------------------------------------------- #
# the union pattern and the host twin
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["plate", "hex+wedge", "tets6"])
def test_union_pattern_matches_jax(name):
    nodes, jblocks = _blocks(name)
    dm = nodes.shape[1]
    n_dof = nodes.shape[0] * dm
    jp, jtargets, jforce = jmb.build_union_pattern(n_dof, dm, jblocks)
    tblocks = [convert.element_block_from(b) for b in jblocks]
    tp, block_targets = tmb.build_union_pattern(n_dof, dm, tblocks)
    assert (tp.n_dof, tp.width) == (jp.n_dof, jp.width)
    assert tp.node_width * dm == tp.width
    for field in ("colidx", "row_counts", "valid", "diag_slot", "csr_indptr",
                  "csr_indices", "csr_slots", "force_targets", "element_dofs"):
        a, ref = getattr(tp, field), np.asarray(getattr(jp, field))
        assert a.dtype == ref.dtype and np.array_equal(a, ref), field
    for bi, blk in enumerate(tblocks):
        full = expand_block_targets(torch.as_tensor(block_targets[bi]),
                                    tp.node_width, dm, tp.width,
                                    blk.element.n_nodes).numpy()
        assert np.array_equal(full, jtargets[bi])
        view = tmb.block_pattern(tp, blk, block_targets[bi])
        assert np.array_equal(view.force_targets, jforce[bi])


def test_union_pattern_rejects_a_node_no_element_names():
    """A node 0 that no element names.  (femcy_tpu's searchsorted check
    raises IndexError instead when the orphan is the last node; the port
    raises RuntimeError there too.)"""
    nodes, jblocks = _blocks("plate")
    nodes = np.concatenate([[[9.0, 9.0]], nodes])
    jblocks = [dataclasses.replace(b, elements=b.elements + 1)
               for b in jblocks]
    with pytest.raises(RuntimeError, match="missing diagonal"):
        jmb.build_union_pattern(nodes.size, 2, jblocks)
    with pytest.raises(RuntimeError, match="missing diagonal"):
        tmb.build_union_pattern(nodes.size, 2,
                                [convert.element_block_from(b) for b in jblocks])
    last = [dataclasses.replace(b, elements=b.elements - 1) for b in jblocks]
    with pytest.raises(RuntimeError, match="missing diagonal"):
        tmb.build_union_pattern(nodes.size, 2,
                                [convert.element_block_from(b) for b in last])


@pytest.mark.parametrize("name", ["plate", "hex+wedge"])
def test_host_twin_is_jax_add_at_bit_for_bit(name):
    """union_values_host equals femcy_tpu's _ensure_amg twin: np.add.at of
    each block's host Ke over its dof targets, block after block."""
    from femcy_tpu_torch.assembly_host import element_stiffness_block_host

    nodes, jblocks = _blocks(name)
    dm = nodes.shape[1]
    jp, jtargets, _ = jmb.build_union_pattern(nodes.size, dm, jblocks)
    ref = np.zeros(jp.n_dof * jp.width)
    for bi, blk in enumerate(jblocks):
        Ke = element_stiffness_block_host(nodes, blk.elements,
                                          convert.element_from(blk.element),
                                          blk.material.C)
        np.add.at(ref, jtargets[bi], Ke.reshape(-1))
    tblocks = [convert.element_block_from(b) for b in jblocks]
    tp, block_targets = tmb.build_union_pattern(nodes.size, dm, tblocks)
    vals = tmb.union_values_host(nodes, tblocks, block_targets, tp)
    assert np.array_equal(vals.reshape(-1), ref)


# --------------------------------------------------------------------------- #
# assembly
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["plate", "hex+wedge", "tets4"])
def test_block_values_match_jax(name):
    """Each block's plain M1 output equals femcy_tpu's segment sum of the
    same Ke (rows the block does not touch are zero); the assembled,
    eliminated union system matches femcy_tpu's _system_impl."""
    js, ts = _pair(name, linear_solver="direct")
    p = js.pattern
    for bi, blk in enumerate(js.blocks):
        a = js._arrs
        dsdx, vol = jasm.gradients_and_volume(
            a["nodes"], a[f"elements_{bi}"], a[f"dN_{bi}"], a[f"w_{bi}"])
        Ke = np.array(jasm.element_stiffness(dsdx, vol, a[f"C_{bi}"]))
        ref = np.asarray(jax.ops.segment_sum(
            jnp.asarray(Ke).reshape(-1), js._arrs[f"targets_{bi}"],
            num_segments=p.n_dof * p.width)).reshape(p.n_dof, p.width)
        got = ts._block_values(bi, torch.from_numpy(Ke)).numpy()
        assert np.array_equal(got, ref)
        touched = np.zeros(p.n_dof // ts.dm, bool)
        touched[blk.elements.reshape(-1)] = True
        assert not got.reshape(-1, ts.dm * p.width)[~touched].any()
    rhs, fixed, sval = _linear_bcs(js.nodes)
    jv, jb = js._jit_system(js._arrs, jnp.asarray(rhs), jnp.asarray(fixed),
                            jnp.asarray(sval))
    tv, tb = ts._linear_system(torch.from_numpy(rhs), torch.from_numpy(fixed),
                               torch.from_numpy(sval))
    assert _rel(tv, jv) < 1e-13 and _rel(tb, jb) < 1e-13
    assert kscat.scatter.launches == 0  # CPU tensors never launch M1


def test_one_block_matches_femsystem():
    """One block over the whole unstructured box: the union pattern is
    topology.build_pattern's, and assembly and solve are FEMSystem's on the
    ELL layout, bit for bit."""
    mesh = T.meshgen.unstructured_box_tets(4)
    mat = T.LinearIsotropic(1000.0, 0.3)
    cfg = T.SolverConfig(sparse_format="ell", linear_solver="cg",
                         cg_eps=1e-10)
    fs = T.FEMSystem(mesh, mat, config=cfg, device="cpu")
    mb = T.MultiBlockSystem(mesh.nodes,
                            [T.ElementBlock(mesh.elements, mesh.element, mat)],
                            cfg, device="cpu")
    for field in ("colidx", "row_counts", "diag_slot", "csr_indptr",
                  "csr_indices", "csr_slots"):
        assert np.array_equal(getattr(mb.pattern, field),
                              getattr(fs.pattern, field)), field
    assert mb.pattern.node_width == fs.pattern.node_width
    rhs, fixed, sval = _linear_bcs(mesh.nodes)
    fixed_t = torch.from_numpy(fixed)
    fv, fb, _ = fs._linear_system(torch.from_numpy(rhs), fixed_t,
                                  torch.from_numpy(sval))
    mv, mb_b = mb._linear_system(torch.from_numpy(rhs), fixed_t,
                                 torch.from_numpy(sval))
    assert torch.equal(mv, fv) and torch.equal(mb_b, fb)
    x_f = fs._solve_linear_system(fv, fb, fixed_t)
    x_m = mb.solve(rhs, fixed, sval)
    assert torch.equal(x_m, x_f)
    assert mb._cg_iters_log == fs._cg_iters_log


# --------------------------------------------------------------------------- #
# linear solves and post-processing
# --------------------------------------------------------------------------- #
def _compare_post(js, ts, tol):
    for bi in range(len(js.blocks)):
        for large in (None, True):
            js_out = js.block_stress(bi, large)
            ts_out = ts.block_stress(bi, large)
            for a, ref in zip(ts_out, js_out):
                assert _rel(a, ref) < tol
        _, _, mises = ts.block_stress(bi)
        nodal = ts.extrapolate_block(bi, mises)
        ref = js.extrapolate_block(bi, js.block_stress(bi)[2])
        assert _rel(nodal, ref) < tol
    assert abs(ts.elastic_energy() - js.elastic_energy()) <= tol * abs(
        js.elastic_energy())


@pytest.mark.parametrize("name", ["plate", "hex+wedge", "tets6"])
def test_direct_solve_matches_jax(name):
    js, ts = _pair(name, linear_solver="direct")
    rhs, fixed, sval = _linear_bcs(js.nodes)
    sval[np.nonzero(fixed)[0][::2]] = 1e-3  # some prescribed values
    xj = np.asarray(js.solve(rhs, fixed, sval))
    xt = ts.solve(rhs, fixed, sval)
    assert xt.dtype == torch.float64 and xt.device.type == "cpu"
    assert _rel(xt, xj) < 1e-10
    _compare_post(js, ts, 1e-10)


@pytest.mark.parametrize("name", ["plate", "tets6"])
def test_cg_solve_matches_jax(name):
    js, ts = _pair(name, linear_solver="cg", cg_eps=1e-10)
    rhs, fixed, sval = _linear_bcs(js.nodes)
    xj = np.asarray(js.solve(rhs, fixed, sval))
    _, j_iters, _ = js._jit_cg(*js._jit_system(
        js._arrs, jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval)))
    xt = ts.solve(rhs, fixed, sval).numpy()
    d = _pair(name, linear_solver="direct")[1]
    x_direct = d.solve(rhs, fixed, sval).numpy()
    assert _rel(xt, x_direct) < 1e-7 and _rel(xj, x_direct) < 1e-7
    assert abs(ts._cg_iters_log[0] - int(j_iters)) <= 1


def test_amg_hierarchy_matches_jax():
    """preconditioner="amg": the hierarchy built from the f64 host twin is
    femcy_tpu's, level for level; the AMG-PCG solution is the direct one."""
    cfg = dict(preconditioner="amg", linear_solver="cg", cg_eps=1e-8)
    js, ts = _pair("tets10", **cfg)
    rhs, fixed, sval = _linear_bcs(js.nodes)
    js.solve(rhs, fixed, sval)
    xt = ts.solve(rhs, fixed, sval).numpy()
    j, t = js._amg, ts._amg
    assert t.n_levels == j.n_levels >= 2
    assert [(lv.n_dof, lv.bs, lv.lmax) for lv in t.levels] == [
        (lv.n_dof, lv.bs, lv.lmax) for lv in j.levels]
    for lt, lj in zip(t.levels, j.levels):
        for attr in ("values", "inv_diag", "P_values", "R_values"):
            a, ref = getattr(lt, attr), getattr(lj, attr)
            assert (a is None) == (ref is None), attr
            if ref is not None:
                assert np.array_equal(a.float().numpy(),
                                      np.asarray(ref, np.float32)), attr
        for attr in ("colidx", "P_colidx", "R_colidx"):
            a, ref = getattr(lt, attr), getattr(lj, attr)
            if ref is not None:
                assert np.array_equal(a.numpy(), np.asarray(ref)), attr
    assert np.array_equal(t._coarse_inv.numpy(), np.asarray(j._coarse_inv))
    assert set(ts._amg_host_seconds) == {"host_twin", "dirichlet",
                                         "bell_plan", "unattributed"}
    x_direct = _pair("tets10", linear_solver="direct")[1].solve(
        rhs, fixed, sval).numpy()
    assert _rel(xt, x_direct) < 1e-6
    first = ts._amg
    ts.solve(rhs, fixed, sval)
    assert ts._amg is first  # kept while the mask holds


def test_multiblock_rejects_mixed_dimensionality_and_no_blocks():
    nodes, jblocks = _blocks("plate")
    blocks = [convert.element_block_from(jblocks[0]),
              T.ElementBlock(np.zeros((1, 4), np.int32),
                             convert.element_from(j_get_element("C3D4")),
                             T.LinearIsotropic(1.0, 0.3))]
    with pytest.raises(ValueError, match="dimensionalities"):
        T.MultiBlockSystem(nodes, blocks, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        T.MultiBlockSystem(nodes, [], device="cpu")


# --------------------------------------------------------------------------- #
# .inp models: read_inp_multi -> system_from_model -> solve_model
# --------------------------------------------------------------------------- #
_PLATE_INP = """*Heading
mixed-type two-material plate
*Node
{nodes}
*Element, type=CPS4, elset=soft
{quads}
*Element, type=CPS3, elset=stiff
{tris}
*Nset, nset=left, instance=Part-1-1
{left}
*Elset, elset={top_q}, instance=Part-1-1
{top_quads}
*Elset, elset=toptri, instance=Part-1-1
{top_tris}
*Elset, elset=rightcol, instance=Part-1-1
{right_tris}
*Surface, type=ELEMENT, name=surfTop
{top_q}, S3
toptri, S2
*Surface, type=ELEMENT, name=surfR
rightcol, S2
*Solid Section, elset=soft, material=rubber
*Solid Section, elset=stiff, material=steel
*MATERIAL, NAME=rubber
*Elastic
100., 0.
*MATERIAL, NAME=steel
*Elastic
300., 0.
*Step{step}
*Static
{static}
*Boundary
left, 1, 1
left, 2, 2
*Dsload
surfR, P, {traction}, 1., 0., 0.
surfTop, P, 0.5
*End Step
"""


def _plate_inp(path, step=", nlgeom=NO", static="1., 1., 1e-05, 1.",
               traction=5.0):
    """The CPS4 + CPS3 plate with one *Dsload on the x=2 edge (triangles)
    and one on the y=1 edge, whose facets lie in both blocks."""
    nx, ny = 4, 2
    nodes, quads, tris = _mixed_rect(nx, ny)
    nq = len(quads)
    # the quad of each column's top row, and the triangle (a, c, d) of the
    # right columns' top row, whose local edge (c, d) (Abaqus S2) is y=1
    top_quads = [i * ny + ny - 1 for i in range(nx // 2)]
    top_tris = [nq + (i * ny + ny - 1) * 2 + 1 for i in range(nx - nx // 2)]
    right_tris = [nq + ((nx - 1 - nx // 2) * ny + j) * 2 for j in range(ny)]
    path.write_text(_PLATE_INP.format(
        nodes="\n".join(f"{i + 1}, {x}, {y}" for i, (x, y) in enumerate(nodes)),
        quads="\n".join(f"{i + 1}, " + ", ".join(str(n + 1) for n in e)
                        for i, e in enumerate(quads)),
        tris="\n".join(f"{nq + i + 1}, " + ", ".join(str(n + 1) for n in e)
                       for i, e in enumerate(tris)),
        left=", ".join(str(i + 1) for i in np.nonzero(nodes[:, 0] < 1e-12)[0]),
        top_q="topquad",
        top_quads=", ".join(str(e + 1) for e in top_quads),
        top_tris=", ".join(str(e + 1) for e in top_tris),
        right_tris=", ".join(str(e + 1) for e in right_tris),
        step=step, static=static, traction=traction,
    ))
    return nodes


def test_solve_model_dsload_across_blocks_matches_jax(tmp_path):
    path = tmp_path / "plate.inp"
    _plate_inp(path)
    jm, tm = F.read_inp_multi(str(path)), T.read_inp_multi(str(path))
    assert not tm.geometric_nonlinear and len(tm.neumann_bcs) == 2
    js, ts = jmb.system_from_model(jm), T.system_from_model(tm, device="cpu")
    top = tm.neumann_bcs[1]
    owners = [[f for f in top.face_set if tuple(f) in ts.block_mesh(bi).boundary]
              for bi in range(2)]
    assert all(owners)  # the y=1 surface spans both blocks
    for jn, tn in zip(jm.neumann_bcs, tm.neumann_bcs):
        assert np.array_equal(ts._neumann_unit_pattern(tn),
                              js._neumann_unit_pattern(jn))
    xj = np.asarray(js.solve_model(jm))
    xt = ts.solve_model(tm)
    assert _rel(xt, xj) < 1e-10
    _compare_post(js, ts, 1e-10)


def _cae_deck(sections):
    """The two-material CPS4 + CPS3 bar as Abaqus CAE writes it: bare
    *Element blocks, standalone *Elset blocks, *Solid Section mapping."""
    nid, nodes, k = {}, [], 1
    for j in range(3):
        for i in range(5):
            nid[(i, j)] = k
            nodes.append(f"{k}, {i * 0.5}, {j * 0.5}")
            k += 1
    quads, tris, e = [], [], 1
    for j in range(2):
        for i in range(4):
            n1, n2 = nid[(i, j)], nid[(i + 1, j)]
            n3, n4 = nid[(i + 1, j + 1)], nid[(i, j + 1)]
            if i < 2:
                quads.append(f"{e}, {n1}, {n2}, {n3}, {n4}")
                e += 1
    for j in range(2):
        for i in range(2, 4):
            n1, n2 = nid[(i, j)], nid[(i + 1, j)]
            n3, n4 = nid[(i + 1, j + 1)], nid[(i, j + 1)]
            tris += [f"{e}, {n1}, {n2}, {n3}", f"{e + 1}, {n1}, {n3}, {n4}"]
            e += 2
    left = ", ".join(str(nid[(0, j)]) for j in range(3))
    right = ", ".join(str(nid[(4, j)]) for j in range(3))
    return ("*Heading\nbar\n*Node\n" + "\n".join(nodes)
            + "\n*Element, type=CPS4\n" + "\n".join(quads)
            + "\n*Element, type=CPS3\n" + "\n".join(tris) + sections
            + f"""*Nset, nset=fix
{left}
*Nset, nset=pull
{right}
*Material, name=hard
*Elastic
300., 0.
*Material, name=soft
*Elastic
100., 0.
*Step, nlgeom=NO
*Static
1., 1., 1e-4, 1.
*Boundary
fix, 1, 2, 0.
pull, 1, 1, 0.4
pull, 2, 2, 0.
*End Step
""")


@pytest.mark.parametrize("sections", [
    """
*Elset, elset=setq, generate
1, 4, 1
*Elset, elset=sett, generate
5, 12, 1
*Solid Section, elset=setq, material=hard
*Solid Section, elset=sett, material=soft
""",
    """
*Elset, elset=setq, generate
1, 4, 1
*Elset, elset=sett1
5, 6, 9, 10
*Elset, elset=sett2
7, 8, 11, 12
*Solid Section, elset=setq, material=hard
*Solid Section, elset=sett1, material=hard
*Solid Section, elset=sett2, material=soft
""",
], ids=["standalone elsets", "block split by sections"])
def test_cae_layout_models_match_jax(tmp_path, sections):
    path = tmp_path / "cae.inp"
    path.write_text(_cae_deck(sections))
    jm, tm = F.read_inp_multi(str(path)), T.read_inp_multi(str(path))
    js, ts = jmb.system_from_model(jm), T.system_from_model(tm, device="cpu")
    assert [b.name for b in ts.blocks] == [b.name for b in js.blocks]
    assert [b.material for b in ts.blocks] == [
        convert.material_from(b.material) for b in js.blocks]
    assert _rel(ts.solve_model(tm), js.solve_model(jm)) < 1e-10
    _compare_post(js, ts, 1e-10)


# --------------------------------------------------------------------------- #
# geometric nonlinearity
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _Model:
    """The fields of a model that solve_nonlinear reads."""

    dirichlet_bcs: list
    neumann_bcs: list
    geometric_nonlinear: bool
    time_incs: dict


def _history(report):
    return [(r.kinc, r.time, r.dt, r.newton_iters, r.converged)
            for r in report.increments]


def _compare_newton(js, ts, jr, tr):
    assert tr.success == jr.success and tr.message == jr.message
    assert _history(tr) == _history(jr)
    res = max(abs(r.residual) for r in jr.increments) or 1.0
    for a, b in zip(tr.increments, jr.increments):
        assert abs(a.residual - b.residual) <= TOL * res
    assert _rel(ts.dof, js.dof) < TOL
    _compare_post(js, ts, TOL)


@pytest.mark.parametrize("tangent", ["secant", "consistent"])
def test_newton_two_material_plate_matches_jax(tmp_path, tangent):
    """femcy_tpu's test_nonlinear_mixed_type_two_material model: the
    CPS4 + CPS3 bar under an end traction, with nlgeom."""
    path = tmp_path / "plate_nl.inp"
    _plate_inp(path, step="", static="0.5, 1., 1e-05, 0.5", traction=0.5)
    jm, tm = F.read_inp_multi(str(path)), T.read_inp_multi(str(path))
    assert tm.geometric_nonlinear
    js = jmb.system_from_model(jm, F.SolverConfig(tangent=tangent))
    ts = T.system_from_model(tm, T.SolverConfig(tangent=tangent),
                             device="cpu")
    js.solve_model(jm)
    ts.solve_model(tm)
    assert len(ts.last_report.increments) >= 2
    _compare_newton(js, ts, js.last_report, ts.last_report)


def test_newton_neo_hookean_steel_sandwich_matches_jax():
    """femcy_tpu's test_nonlinear_neo_hookean_steel_sandwich model: a
    neo-Hookean rubber half and a steel half of C3D8, 2% then 20% end
    stretch on the same system."""
    nx, ny, nz, lx = 4, 2, 2, 2.0
    mesh = F.meshgen.box_hexes(nx, ny, nz, lx, 1.0, 1.0)
    left = np.arange(nx * ny * nz) // (ny * nz) < nx // 2
    jblocks = [
        jmb.ElementBlock(mesh.elements[left], mesh.element,
                         F.NeoHookean(C1=0.4, D1=0.5), "rubber"),
        jmb.ElementBlock(mesh.elements[~left], mesh.element,
                         F.LinearIsotropic(1000.0, 0.3), "steel"),
    ]
    js = jmb.MultiBlockSystem(mesh.nodes, jblocks)
    ts = tmb.MultiBlockSystem(mesh.nodes, convert.blocks_from(js),
                              device="cpu")
    left_n = np.nonzero(mesh.nodes[:, 0] < 1e-12)[0]
    right_n = np.nonzero(mesh.nodes[:, 0] > lx - 1e-12)[0]
    for stretch in (0.02, 0.2):
        model = _Model(
            dirichlet_bcs=([DirichletBC(left_n, d, 0.0) for d in range(3)]
                           + [DirichletBC(right_n, 0, stretch),
                              DirichletBC(right_n, 1, 0.0),
                              DirichletBC(right_n, 2, 0.0)]),
            neumann_bcs=[], geometric_nonlinear=True,
            time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4,
                           max_inc=0.5))
        js._ini_residual = ts._ini_residual = None
        jr = js.solve_nonlinear(model)
        tr = ts.solve_nonlinear(dataclasses.replace(model, dirichlet_bcs=[
            TDirichletBC(np.array(b.node_set), b.dof, b.value, b.user)
            for b in model.dirichlet_bcs]))
        assert jr.success
        _compare_newton(js, ts, jr, tr)


def test_newton_failure_cuts_back_like_jax(tmp_path):
    """A traction that inverts elements in one increment: both packages cut
    back to min_inc and report the same failure."""
    path = tmp_path / "plate_fail.inp"
    _plate_inp(path, step="", static="1., 1., 0.5, 1.", traction=-500.0)
    jm, tm = F.read_inp_multi(str(path)), T.read_inp_multi(str(path))
    js, ts = jmb.system_from_model(jm), T.system_from_model(tm, device="cpu")
    jr, tr = js.solve_nonlinear(jm), ts.solve_nonlinear(tm)
    assert not jr.success and not tr.success
    assert tr.message == jr.message
    assert [(r.newton_iters, r.converged) for r in tr.increments] == [
        (r.newton_iters, r.converged) for r in jr.increments]
    with pytest.raises(RuntimeError, match="nonlinear multi-block analysis"):
        ts.solve_model(tm)


def test_newton_hooks_see_what_jax_hooks_see(tmp_path):
    """on_increment and on_newton, run through the increment driver that
    MultiBlockSystem shares with FEMSystem: called as femcy_tpu calls them,
    on the same increments and Newton evaluations."""
    path = tmp_path / "plate_nl.inp"
    _plate_inp(path, step="", static="0.5, 1., 1e-05, 0.5", traction=0.5)
    jm, tm = F.read_inp_multi(str(path)), T.read_inp_multi(str(path))
    js, ts = jmb.system_from_model(jm), T.system_from_model(tm, device="cpu")
    seen = {"jax": ([], []), "torch": ([], [])}
    for key, system, model in (("jax", js, jm), ("torch", ts, tm)):
        incs, evals = seen[key]
        report = system.solve_nonlinear(
            model,
            on_increment=lambda s, r, incs=incs, system=system: incs.append(
                (s is system, r.kinc, r.time, r.dt, r.newton_iters)),
            on_newton=lambda s, n, res, evals=evals, system=system:
                evals.append((s is system, n)))
        assert report.success
        assert [i[1:] for i in incs] == [
            (r.kinc, r.time, r.dt, r.newton_iters)
            for r in report.increments if r.converged]
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"][0]) >= 2 and all(i[0] for i in seen["torch"][0])


def test_system_defaults_to_the_card(monkeypatch):
    nodes, jblocks = _blocks("plate")
    blocks = [convert.element_block_from(b) for b in jblocks]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        T.MultiBlockSystem(nodes, blocks)
    assert T.MultiBlockSystem(nodes, blocks, device="cpu").device.type == "cpu"


# --------------------------------------------------------------------------- #
# the CLI's multi-block route
# --------------------------------------------------------------------------- #
def _vtk_blocks(path):
    """[(header line, values)] of a legacy VTK file."""
    blocks = []
    for line in path.read_text().splitlines():
        if line[:1].isalpha() or line.startswith("#"):
            blocks.append((line, []))
        else:
            blocks[-1][1].extend(float(v) for v in line.split())
    return [(h, np.asarray(v)) for h, v in blocks]


@pytest.mark.parametrize("nlgeom, extra", [
    (False, ["--stress", "0"]),
    (True, ["--stress", "1", "--solver", "direct"]),
    (True, ["--stabilize", "2e-4", "--tangent", "consistent"]),
], ids=["linear", "nlgeom", "nlgeom, --stabilize"])
def test_cli_multiblock_matches_jax(tmp_path, capsys, nlgeom, extra):
    """Both CLIs on the two-material plate: the same printed lines (the
    --stabilize warning included), numbers within 1e-6 relative; the VTK
    (mixed cells) within 1e-8 of each block's largest value and the HTML
    payload's triangles and positions equal."""
    import json
    import re

    from femcy_tpu import cli as jcli
    from femcy_tpu_torch import cli as tcli

    path = tmp_path / "plate.inp"
    if nlgeom:
        _plate_inp(path, step="", static="0.5, 1., 1e-05, 0.5", traction=0.5)
    else:
        _plate_inp(path)
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        argv = [str(path), "--platform", "cpu", *extra,
                "--save-vtk", str(tmp_path / f"{name}.vtk"),
                "--save-html", str(tmp_path / f"{name}.html")]
        rc = main(argv)
        outs[name] = (rc, capsys.readouterr().out.splitlines())
    (j_rc, j_lines), (t_rc, t_lines) = outs["jax"], outs["torch"]
    assert t_rc == j_rc == 0 and len(t_lines) == len(j_lines)
    assert ("--stabilize" in extra) == t_lines[0].startswith("warning:")
    assert any("4 CPS4[soft], 8 CPS3[stiff]" in ln for ln in t_lines)
    for t, j in zip(t_lines, j_lines):
        if t.startswith("solve:"):
            assert re.sub(r"[\d.]+s", "", t) == re.sub(r"[\d.]+s", "", j)
        elif " = " in j:
            assert t.split(" = ")[0] == j.split(" = ")[0]
            t_num, j_num = float(t.split(" = ")[1]), float(j.split(" = ")[1])
            assert abs(t_num - j_num) <= 1e-6 * max(abs(j_num), 1e-30), j
        else:
            assert re.sub(r"\S*(torch|jax)\S*", "", t) == re.sub(
                r"\S*(torch|jax)\S*", "", j)
    tb, jb = _vtk_blocks(tmp_path / "torch.vtk"), _vtk_blocks(tmp_path / "jax.vtk")
    assert [h for h, _ in tb] == [h for h, _ in jb]
    assert "CELL_TYPES 12" in [h for h, _ in tb]
    for (h, t), (_, j) in zip(tb, jb):
        assert t.shape == j.shape, h
        if j.size:
            assert np.abs(t - j).max() <= 1e-8 * max(np.abs(j).max(), 1e-30), h
    payload = [json.loads(re.search(r"const D=(\{.*?\});", (
        tmp_path / f"{name}.html").read_text()).group(1))
        for name in ("torch", "jax")]
    assert payload[0]["tri"] == payload[1]["tri"]
    assert payload[0]["pos"] == payload[1]["pos"]


def test_public_names_match_jax_but_the_mixed_system():
    """Every femcy_tpu.__all__ name has a port counterpart, the four of the
    mixed beam + continuum system (ROADMAP slice H, second half) too, and
    the port's __all__ is femcy_tpu's."""
    assert set(T.__all__) == set(F.__all__)
    for name in ("ElementBlock", "MultiBlockSystem", "system_from_model",
                 "BeamModel", "BeamSection", "read_beam_inp", "solve_beam",
                 "MixedModel", "MixedSystem", "read_mixed_inp", "solve_mixed",
                 "BeamBlock", "MixedResult"):
        assert getattr(T, name) is not None
