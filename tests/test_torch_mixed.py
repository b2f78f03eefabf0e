"""Mixed B31-beam + continuum models (femcy_tpu_torch.mixed) against
femcy_tpu's, on the CPU, in float64.

Every model is built once in femcy_tpu (the cases of tests/test_mixed.py:
a beam-only line, a solid-only cantilever, the cantilever stiffened by a
beam spine, a *Dsload on its skin, an inline .inp) and carried over by
``convert.mixed_model_from``.  Tolerances:
- the union pattern (colidx, row counts, width, valid mask, diagonal
  slots, CSR arrays, element dofs and force targets): equal, also with a
  node no element names;
- M6's plain version on the same element matrices: bit-equal to
  femcy_tpu's running ``flat.at[targets].add`` (XLA's CPU scatter adds in
  index order), and the numpy walk of the kernel's plan bit-equal to the
  plain version in f32 and f64; the whole assembly (each package's own
  element einsums, whose sums may round apart) within 1e-14 of
  ``MixedSystem._jit_assemble``;
- direct solves: u and beam end forces within 1e-10 relative, stresses and
  Mises within 1e-9;
- the Jacobi CG on a well-conditioned beam-stiffened box at cg_eps 1e-10:
  iterations at most one apart, x within 1e-7 of the direct one (ROADMAP
  section 3, "Limits of CG parity");
- the CLI: the same lines, numbers within 1e-6 (printed to 7 digits).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femcy_tpu import cli as jcli
from femcy_tpu import mixed as jmx
from femcy_tpu.beam import BeamModel as JBeamModel
from femcy_tpu.beam import BeamSection as JBeamSection
from femcy_tpu.beam import solve_beam as j_solve_beam
from femcy_tpu.io.inp import NeumannBC
from femcy_tpu.materials import LinearIsotropic
from femcy_tpu.meshgen import box_hexes, box_tets, cantilever_tets
from femcy_tpu.multiblock import ElementBlock

import femcy_tpu_torch as T
from femcy_tpu_torch import cli as tcli
from femcy_tpu_torch import convert
from femcy_tpu_torch import mixed as tmx
from femcy_tpu_torch.kernels import mixed_scatter as km6

PATTERN_FIELDS = ("colidx", "row_counts", "valid", "diag_slot", "csr_indptr",
                  "csr_indices", "csr_slots", "element_dofs", "force_targets")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# --------------------------------------------------------------------------- #
# models (femcy_tpu's, as tests/test_mixed.py builds them)
# --------------------------------------------------------------------------- #
def _soft_solid(mesh):
    return ElementBlock(
        elements=mesh.elements, element=mesh.element,
        material=LinearIsotropic(modulus=10.0, poisson_ratio=0.3),
        name="solid",
    )


def _spine(mesh):
    """Beam elements along the bar's top edge (y = z = thickness)."""
    top = np.nonzero(
        (mesh.nodes[:, 1] > mesh.nodes[:, 1].max() - 1e-9)
        & (mesh.nodes[:, 2] > mesh.nodes[:, 2].max() - 1e-9)
    )[0]
    spine = top[np.argsort(mesh.nodes[top, 0])]
    elems = np.stack([spine[:-1], spine[1:]], axis=1).astype(np.int32)
    return spine, jmx.BeamBlock(
        elements=elems, section=JBeamSection.rect(0.2, 0.2),
        E=2.0e5, nu=0.3, name="spine",
    )


def _beam_line():
    n = 9
    nodes = np.zeros((n, 3))
    nodes[:, 0] = np.linspace(0.0, 8.0, n)
    elems = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)
    sec = JBeamSection.rect(0.3, 0.5)
    bc = [(0, d, 0.0) for d in range(6)]
    loads = [(n - 1, 2, -1.0), (n - 1, 4, 0.5)]
    return (jmx.MixedModel(nodes=nodes, solid_blocks=[],
                           beam_blocks=[jmx.BeamBlock(elems, sec, 2.0e5, 0.3)],
                           dirichlet=bc, cloads=loads, neumann_bcs=[]),
            JBeamModel(nodes=nodes, elements=elems, section=sec, E=2.0e5,
                       nu=0.3, dirichlet=bc, loads=loads))


def _solid_only():
    mesh, fixed_nodes, loaded = cantilever_tets(6, 2)
    return jmx.MixedModel(
        nodes=mesh.nodes, solid_blocks=[_soft_solid(mesh)], beam_blocks=[],
        dirichlet=[(int(n), d, 0.0) for n in fixed_nodes for d in range(3)],
        cloads=[(int(n), 1, -0.5) for n in loaded], neumann_bcs=[])


def _stiffened():
    mesh, fixed_nodes, loaded = cantilever_tets(10, 2, length=10.0,
                                                thickness=1.0)
    _, bb = _spine(mesh)
    return jmx.MixedModel(
        nodes=mesh.nodes, solid_blocks=[_soft_solid(mesh)], beam_blocks=[bb],
        dirichlet=[(int(n), d, 0.0) for n in fixed_nodes for d in range(6)],
        cloads=[(int(n), 2, -1.0 / len(loaded)) for n in loaded],
        neumann_bcs=[])


def _dsload():
    mesh, fixed_nodes, loaded = cantilever_tets(6, 2)
    lset = set(loaded.tolist())
    faces = [f for f in mesh.boundary if all(n in lset for n in f)]
    return jmx.MixedModel(
        nodes=mesh.nodes, solid_blocks=[_soft_solid(mesh)], beam_blocks=[],
        dirichlet=[(int(n), d, 0.0) for n in fixed_nodes for d in range(3)],
        cloads=[],
        neumann_bcs=[NeumannBC(face_set=faces, traction=2.0,
                               direction=np.array([0.0, 0.0, 1.0]))])


def _hex_spine():
    """A C3D8 bar (box_hexes(8, 2, 2) over 8 x 1 x 1) under a beam spine
    along its top edge: a continuum block of M6's generic kind beside
    B31."""
    mesh = box_hexes(8, 2, 2, lx=8.0)
    _, bb = _spine(mesh)
    x = mesh.nodes[:, 0]
    fixed, tip = np.nonzero(x < 1e-9)[0], np.nonzero(x > x.max() - 1e-9)[0]
    return jmx.MixedModel(
        nodes=mesh.nodes, solid_blocks=[_soft_solid(mesh)], beam_blocks=[bb],
        dirichlet=[(int(n), d, 0.0) for n in fixed for d in range(6)],
        cloads=[(int(n), 2, -1.0 / len(tip)) for n in tip], neumann_bcs=[])


def _with_orphan(model):
    """``model`` with one more node, numbered in the middle, that no
    element names; its six dofs fixed."""
    k = model.nodes.shape[0] // 2

    def shift(el):
        el = np.array(el)
        return np.where(el >= k, el + 1, el).astype(np.int32)

    nodes = np.insert(model.nodes, k, [[0.5, 0.5, 7.0]], axis=0)
    solids = [ElementBlock(shift(b.elements), b.element, b.material, b.name)
              for b in model.solid_blocks]
    beams = [jmx.BeamBlock(shift(b.elements), b.section, b.E, b.nu, b.name)
             for b in model.beam_blocks]
    move = lambda lst: [(n + (n >= k), d, v) for n, d, v in lst]  # noqa: E731
    return jmx.MixedModel(
        nodes=nodes, solid_blocks=solids, beam_blocks=beams,
        dirichlet=move(model.dirichlet) + [(k, d, 0.0) for d in range(6)],
        cloads=move(model.cloads), neumann_bcs=[])


MODELS = {"spine": _stiffened, "beam-only": lambda: _beam_line()[0],
          "solid-only": _solid_only,
          "orphan": lambda: _with_orphan(_stiffened()),
          "hex-spine": _hex_spine}


def _systems(model, **config):
    """(femcy_tpu's MixedSystem, the port's on the CPU, the port's model)."""
    tmodel = convert.mixed_model_from(model)
    js = jmx.MixedSystem(model.nodes, model.solid_blocks, model.beam_blocks,
                         jmx.SolverConfig(**config))
    ts = tmx.MixedSystem(tmodel.nodes, tmodel.solid_blocks, tmodel.beam_blocks,
                         T.SolverConfig(**config), device="cpu")
    return js, ts, tmodel


def _same_result(tres, jres, u_tol=1e-10):
    assert _rel(tres.u, jres.u) < u_tol
    assert tres.n_auto_fixed == jres.n_auto_fixed
    assert tres.cg_iters == jres.cg_iters
    assert len(tres.solid_stress) == len(jres.solid_stress)
    for ts_, js_, tm_, jm_ in zip(tres.solid_stress, jres.solid_stress,
                                  tres.solid_mises, jres.solid_mises):
        assert ts_.shape == js_.shape and _rel(ts_, js_) < 1e-9
        assert _rel(tm_, jm_) < 1e-9
    assert len(tres.beam_end_forces) == len(jres.beam_end_forces)
    for tf, jf in zip(tres.beam_end_forces, jres.beam_end_forces):
        assert _rel(tf, jf) < 1e-10


# --------------------------------------------------------------------------- #
# the cases of tests/test_mixed.py, on both packages
# --------------------------------------------------------------------------- #
def test_beam_only_matches_jax_and_solve_beam():
    model, beam = _beam_line()
    jres = jmx.solve_mixed(model)
    tres = T.solve_mixed(convert.mixed_model_from(model), device="cpu")
    _same_result(tres, jres)
    bres = T.solve_beam(convert.beam_model_from(beam), device="cpu")
    assert _rel(tres.u, bres.u) < 1e-10
    assert _rel(tres.beam_end_forces[0], bres.end_forces) < 1e-10
    assert _rel(bres.u, j_solve_beam(beam).u) < 1e-10
    assert tres.n_auto_fixed == 0


def test_solid_only_matches_jax_and_femsystem():
    """Only continuum blocks: femcy_tpu's result, every rotation dof auto-
    constrained, and the translations of the port's FEMSystem."""
    model = _solid_only()
    jres = jmx.solve_mixed(model)
    tres = T.solve_mixed(convert.mixed_model_from(model), device="cpu")
    _same_result(tres, jres)
    n_nodes = model.nodes.shape[0]
    assert tres.n_auto_fixed == 3 * n_nodes
    assert np.abs(tres.u[:, 3:]).max() == 0.0

    blk = convert.element_block_from(model.solid_blocks[0])
    mesh = T.FEMesh(model.nodes, blk.elements, blk.element)
    system = T.FEMSystem(mesh, blk.material, False, device="cpu")
    fixed = np.zeros(mesh.n_dof, dtype=bool)
    for n, d, _ in model.dirichlet:
        fixed[n * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    for n, d, v in model.cloads:
        rhs[n * 3 + d] += v
    values, b, _ = system._linear_system(
        torch.as_tensor(rhs), torch.as_tensor(fixed),
        torch.zeros(mesh.n_dof, dtype=torch.float64))
    u_ref = system._solve_linear_system(values, b, torch.as_tensor(fixed))
    assert _rel(tres.u[:, :3], u_ref.numpy().reshape(-1, 3)) < 1e-9


def test_beam_spine_matches_jax_and_stiffens():
    model = _stiffened()
    jres = jmx.solve_mixed(model)
    tmodel = convert.mixed_model_from(model)
    tres = T.solve_mixed(tmodel, device="cpu")
    _same_result(tres, jres)
    loaded = [n for n, _, _ in model.cloads]
    free = dict(model.__dict__, beam_blocks=[],
                dirichlet=[(n, d, v) for n, d, v in model.dirichlet if d < 3])
    tip0 = T.solve_mixed(convert.mixed_model_from(jmx.MixedModel(**free)),
                         device="cpu").u[loaded, 2].mean()
    tip1 = tres.u[loaded, 2].mean()
    assert abs(tip1) < 0.2 * abs(tip0), (tip0, tip1)
    assert np.abs(tres.beam_end_forces[0][:, [4, 5, 10, 11]]).max() > 0.0
    n_spine = np.unique(model.beam_blocks[0].elements).shape[0]
    assert tres.n_auto_fixed == 3 * (model.nodes.shape[0] - n_spine)


def test_dsload_matches_jax():
    model = _dsload()
    jres = jmx.solve_mixed(model)
    tres = T.solve_mixed(convert.mixed_model_from(model), device="cpu")
    _same_result(tres, jres)
    loaded = np.unique(np.concatenate(
        [np.asarray(f) for f in model.neumann_bcs[0].face_set]))
    assert tres.u[loaded, 2].mean() > 0.0


def test_dsload_needs_one_solid_block():
    model = convert.mixed_model_from(_dsload())
    blk = model.solid_blocks[0]
    half = blk.elements.shape[0] // 2
    model.solid_blocks = [
        T.ElementBlock(blk.elements[:half], blk.element, blk.material),
        T.ElementBlock(blk.elements[half:], blk.element, blk.material)]
    with pytest.raises(NotImplementedError, match="one solid block"):
        T.solve_mixed(model, device="cpu")


#: tests/test_mixed.py's model with the rotations of node 2, where the
#: frame meets the solid, held as well: without them the frame turns about
#: node 2 freely and the operator is singular
MIXED_INP = """*Node
1, 0., 0., 0.
2, 1., 0., 0.
3, 0., 1., 0.
4, 0., 0., 1.
5, 1., 1., 0.
6, 2., 0.5, 0.5
7, 3., 0.5, 0.5
*Element, type=C3D4, elset=solid
1, 1, 2, 3, 4
2, 2, 5, 3, 4
*Element, type=B31, elset=frame
3, 2, 6
4, 6, 7
*Nset, nset=fix
1, 3, 4
*Nset, nset=tip
7,
*Nset, nset=joint
2,
*Material, name=steel
*Elastic
200., 0.3
*Beam Section, elset=frame, section=RECT, material=steel
0.2, 0.2
*Boundary
fix, 1, 3, 0.
joint, 4, 6, 0.
*Cload
tip, 3, -0.01
*Step
*Static
1., 1., 1e-5, 1.
*End Step
"""


def test_read_mixed_inp_matches_jax(tmp_path):
    path = tmp_path / "mixed.inp"
    path.write_text(MIXED_INP)
    jm = jmx.read_mixed_inp(str(path))
    tm = T.read_mixed_inp(str(path))
    np.testing.assert_array_equal(tm.nodes, jm.nodes)
    assert tm.dirichlet == jm.dirichlet and tm.cloads == [(6, 2, -0.01)]
    assert tm.cloads == jm.cloads
    for tb, jb in zip(tm.solid_blocks, jm.solid_blocks):
        np.testing.assert_array_equal(tb.elements, jb.elements)
        assert tb.element.name == jb.element.name and tb.name == jb.name
        np.testing.assert_array_equal(tb.material.C, np.asarray(jb.material.C))
    assert len(tm.beam_blocks) == len(jm.beam_blocks) == 1
    tb, jb = tm.beam_blocks[0], jm.beam_blocks[0]
    np.testing.assert_array_equal(tb.elements, jb.elements)
    assert (tb.E, tb.nu, tb.name) == (jb.E, jb.nu, jb.name)
    assert tb.section == convert.beam_block_from(jb).section
    tres = T.solve_mixed(tm, device="cpu")
    _same_result(tres, jmx.solve_mixed(jm))
    assert tres.u[6, 2] < 0.0
    assert np.abs(tres.beam_end_forces[0][:, [4, 5, 10, 11]]).max() > 0


def test_cli_prints_jax_lines(tmp_path, capsys):
    path = tmp_path / "mixed.inp"
    path.write_text(MIXED_INP)
    argv = [str(path), "--platform", "cpu"]
    assert jcli.main(argv) == 0
    j_out = capsys.readouterr().out
    assert tcli.main(argv) == 0
    t_out = capsys.readouterr().out
    t_lines, j_lines = t_out.splitlines(), j_out.splitlines()
    assert len(t_lines) == len(j_lines) == 7
    assert t_lines[0].startswith("mixed model: 2 continuum elements")
    for t, j in zip(t_lines, j_lines):
        if j.startswith("solve time:"):
            assert re.sub(r"[\d.]+s", "", t) == re.sub(r"[\d.]+s", "", j)
        elif " = " in j:
            (tk, tv), (jk, jv) = t.split(" = "), j.split(" = ")
            assert tk == jk and tv.split()[1:] == jv.split()[1:]
            assert abs(float(tv.split()[0]) - float(jv.split()[0])) <= (
                1e-6 * max(abs(float(jv.split()[0])), 1e-30))
        else:
            assert t == j


# --------------------------------------------------------------------------- #
# the union pattern and M6
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(MODELS))
def test_union_pattern_matches_jax(name):
    model = MODELS[name]()
    jp, _, _ = jmx._union_pattern_6dof(model.nodes.shape[0], model.solid_blocks,
                                       model.beam_blocks)
    tmodel = convert.mixed_model_from(model)
    tp, positions = tmx.build_union_pattern_6dof(
        tmodel.nodes.shape[0], tmodel.solid_blocks, tmodel.beam_blocks)
    assert tp.width == jp.width and tp.n_dof == jp.n_dof
    for field in PATTERN_FIELDS:
        a, b = getattr(tp, field), np.asarray(getattr(jp, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # the plan's run starts give femcy_tpu's dof-level targets, block by
    # block
    _, targets, _ = jmx._union_pattern_6dof(
        model.nodes.shape[0], model.solid_blocks, model.beam_blocks)
    plan = km6.build_mixed_plan(
        tp.n_dof // 6, tp.width,
        [b.elements for b in tmodel.solid_blocks + tmodel.beam_blocks],
        [3] * len(tmodel.solid_blocks) + [6] * len(tmodel.beam_blocks),
        positions, "cpu")
    for tt, jt in zip(km6.contribution_targets(plan), targets):
        np.testing.assert_array_equal(tt.numpy(), jt)
    if name == "orphan":
        k = int(np.nonzero(model.nodes[:, 2] == 7.0)[0][0])
        rows = slice(6 * k, 6 * k + 6)
        assert (tp.row_counts[rows] == 1).all()
        assert (tp.colidx[rows, 0] == np.arange(6 * k, 6 * k + 6)).all()


def _element_matrices(ts, seed=None, dtype=np.float64):
    """The port system's element matrices as numpy, or seeded random ones
    of the same shapes."""
    if seed is None:
        return [k.numpy().astype(dtype) for k in ts._element_matrices()]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(k.shape)).astype(dtype)
            for k in ts._element_matrices()]


@pytest.mark.parametrize("name", ["spine", "orphan"])
def test_plain_scatter_is_jax_scatter(name):
    """M6's plain version on the same element matrices is femcy_tpu's
    running indexed add bit for bit; each package's whole assembly (its
    own element einsums) agrees within 1e-14."""
    model = MODELS[name]()
    js, ts, _ = _systems(model)
    kes = _element_matrices(ts)
    flat = jnp.zeros(js.n_dof * js.pattern.width)
    for ke, t in zip(kes, js._targets):
        flat = flat.at[jnp.asarray(t)].add(jnp.asarray(ke).reshape(-1))
    plain = km6.scatter_plain([torch.from_numpy(k) for k in kes], ts._plan)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(flat).reshape(plain.shape))
    jv = np.asarray(js._jit_assemble(jnp.asarray(js.nodes)))
    assert _rel(ts._assemble(), jv) < 1e-14
    # the f64 host twin, summed over dof pairs without pattern or plan,
    # against femcy_tpu's values read through femcy_tpu's pattern
    host = tmx.union_operator_host(ts.nodes, ts.solid_blocks, ts.beam_blocks)
    jcsr = js.pattern.to_scipy(jv)
    assert abs(host - jcsr).max() / abs(jcsr).max() < 1e-14


def _decode(stored):
    return ~stored if stored < 0 else stored


def _plan_walk(kes, plan):
    """The M6 kernel's rule in numpy, node by node: the node's translation
    rows zeroed in its warp's shared row (in the output on a wide plan),
    its rotation rows zeroed in the output; its pair ids and their first
    four run starts read 32 pairs at a time (the window); its pairs walked
    in order, in runs of one block, each run with the block's kind: local
    pair q = p - offset_b's band, values q * band to (q + 1) * band of the
    block's element matrices, added into the slots (di, start + dj), start
    the translation run start of b for di < 3 and its rotation run start
    for di >= 3, rotation values into the output rows -- one b at a time
    where the element names a node twice.  C3D4 and B31 take their starts
    from the window, a generic block from the pair's own row of npe.  At
    the end the shared rows are copied out."""
    ptr, pairs = plan.node_ptr.numpy(), plan.pairs.numpy()
    pos = plan.positions.numpy().astype(np.int64).reshape(-1, plan.stride)
    offsets = list(plan.pair_offsets) + [2**31 - 1]
    W = plan.width
    out = np.full(plan.out_shape, np.nan, dtype=kes[0].dtype)
    for n in range(plan.n_nodes):
        lo, count = int(ptr[n]), int(ptr[n + 1] - ptr[n])
        dst = out[6 * n:6 * n + 6]
        dst[3:] = 0
        trans = dst[:3] if plan.wide else np.empty((3, W), kes[0].dtype)
        trans[:] = 0
        window = {"first": 0}

        def fetch(t):
            window.update(first=t, ids=pairs[lo + t:lo + min(t + 32, count)],
                          starts=pos[lo + t:lo + min(t + 32, count), :4])

        def id_at(t):
            if t >= window["first"] + 32:
                fetch(t)
            return int(window["ids"][t - window["first"]])

        fetch(0)
        b, t = 0, 0
        while t < count:
            while offsets[b + 1] <= _decode(id_at(t)):
                b += 1
            _, npe, dm = plan.blocks[b]
            flat = kes[b].reshape(-1)
            di = np.arange(dm)[:, None, None]
            k = np.broadcast_to(np.where(di >= 3, 2, 0)
                                + np.arange(npe)[None, :, None], (dm, npe, dm))
            rows = np.broadcast_to(di, (dm, npe, dm))
            dj = np.broadcast_to(np.arange(dm)[None, None, :], (dm, npe, dm))
            while True:
                stored = id_at(t)
                q = _decode(stored) - offsets[b]
                band = flat[q * dm * npe * dm:(q + 1) * dm * npe * dm]
                band = band.reshape(dm, npe, dm)
                if plan.kinds[b] == km6.KIND_GENERIC:
                    starts = pos[lo + t, :npe]
                else:
                    starts = window["starts"][t - window["first"]]
                slots = starts[k] + dj
                for bb in (range(npe) if stored < 0 else [None]):
                    sel = np.broadcast_to(
                        True if bb is None
                        else np.arange(npe)[None, :, None] == bb, band.shape)
                    tr = sel & (rows < 3)
                    trans[rows[tr], slots[tr]] += band[tr]
                    ro = sel & (rows >= 3)
                    dst[rows[ro], slots[ro]] += band[ro]
                t += 1
                if t >= count:
                    break
                if _decode(id_at(t)) >= offsets[b + 1]:
                    break
        if not plan.wide:
            dst[:3] = trans
    return out


def _collapsed(model):
    """``model`` with its first element's last node replaced by the one
    before it: an element that names a node twice."""
    blk = model.solid_blocks[0]
    el = np.array(blk.elements)
    el[0, -1] = el[0, -2]
    return jmx.MixedModel(**dict(
        model.__dict__, solid_blocks=[ElementBlock(el, blk.element,
                                                   blk.material)]))


def _plan_args(ts):
    """``build_mixed_plan``'s arguments for the port system ``ts``."""
    blocks = ts.solid_blocks + ts.beam_blocks
    return (ts.n_nodes, ts.pattern.width, [b.elements for b in blocks],
            [3] * len(ts.solid_blocks) + [6] * len(ts.beam_blocks),
            ts._block_positions, "cpu")


@pytest.mark.parametrize("name", ["spine", "orphan", "collapsed", "wide",
                                  "hex-spine"])
def test_kernel_plan_walk_matches_plain(name, monkeypatch):
    """The plan walk is bit-equal to the plain version (and to femcy_tpu's
    scatter) on seeded random element matrices, in f32 and f64; the CPU
    wrapper runs the plain version and counts no launch.  "wide" is the
    spine's plan built wide (its shared row cut below its width);
    "hex-spine" a C3D8 block of the generic kind, its first hex
    collapsed."""
    model = {"collapsed": lambda: _collapsed(_stiffened()),
             "wide": _stiffened,
             "hex-spine": lambda: _collapsed(_hex_spine())}.get(
                 name, MODELS.get(name))()
    js, ts, _ = _systems(model)
    plan = ts._plan
    if name == "wide":
        monkeypatch.setattr(km6, "SHARED_ROW_BYTES",
                            3 * 8 * (ts.pattern.width - 1))
        plan = km6.build_mixed_plan(*_plan_args(ts))
    assert plan.wide == (name == "wide")
    assert plan.positions.dtype == (torch.int32 if plan.wide else torch.int16)
    kinds = {"hex-spine": (km6.KIND_GENERIC, km6.KIND_BEAM)}.get(
        name, (km6.KIND_TET, km6.KIND_BEAM))
    assert plan.kinds == kinds and plan.stride == (8 if name == "hex-spine"
                                                   else 4)
    n_flagged = int((plan.pairs < 0).sum())
    if name in ("collapsed", "hex-spine"):
        # the collapsed element's pairs
        assert n_flagged == model.solid_blocks[0].elements.shape[1]
    else:
        assert n_flagged == 0
    for dtype in (np.float32, np.float64):
        kes = _element_matrices(ts, seed=5, dtype=dtype)
        before = km6.scatter.launches
        plain = km6.scatter([torch.from_numpy(k) for k in kes], plan)
        assert km6.scatter.launches == before
        assert plain.dtype == torch.from_numpy(kes[0]).dtype
        walk = _plan_walk(kes, plan)
        np.testing.assert_array_equal(walk, plain.numpy())
        assert (walk[~ts.pattern.valid] == 0).all()
        if dtype == np.float64:
            flat = jnp.zeros(js.n_dof * js.pattern.width)
            for ke, t in zip(kes, js._targets):
                flat = flat.at[jnp.asarray(t)].add(jnp.asarray(ke).reshape(-1))
            np.testing.assert_array_equal(walk.reshape(-1), np.asarray(flat))


def test_plan_refuses_a_row_group_past_the_shared_row(monkeypatch):
    """Past SHARED_ROW_BYTES the plan no longer refuses: it is wide (int32
    run starts, the same pairs), and its walk equals the plain version;
    translation rows that just fit build the system's int16 plan."""
    _, ts, _ = _systems(_stiffened())
    args = _plan_args(ts)
    monkeypatch.setattr(km6, "SHARED_ROW_BYTES", 3 * 8 * ts.pattern.width)
    fits = km6.build_mixed_plan(*args)
    assert not fits.wide and fits.positions.dtype == torch.int16
    assert torch.equal(fits.positions, ts._plan.positions)
    assert torch.equal(fits.pairs, ts._plan.pairs)
    monkeypatch.setattr(km6, "SHARED_ROW_BYTES",
                        3 * 8 * (ts.pattern.width - 1))
    wide = km6.build_mixed_plan(*args)
    assert wide.wide and wide.positions.dtype == torch.int32
    assert torch.equal(wide.positions.long(), ts._plan.positions.long())
    assert torch.equal(wide.pairs, ts._plan.pairs)
    kes = _element_matrices(ts, seed=6)
    np.testing.assert_array_equal(
        _plan_walk(kes, wide),
        km6.scatter_plain([torch.from_numpy(k) for k in kes], wide).numpy())


def test_scatter_wrapper_rejects_bad_operands():
    _, ts, _ = _systems(_stiffened())
    kes = ts._element_matrices()
    with pytest.raises(ValueError, match="blocks of element matrices"):
        km6.scatter(kes[:1], ts._plan)
    with pytest.raises(ValueError, match="shape"):
        km6.scatter([kes[0][:-1].contiguous(), kes[1]], ts._plan)
    with pytest.raises(TypeError, match="float32 or float64"):
        km6.scatter([kes[0], kes[1].float()], ts._plan)
    with pytest.raises(ValueError, match="contiguous"):
        km6.scatter([kes[0].transpose(1, 2), kes[1]], ts._plan)


def _stiffened_box(n=4):
    """box_tets(n) (E 1000) under a grid of B31 members on its z = 1 face
    (every x- and y-line; E 2e5, 0.05 x 0.05), the z = 0 face's
    translations clamped, an x-load on the z = 1 nodes: well conditioned
    for the CG."""
    mesh = box_tets(n, n, n)
    z = mesh.nodes[:, 2]
    top = np.nonzero(z > 1 - 1e-9)[0]
    grid = top[np.lexsort((mesh.nodes[top, 0], mesh.nodes[top, 1]))]
    grid = grid.reshape(n + 1, n + 1)
    members = np.concatenate([
        np.stack([grid[:, :-1].ravel(), grid[:, 1:].ravel()], 1),
        np.stack([grid[:-1, :].ravel(), grid[1:, :].ravel()], 1)])
    return jmx.MixedModel(
        nodes=mesh.nodes,
        solid_blocks=[ElementBlock(mesh.elements, mesh.element,
                                   LinearIsotropic(1000.0, 0.3))],
        beam_blocks=[jmx.BeamBlock(members.astype(np.int32),
                                   JBeamSection.rect(0.05, 0.05), 2.0e5, 0.3)],
        dirichlet=[(int(b), d, 0.0) for b in np.nonzero(z < 1e-9)[0]
                   for d in range(3)],
        cloads=[(int(t), 0, 1.0 / top.size) for t in top], neumann_bcs=[])


def test_cg_matches_direct_and_jax():
    model = _stiffened_box()
    js, ts, tmodel = _systems(model, linear_solver="cg", cg_eps=1e-10)
    jres = js.solve(model)
    tres = ts.solve(tmodel)
    direct = T.solve_mixed(tmodel, T.SolverConfig(linear_solver="direct"),
                           device="cpu")
    assert tres.cg_iters > 0 and abs(tres.cg_iters - jres.cg_iters) <= 1
    assert ts._last_cg_iters == tres.cg_iters
    assert _rel(tres.u, direct.u) < 1e-7
    assert _rel(tres.u, jres.u) < 1e-7


@pytest.mark.parametrize("entry", ["MixedSystem", "solve_mixed"])
def test_default_device_is_the_card(monkeypatch, entry):
    """MixedSystem and solve_mixed default to CUDA: with no card that
    default raises as device="cuda" does, and device="cpu" runs."""
    model = convert.mixed_model_from(_beam_line()[0])
    if entry == "MixedSystem":
        def build(**kw):
            return T.MixedSystem(model.nodes, model.solid_blocks,
                                 model.beam_blocks, **kw).device
    else:
        def build(**kw):
            T.solve_mixed(model, **kw)
            return torch.device(kw["device"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        build()
    assert build(device="cpu") == torch.device("cpu")
