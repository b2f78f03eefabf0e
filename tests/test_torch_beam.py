"""B31 beams (femcy_tpu_torch.beam) against femcy_tpu.beam, on the CPU, in
float64.

The same models (femcy_tpu's ``BeamModel``, carried over by
``convert.beam_model_from``, or one ``.inp`` text read by both readers)
go through both ``solve_beam``s: the tip-loaded cantilevers of
tests/test_beam.py (one and eight elements, against the Timoshenko closed
form), the axial + torsion cantilever, the rotated frame and a 3-D lattice
with loads on every top node.  Tolerances: displacements, reactions and
end forces within 1e-10 relative to each array's largest entry (the same
products summed in another order, and a Cholesky solve for femcy_tpu's
dense SPD solve); the closed forms within 1e-9 as in tests/test_beam.py;
the readers' models equal field for field; the CLI's printed lines equal
femcy_tpu.cli's but the solve time, numbers within 1e-6 relative (printed
with 7 significant digits).
"""

import numpy as np
import pytest
import torch

from femcy_tpu import beam as jbeam
from femcy_tpu import cli as jcli

import femcy_tpu_torch as T
from femcy_tpu_torch import beam as tbeam
from femcy_tpu_torch import cli as tcli
from femcy_tpu_torch import convert

E = 210.0e9
NU = 0.3
G = E / (2 * (1 + NU))
TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _cantilever(n_el, length, section):
    x = np.linspace(0.0, length, n_el + 1)
    nodes = np.stack([x, np.zeros_like(x), np.zeros_like(x)], axis=1)
    elements = np.stack([np.arange(n_el), np.arange(1, n_el + 1)],
                        axis=1).astype(np.int32)
    return jbeam.BeamModel(nodes=nodes, elements=elements, section=section,
                           E=E, nu=NU, dirichlet=[(0, d, 0.0) for d in range(6)])


def lattice(n, section, seed=0):
    """A 3-D frame of n x n x n unit bays: members along x, y and z between
    neighbouring grid nodes, the z=0 nodes encastred, a seeded load of up
    to 1 kN along each axis on every z=n node."""
    g = np.arange(n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float64)
    nid = np.arange(nodes.shape[0]).reshape(n + 1, n + 1, n + 1)
    members = [np.stack([nid[:-1].ravel(), nid[1:].ravel()], 1),
               np.stack([nid[:, :-1].ravel(), nid[:, 1:].ravel()], 1),
               np.stack([nid[:, :, :-1].ravel(), nid[:, :, 1:].ravel()], 1)]
    rng = np.random.default_rng(seed)
    top = nid[:, :, n].ravel()
    loads = [(int(t), d, float(v)) for t, row in
             zip(top, rng.uniform(-1e3, 1e3, (top.size, 3)))
             for d, v in enumerate(row)]
    return jbeam.BeamModel(
        nodes=nodes, elements=np.concatenate(members).astype(np.int32),
        section=section, E=E, nu=NU,
        dirichlet=[(int(b), d, 0.0) for b in nid[:, :, 0].ravel()
                   for d in range(6)],
        loads=loads)


def _both(model):
    return (jbeam.solve_beam(model),
            tbeam.solve_beam(convert.beam_model_from(model), device="cpu"))


def _same(jr, tr):
    assert tr.u.shape == jr.u.shape and tr.u.dtype == np.float64
    for field in ("u", "reactions", "end_forces"):
        assert _rel(getattr(tr, field), getattr(jr, field)) < TOL, field


@pytest.mark.parametrize("n_el", [1, 8])
def test_cantilever_tip_load_matches_jax_and_timoshenko(n_el):
    L, a, b, P = 2.0, 0.05, 0.08, 1000.0
    sec = jbeam.BeamSection.rect(a, b)
    m = _cantilever(n_el, L, sec)
    m.loads = [(n_el, 1, P)]
    jr, tr = _both(m)
    _same(jr, tr)
    exact = P * L**3 / (3 * E * sec.I11) + P * L / (G * sec.kappa2 * sec.A)
    assert tr.u[n_el, 1] == pytest.approx(exact, rel=1e-9)
    assert tr.reactions[0, 1] == pytest.approx(-P, rel=1e-9)
    assert abs(tr.reactions[0, 3:]).max() == pytest.approx(P * L, rel=1e-9)
    assert set(tr.seconds) == {"assemble", "factor", "solve", "recover"}


def test_cantilever_axial_and_torsion_matches_jax():
    L, r = 3.0, 0.04
    sec = jbeam.BeamSection.circ(r)
    m = _cantilever(4, L, sec)
    m.loads = [(4, 0, 5.0e4), (4, 3, 2.0e3)]
    jr, tr = _both(m)
    _same(jr, tr)
    assert tr.u[4, 0] == pytest.approx(5.0e4 * L / (E * sec.A), rel=1e-9)
    assert tr.u[4, 3] == pytest.approx(2.0e3 * L / (G * sec.J), rel=1e-9)
    assert tr.end_forces[-1, 6] == pytest.approx(5.0e4, rel=1e-6)
    assert tr.end_forces[-1, 9] == pytest.approx(2.0e3, rel=1e-6)


def test_rotated_frame_matches_jax():
    L, a, b, P = 2.0, 0.05, 0.08, 1000.0
    cx, sx = np.cos(0.3), np.sin(0.3)
    cz, sz = np.cos(-0.7), np.sin(-0.7)
    Q = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    m = _cantilever(6, L, jbeam.BeamSection.rect(
        a, b, n1=tuple(Q @ np.array([0.0, 0.0, -1.0]))))
    m.nodes = m.nodes @ Q.T
    load = Q @ np.array([0.0, P, 0.0])
    m.loads = [(6, d, load[d]) for d in range(3)]
    jr, tr = _both(m)
    _same(jr, tr)


@pytest.mark.parametrize("n, n1", [(2, (0.0, 0.0, -1.0)), (3, (1.0, 0.0, 0.0))],
                         ids=["default n1", "n1 along x"])
def test_lattice_matches_jax(n, n1):
    """Every node of a 3-D frame joins up to six members; with n1 along x
    the x-members take the fallback section axis."""
    m = lattice(n, jbeam.BeamSection.rect(0.05, 0.08, n1=n1))
    jr, tr = _both(m)
    _same(jr, tr)
    applied = np.zeros(3)
    for _, d, v in m.loads:
        applied[d] += v
    np.testing.assert_allclose(tr.reactions[:, :3].sum(0), -applied,
                               rtol=1e-9, atol=1e-9 * np.abs(applied).max())


def test_local_stiffness_and_frames_match_jax():
    import jax.numpy as jnp

    m = lattice(2, jbeam.BeamSection.circ(0.03))
    L, R = jbeam._element_frames(m.nodes, m.elements, m.section.n1)
    tL, tR = tbeam._element_frames(m.nodes, m.elements, m.section.n1)
    assert np.array_equal(tL, L) and np.array_equal(tR, R)
    sec = convert.beam_model_from(m).section
    k_j = np.asarray(jbeam._local_stiffness(jnp.asarray(L), E, G, m.section))
    k_t = tbeam._local_stiffness(torch.as_tensor(L), E, G, sec).numpy()
    assert _rel(k_t, k_j) < 1e-15


_ROUNDTRIP = """*Heading
 cantilever B31
*Node
1, 0., 0., 0.
2, 1., 0., 0.
3, 2., 0., 0.
*Element, type=B31
1, 1, 2
** a comment inside the block
2, 2, 3
*Nset, nset=root
1,
*Nset, nset=tip
3,
*Beam Section, elset=all, material=steel, section=RECT
0.05, 0.08
0., 0., -1.
*Material, name=steel
*Elastic
210.e9, 0.3
*Boundary
root, ENCASTRE
*Step
*Static
*Cload
tip, 2, 1000.
*End Step
"""

_GENERAL = """*Node
1, 0., 0., 0.
2, 0., 0., 1.5
*Element, type=B31
1, 1, 2
*Beam General Section, elset=all, material=m
1.0e-3, 2.0e-7, 0., 2.0e-7, 4.0e-7
1., 0., 0.
*Material, name=m
*Elastic
70.e9, 0.33
*Boundary
1, 1, 6
*Cload
2, 3, -250.
"""


@pytest.mark.parametrize("text", [_ROUNDTRIP, _GENERAL,
                                  _ROUNDTRIP.replace("RECT\n0.05, 0.08",
                                                     "CIRC\n0.02")],
                         ids=["rect + named bc", "general + dof range", "circ"])
def test_read_beam_inp_matches_jax(tmp_path, text):
    path = tmp_path / "beam.inp"
    path.write_text(text)
    jm, tm = jbeam.read_beam_inp(str(path)), T.read_beam_inp(str(path))
    assert np.array_equal(tm.nodes, jm.nodes)
    assert tm.elements.dtype == np.int32
    assert np.array_equal(tm.elements, jm.elements)
    assert tm.section == convert.beam_model_from(jm).section
    assert (tm.E, tm.nu) == (jm.E, jm.nu)
    assert tm.dirichlet == jm.dirichlet and tm.loads == jm.loads
    _same(jbeam.solve_beam(jm), T.solve_beam(tm, device="cpu"))


def test_unsupported_and_singular_models_raise():
    m = convert.beam_model_from(_cantilever(2, 1.0, jbeam.BeamSection.circ(0.02)))
    m.dirichlet = []
    with pytest.raises(ValueError, match="no supports"):
        T.solve_beam(m, device="cpu")
    m.dirichlet = [(0, d, 0.0) for d in range(6)]
    m.nodes = np.concatenate([m.nodes, [[5.0, 5.0, 5.0]]])  # no member
    with pytest.raises(RuntimeError, match="not positive definite"):
        T.solve_beam(m, device="cpu")


def test_solve_beam_defaults_to_the_card(monkeypatch):
    m = convert.beam_model_from(_cantilever(1, 1.0, jbeam.BeamSection.circ(0.02)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        T.solve_beam(m)


def _lattice_inp(n):
    """lattice(n) as a .inp: the bottom nodes ENCASTRE by a node set, the
    loads as *Cload lines by node id."""
    m = lattice(n, jbeam.BeamSection.rect(0.05, 0.08))
    lines = ["*Heading", "B31 lattice", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(m.nodes)]
    lines.append("*Element, type=B31, elset=frame")
    lines += [f"{e + 1}, {a + 1}, {b + 1}" for e, (a, b) in enumerate(m.elements)]
    base = sorted({node for node, _, _ in m.dirichlet})
    lines += ["*Nset, nset=base", ", ".join(str(b + 1) for b in base),
              "*Beam Section, elset=frame, material=steel, section=RECT",
              "0.05, 0.08", "0., 0., -1.",
              "*Material, name=steel", "*Elastic", "210.e9, 0.3",
              "*Boundary", "base, ENCASTRE", "*Step", "*Static", "*Cload"]
    lines += [f"{node + 1}, {d + 1}, {v!r}" for node, d, v in m.loads]
    return "\n".join(lines + ["*End Step"]) + "\n"


def test_cli_b31_lines_match_jax(tmp_path, capsys):
    path = tmp_path / "frame.inp"
    path.write_text(_lattice_inp(2))
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        rc = main([str(path), "--platform", "cpu"])
        outs[name] = (rc, capsys.readouterr().out.splitlines())
    (j_rc, j_lines), (t_rc, t_lines) = outs["jax"], outs["torch"]
    assert t_rc == j_rc == 0
    assert t_lines[0] == j_lines[0] == (
        "model: 54 B31 elements, 27 nodes, 162 dofs (6/node)")
    assert len(t_lines) == len(j_lines) == 7
    for t, j in zip(t_lines[1:-1], j_lines[1:-1]):
        t_key, t_val = t.split(" = ")
        j_key, j_val = j.split(" = ")
        assert t_key == j_key
        t_num, j_num = float(t_val.split()[0]), float(j_val.split()[0])
        assert abs(t_num - j_num) <= 1e-6 * abs(j_num)
        assert t_val.split()[1:] == j_val.split()[1:]  # the node named
    assert t_lines[-1].startswith("solve time: ")
