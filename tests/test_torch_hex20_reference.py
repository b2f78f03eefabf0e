"""C3D20 bricks on the port's general (ELL) path against the benchmark's
plain reference (``fembench/reference/c3d20_elastic.py``, written from the
equations: serendipity shapes, 27 Gauss points, matrix-free), on a jittered
``box_hexes20(2, 2, 2)`` with seeded random displacements: the assembled
operator times u, the Newton path's internal force at large strain, and
the stress recovery at small and large strain.  Both sides are float64
and the same equations in another order of summation (and another 3x3
inverse), so they agree to rounding: 1e-12 of the largest value, where
the readings are 3e-16 (K u) to 7e-15 (small-strain stress).  Also the
spans a C3D20 load case opens, the element blocks of the stiffness einsum,
and the AMG set-up's spans."""

import collections

import numpy as np
import pytest
import torch

import femcy_tpu_torch as T
from femcy_tpu_torch import assembly as tasm
from femcy_tpu_torch.io.inp import DirichletBC, InpModel
from femcy_tpu_torch.meshgen import box_hexes20, unstructured_box_tets
from femcy_tpu_torch.solvers.cg import ell_spmv_plain

from fembench.harness import named

RTOL = 1e-12
MAT = (1000.0, 0.3)


def _mesh(seed=7):
    m = box_hexes20(2, 2, 2)
    rng = np.random.default_rng(seed)
    nodes = m.nodes + rng.uniform(-0.05, 0.05, m.nodes.shape) * 0.5
    return T.FEMesh(nodes, m.elements, m.element)


def _system(mesh, large, **cfg):
    return T.FEMSystem(mesh, T.LinearIsotropic(*MAT), large,
                       T.SolverConfig(sparse_format="ell", **cfg),
                       device="cpu")


def _ref(mesh):
    ref = named.module("reference", "c3d20_elastic")
    return ref.Model(mesh.nodes, mesh.elements, *MAT, "cpu")


def _u(mesh, scale, seed=11):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(scale * rng.standard_normal(mesh.n_dof),
                           dtype=torch.float64)


def _gap(port, ref):
    return float((port - ref).abs().max() / ref.abs().max())


@pytest.fixture(autouse=True)
def _x64(monkeypatch):
    monkeypatch.setenv("FEMCY_TPU_X64", "1")


def test_operator_times_u_is_the_reference_force():
    mesh = _mesh()
    s = _system(mesh, False)
    assert s.dia is None and s.pattern is not None
    u = _u(mesh, 1e-3)
    ku = ell_spmv_plain(s._assemble_values(), s._arrs["colidx"], u)
    f = _ref(mesh).internal_force(u.view(-1, 3), large=False).reshape(-1)
    assert _gap(ku, f) < RTOL


def test_newton_internal_force_is_the_reference_force_at_large_strain():
    mesh = _mesh()
    s = _system(mesh, True)
    u = _u(mesh, 0.05)
    none = torch.zeros(mesh.n_dof, dtype=torch.bool)
    f_int = s._internal_force_parts(u, none, torch.zeros_like(u))[-1]
    f = _ref(mesh).internal_force(u.view(-1, 3), large=True).reshape(-1)
    assert _gap(f_int, f) < RTOL


@pytest.mark.parametrize("large", [False, True])
def test_stress_recovery_is_the_reference_one(large):
    mesh = _mesh()
    s = _system(mesh, large)
    u = _u(mesh, 0.05 if large else 1e-3)
    s.dof = u
    strain, stress, mises = s.compute_strain_stress()
    assert strain.shape == stress.shape == (8, 27, 3, 3)
    r_strain, r_stress, r_mises = _ref(mesh).recover(u.view(-1, 3), large)
    assert _gap(strain, r_strain) < RTOL
    assert _gap(stress, r_stress) < RTOL
    assert _gap(mises, r_mises) < RTOL


def _load_case(mesh):
    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > 1.0 - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, 0, 0.01), DirichletBC(top, 1, -0.005)]
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D20",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic", material_params=list(MAT),
        geometric_nonlinear=False,
        time_incs=dict(ini_inc=1.0, max_time=1.0, min_inc=1e-5, max_inc=1.0))


def _profiled(fn):
    """(fn's result, every profiled host event as (start, end, name))."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _inside(events, outer, inner):
    """Events named ``inner`` (a prefix) that lie inside an ``outer``."""
    spans = [(s, t) for s, t, n in events if n == outer]
    return [(s, t) for s, t, n in events if n.startswith(inner)
            and any(a <= s and t <= b for a, b in spans)]


def test_a_c3d20_load_case_opens_the_linear_path_spans():
    mesh = box_hexes20(2, 2, 2)
    s = _system(mesh, False, linear_solver="cg", preconditioner="amg")
    inp = _load_case(mesh)
    assert s.solve(inp).success
    _, events = _profiled(lambda: (s.solve(inp), s.compute_strain_stress()))
    names = collections.Counter(n for _, _, n in events)
    for span in ("femcy.assemble.ke", "femcy.assemble.scatter",
                 "femcy.dirichlet", "femcy.pcg", "femcy.pcg.iter",
                 "femcy.pcg.precond", "femcy.post"):
        assert names[span] >= 1, span
    # the stiffness einsum's operations run inside the Ke span
    einsums = [e for e in events if e[2] == "aten::einsum"]
    assert einsums
    assert _inside(events, "femcy.assemble.ke", "aten::einsum")
    # one call below the block limit: no block spans
    assert names["femcy.assemble.ke.block"] == 0


def _three_a_block(monkeypatch, dsdx):
    """Patch the block limit to three elements a block (the last block
    shorter)."""
    G, n, dm = dsdx.shape[1:]
    monkeypatch.setattr(tasm, "KE_BLOCK_ENTRIES", 3 * G * (n * dm) ** 2 + 1)


@pytest.mark.parametrize("layout", ["eij", "ije"])
@pytest.mark.parametrize("kind", ["C3D20", "C3D4"])
def test_stiffness_blocks_give_the_one_call_bit_for_bit(kind, layout,
                                                        monkeypatch):
    if kind == "C3D20":
        mesh = _mesh()
    else:
        mesh = unstructured_box_tets(3)
    a = _system(mesh, False)._arrs
    args = (a["dsdX0"], a["vol0"], a["C"])
    whole = tasm.element_stiffness(*args, layout=layout)
    _three_a_block(monkeypatch, a["dsdX0"])
    blocked, events = _profiled(
        lambda: tasm.element_stiffness(*args, layout=layout))
    assert blocked.is_contiguous()
    assert torch.equal(blocked, whole)
    E = mesh.elements.shape[0]
    blocks = [e for e in events if e[2] == "femcy.assemble.ke.block"]
    assert len(blocks) == -(-E // 3)
    # B C, then B^T (C B): two einsums a block, each inside its block
    assert len(_inside(events, "femcy.assemble.ke.block",
                       "aten::einsum")) == 2 * len(blocks)


def test_the_newton_tangent_runs_in_stiffness_blocks(monkeypatch):
    """The general Newton route's material stiffness takes the same
    blocks, inside its tangent span, and the evaluation is unchanged."""
    mesh = _mesh()
    s = _system(mesh, True)
    u = _u(mesh, 0.05)
    none = torch.zeros(mesh.n_dof, dtype=torch.bool)
    rhs = torch.zeros_like(u)
    sval = torch.zeros_like(u)
    _, whole, r_whole = s._newton_eval(u, rhs, none, sval)[:3]
    _three_a_block(monkeypatch, s._arrs["dsdX0"])
    out, events = _profiled(lambda: s._newton_eval(u, rhs, none, sval))
    assert torch.equal(out[1], whole) and torch.equal(out[2], r_whole)
    assert len(_inside(events, "femcy.newton.tangent",
                       "femcy.assemble.ke.block")) == -(-8 // 3)


def test_the_amg_setup_opens_its_spans_once_a_build():
    mesh = box_hexes20(6, 6, 6)  # 3,675 dofs: two levels
    s = _system(mesh, False, linear_solver="cg", preconditioner="amg")
    inp = _load_case(mesh)
    report, events = _profiled(lambda: s.solve(inp))
    assert report.success
    names = collections.Counter(n for _, _, n in events)
    assert names["femcy.setup.amg"] == 1
    for part in ("aggregate", "smooth", "galerkin", "upload"):
        assert _inside(events, "femcy.setup.amg", "femcy.setup.amg." + part)
    # the same fixed-dof mask keeps the hierarchy: no second build
    _, events = _profiled(lambda: s.solve(inp))
    assert not [e for e in events if e[2].startswith("femcy.setup")]
