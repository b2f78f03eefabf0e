"""femcy_tpu's public surface in the port, and parity of the functions that
no other test of the port names.

- every ``__all__`` of femcy_tpu's sub-packages is a subset of the port's;
- module by module (an ``ast`` walk of both trees, ``kernels/`` aside),
  every public top-level function, class, constant and public method of
  femcy_tpu has a same-named counterpart in the port, but for the TPU
  plumbing of ``EXCLUDED``;
- ``structured_assemble``, ``analytic_dia_values_device``,
  ``assembly.internal_force`` and the public ``solvers.ell_spmv`` /
  ``solvers.pcg_solve`` against femcy_tpu on numpy-seeded inputs, and the
  CUDA dispatch of the last two (M2, never the plain gather);
- direct parity cases for eleven small public helpers.

Tolerances: float64 results agree to 1e-13 or 1e-12 relative to the
largest entry (the same arithmetic in another summation order), float32
to 1e-5; host numpy helpers copied from femcy_tpu agree exactly.
"""

import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu.assembly as jasm
import femcy_tpu.materials as jmat
import femcy_tpu.solvers as jsolvers
from femcy_tpu.meshgen import box_tets as j_box
from femcy_tpu.meshgen import unstructured_box_tets as j_unstructured
from femcy_tpu.solvers.dia import build_structured_dia_pattern as j_dia_pattern
from femcy_tpu import structured as jst

import femcy_tpu_torch.assembly as tasm
import femcy_tpu_torch.solvers as tsolvers
from femcy_tpu_torch import convert
from femcy_tpu_torch import structured as tst
from femcy_tpu_torch.kernels import ell_spmv as k_ell
from femcy_tpu_torch.kernels import internal_force as k_force
from femcy_tpu_torch.kernels import structured_accumulate as k_acc
from femcy_tpu_torch.kernels.ell_scatter import build_scatter_plan
from femcy_tpu_torch.solvers import cg as tcg
from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
from femcy_tpu_torch.topology import build_pattern

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "femcy_tpu", REPO / "femcy_tpu_torch"

#: femcy_tpu's public names that the port leaves out on purpose: TPU
#: plumbing with no counterpart on the card (ROADMAP section 1)
EXCLUDED = {
    "structured.py": {
        "pallas_assembly_eligible": "a TPU backend test for the Pallas "
                                    "assembly; the port picks its route by "
                                    "device (structured.auto_accumulate)",
    },
    "solvers/multigrid.py": {
        "newton_schulz_inverse": "a matmul-only inverse for the TPU's "
                                 "coarse solve; the port inverts on the host",
        "StructuredMultigrid.operands": "the jit operands of the JAX "
                                        "hierarchy",
    },
    "solvers/amg.py": {
        "AlgebraicMultigrid.operands": "the jit operands of the JAX "
                                       "hierarchy",
    },
    "parallel/banded.py": {"AXIS": "the name of a JAX mesh axis"},
    "parallel/sharded.py": {"AXIS": "the name of a JAX mesh axis"},
    "parallel/structured.py": {"AXIS": "the name of a JAX mesh axis"},
    "mixed.py": {"logger": "never used in femcy_tpu.mixed"},
    "native/loader.py": {
        "logger": "warns before femcy_tpu's numpy fallback; the port's "
                  "loader raises instead",
    },
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _public_names(path: pathlib.Path) -> set:
    """Public top-level functions, classes and assigned names of a module,
    and ``Class.method`` for the public methods of its public classes."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not sub.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name)
                         and not t.id.startswith("_"))
    return names


JAX_MODULES = sorted(
    str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
    if p.relative_to(JAX_PKG).parts[0] != "kernels")


@pytest.mark.parametrize("sub", ["io", "materials", "elements", "utils",
                                 "solvers", "parallel"])
def test_subpackage_all_is_a_subset(sub):
    ref = importlib.import_module(f"femcy_tpu.{sub}")
    port = importlib.import_module(f"femcy_tpu_torch.{sub}")
    assert set(ref.__all__) <= set(port.__all__), sorted(
        set(ref.__all__) - set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name


def test_solvers_reexports():
    """femcy_tpu's three names and the port's two DIA extras import from
    the package, and the first two are cg's dispatching functions."""
    from femcy_tpu_torch.solvers import (  # noqa: F401
        dia_pcg_solve, dia_spmv, direct_solve, ell_spmv, pcg_solve)

    assert ell_spmv is tcg.ell_spmv and pcg_solve is tcg.pcg_solve
    assert ell_spmv is not tcg.ell_spmv_plain


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_surface_matches(module):
    port_path = PORT_PKG / module
    assert port_path.exists(), f"the port has no {module}"
    ref, port = _public_names(JAX_PKG / module), _public_names(port_path)
    excluded = set(EXCLUDED.get(module, {}))
    # the table holds exactly names femcy_tpu has and the port lacks
    assert excluded <= ref, sorted(excluded - ref)
    assert not excluded & port, sorted(excluded & port)
    missing = ref - port - excluded
    assert not missing, sorted(missing)


def test_exclusion_table_names_only_modules_that_exist():
    assert set(EXCLUDED) <= set(JAX_MODULES)
    assert all(reason for names in EXCLUDED.values()
               for reason in names.values())


# --- structured_assemble ------------------------------------------------


def _box_inputs(jitter: bool, dtype):
    """box_tets(3, 4, 2), its plans and the (E, G, 4, 3) gradients and
    (E, G) volumes of its nodes, moved by up to 0.1 cell when ``jitter``."""
    jm = j_box(3, 4, 2)
    tm = convert.mesh_from(jm)
    nodes = np.array(jm.nodes)
    if jitter:
        cell = np.array([1 / 3, 1 / 4, 1 / 2])
        nodes = nodes + 0.1 * cell * np.random.default_rng(4).uniform(
            -1, 1, nodes.shape)
    dN = np.asarray(jm.element.dshape_at_gp)
    w = np.asarray(jm.element.gauss_weights)
    dsdx, vol = jasm.gradients_and_volume(
        jnp.asarray(nodes), jnp.asarray(jm.elements), jnp.asarray(dN),
        jnp.asarray(w))
    C = np.asarray(jmat.LinearIsotropic(200.0, 0.3).C)
    arrays = [np.array(a, dtype=dtype) for a in (dsdx, vol, C)]
    jplan = jst.build_structured_plan(jm, j_dia_pattern(jm))
    tplan = tst.build_structured_plan(tm, build_structured_dia_pattern(tm))
    return arrays, jplan, tplan


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("jitter", [False, True])
def test_structured_assemble_matches_jax(jitter, dtype, tol):
    (dsdx, vol, C), jplan, tplan = _box_inputs(jitter, dtype)
    ref = np.asarray(jst.structured_assemble(
        jnp.asarray(dsdx), jnp.asarray(vol), jnp.asarray(C), jplan))
    before = k_acc.accumulate.launches
    got = tst.structured_assemble(torch.from_numpy(dsdx),
                                  torch.from_numpy(vol), torch.from_numpy(C),
                                  tplan)
    assert k_acc.accumulate.launches == before  # the plain path on the CPU
    assert got.dtype == torch.from_numpy(dsdx).dtype
    assert got.shape == ref.shape
    assert _rel(got, ref) < tol
    # the Newton path's route to the same values: all Ke, then the planes
    Ke = tasm.element_stiffness(torch.from_numpy(dsdx), torch.from_numpy(vol),
                                torch.from_numpy(C))
    assert _rel(got, tst.structured_dia_scatter(Ke, tplan)) < tol


def test_structured_assemble_rejects_a_wrong_element_count():
    (dsdx, vol, C), _, tplan = _box_inputs(False, np.float64)
    with pytest.raises(ValueError, match="elements"):
        tst.structured_assemble(torch.from_numpy(dsdx[:-6]),
                                torch.from_numpy(vol[:-6]),
                                torch.from_numpy(C), tplan)


# --- analytic_dia_values_device ------------------------------------------


def test_analytic_dia_values_device_matches_jax_and_host():
    """The inputs of tests/test_multigrid.py's device-analytic test."""
    jm = j_box(4, 3, 5, 2.0, 1.5, 1.0)
    tm = convert.mesh_from(jm)
    C = jmat.LinearIsotropic(200.0, 0.3).C
    jd, td = j_dia_pattern(jm), build_structured_dia_pattern(tm)
    fixed = np.random.default_rng(3).random(td.n_dof) < 0.2
    c = jst.analytic_cell_tensor(jm, C, jd)
    ref = np.asarray(jst.analytic_dia_values_device(
        c, (4, 3, 5), jd.offsets, jd.diag_idx, jnp.asarray(fixed)))
    host = tst.dia_dirichlet_linear_numpy(
        tst.analytic_structured_dia_values(tm, C, td), td.offsets,
        td.diag_idx, fixed)
    got = tst.analytic_dia_values_device(
        tst.analytic_cell_tensor(tm, C, td), (4, 3, 5), td.offsets,
        td.diag_idx, torch.from_numpy(fixed))
    assert got.dtype == torch.float64 and got.shape == host.shape
    scale = np.abs(host).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * scale
    assert np.abs(got.numpy() - host).max() <= 1e-12 * scale


# --- assembly.internal_force ---------------------------------------------


def test_internal_force_matches_jax_and_m4_plain():
    jm = j_unstructured(3)
    tm = convert.mesh_from(jm)
    rng = np.random.default_rng(11)
    dN = np.asarray(jm.element.dshape_at_gp)
    w = np.asarray(jm.element.gauss_weights)
    dsdx, vol = (np.array(a) for a in jasm.gradients_and_volume(
        jnp.asarray(jm.nodes), jnp.asarray(jm.elements), jnp.asarray(dN),
        jnp.asarray(w)))
    s = rng.standard_normal((jm.n_elements, dN.shape[0], 3, 3))
    sigma = s + np.swapaxes(s, -1, -2)
    targets = (jm.elements.astype(np.int64)[:, :, None] * 3
               + np.arange(3)).reshape(-1)
    ref = np.asarray(jasm.internal_force(
        jnp.asarray(dsdx), jnp.asarray(sigma), jnp.asarray(vol),
        jnp.asarray(targets), jm.n_dof))
    args = [torch.from_numpy(a) for a in (dsdx, sigma, vol)]
    got = tasm.internal_force(*args, torch.from_numpy(targets), tm.n_dof)
    assert got.shape == (tm.n_dof,)
    assert _rel(got, ref) < 1e-13
    plan = build_scatter_plan(build_pattern(tm), "cpu")
    m4 = k_force.scatter_force_plain(tasm.element_internal_force(*args), plan)
    assert _rel(got, m4) < 1e-13


# --- solvers.ell_spmv and solvers.pcg_solve -------------------------------


def _ell_system():
    """The eliminated ELL operator of unstructured_box_tets(3), z = 0
    clamped, and a seeded right-hand side (numpy)."""
    from femcy_tpu_torch.assembly_host import assemble_csr_host
    from femcy_tpu_torch.materials import LinearIsotropic

    tm = convert.mesh_from(j_unstructured(3))
    tp = build_pattern(tm)
    K = assemble_csr_host(tm, tp, LinearIsotropic(200.0, 0.3).C)
    values = np.zeros(tp.colidx.size)
    values[tp.csr_slots] = K.data
    values = values.reshape(tp.colidx.shape)
    valid = np.arange(tp.width)[None, :] < tp.row_counts[:, None]
    fixed = np.repeat(tm.nodes[:, 2] < 1e-9, 3)
    values[fixed] = 0.0
    values[fixed[tp.colidx] & valid] = 0.0
    values.reshape(-1)[tp.diag_slot[fixed]] = 1.0
    b = np.random.default_rng(12).standard_normal(tm.n_dof)
    b[fixed] = 0.0
    return tp, values, b


def test_public_ell_spmv_and_pcg_match_jax():
    tp, values, b = _ell_system()
    colidx = tp.colidx.astype(np.int64)
    x = np.random.default_rng(13).standard_normal(tp.n_dof)
    y_t = tsolvers.ell_spmv(torch.from_numpy(values), torch.from_numpy(colidx),
                            torch.from_numpy(x))
    y_j = jsolvers.ell_spmv(jnp.asarray(values), jnp.asarray(colidx),
                            jnp.asarray(x))
    assert _rel(y_t, y_j) < 1e-12
    xt, it_t, _ = tsolvers.pcg_solve(
        torch.from_numpy(values), torch.from_numpy(colidx),
        torch.from_numpy(tp.diag_slot.astype(np.int64)), torch.from_numpy(b),
        eps=1e-10)
    xj, it_j, _ = jsolvers.pcg_solve(
        jnp.asarray(values), jnp.asarray(colidx), jnp.asarray(tp.diag_slot),
        jnp.asarray(b), eps=1e-10)
    assert int(it_t) == int(it_j) > 10
    assert _rel(xt, xj) < 1e-12


def test_full_width_plan_sums_as_the_pattern_plan():
    """M2's rule (each row summed in slot order) on ``colidx_plan``, every
    row at its full width, against the pattern's plan, which stops at the
    row's count of valid slots: the padding adds only zeros, so the sums
    are equal, and the plain gather agrees."""
    tp, values, _ = _ell_system()
    x = np.random.default_rng(14).standard_normal(tp.n_dof)
    full = k_ell.colidx_plan(torch.from_numpy(tp.colidx.astype(np.int64)))
    assert full.colidx_t.dtype == torch.int32
    assert bool((full.row_counts == tp.width).all())

    def emulate(plan):
        ids, counts = plan.colidx_t.numpy(), plan.row_counts.numpy()
        y = np.zeros(plan.n)
        for w in range(plan.width):
            live = w < counts
            y[live] += values[live, w] * x[ids[w, live]]
        return y

    y_full = emulate(full)
    np.testing.assert_array_equal(y_full, emulate(k_ell.spmv_plan(tp, "cpu")))
    y_plain = tcg.ell_spmv_plain(torch.from_numpy(values),
                                 torch.from_numpy(tp.colidx.astype(np.int64)),
                                 torch.from_numpy(x))
    assert _rel(y_full, y_plain) < 1e-13


def test_cuda_branch_launches_m2_never_the_plain_gather(monkeypatch):
    """With the device check reading "cuda", ``ell_spmv`` and ``pcg_solve``
    without ``spmv`` go through M2's wrapper on the full-width plan (run
    here on CPU tensors, where the wrapper takes its own plain branch)
    and never call ``ell_spmv_plain``."""
    tp, values, b = _ell_system()
    vals, rhs = torch.from_numpy(values), torch.from_numpy(b)
    colidx = torch.from_numpy(tp.colidx.astype(np.int64))
    diag_slot = torch.from_numpy(tp.diag_slot.astype(np.int64))
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(tp.n_dof))
    y_ref = tcg.ell_spmv_plain(vals, colidx, x)
    _, it_plain, _ = tcg.pcg_solve(vals, colidx, diag_slot, rhs, eps=1e-8)
    x_ref, it_ref, _ = tcg.pcg_solve(vals, colidx, diag_slot, rhs, eps=1e-8,
                                     spmv=k_ell.colidx_spmv(colidx))

    calls = []
    wrapper = k_ell.spmv

    def counted(plan, values_t, v):
        calls.append(plan.row_counts.tolist() == [tp.width] * tp.n_dof)
        return wrapper(plan, values_t, v)

    def refuse(*args):
        raise AssertionError("the CUDA branch ran the plain gather")

    monkeypatch.setattr(tcg, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(tcg, "ell_spmv_plain", refuse)
    monkeypatch.setattr(k_ell, "spmv", counted)
    y = tcg.ell_spmv(vals, colidx, x)
    assert calls == [True] and _rel(y, y_ref) < 1e-13
    x_k, it_k, _ = tcg.pcg_solve(vals, colidx, diag_slot, rhs, eps=1e-8)
    assert len(calls) == 1 + it_k and all(calls)
    assert it_k == it_ref == it_plain and torch.equal(x_k, x_ref)


@pytest.mark.parametrize("entry", ["FEMSystem", "MultiBlockSystem"])
def test_slices_keeps_the_plain_gather(monkeypatch, entry):
    """``spmv="slices"``, an explicit request for the plain torch SpMV,
    hands ``pcg_solve`` the plain gather pair, so the CUDA dispatch of
    ``spmv=None`` never reaches it: with the device check reading "cuda"
    and M2's wrapper refusing, the system's Jacobi CG gives the same
    bits as without them."""
    from femcy_tpu_torch import (ElementBlock, FEMSystem, LinearIsotropic,
                                 MultiBlockSystem, SolverConfig)
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    mesh = unstructured_box_tets(3)
    mat = LinearIsotropic(200.0, 0.3)
    cfg = SolverConfig(spmv="slices", linear_solver="cg")
    z = mesh.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > 1 - 1e-9)[0]
    if entry == "FEMSystem":
        bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
        bcs.append(DirichletBC(top, 0, 0.01))
        inp = InpModel(mesh.nodes, mesh.elements, "C3D4", {}, {}, {}, bcs,
                       [], "Elastic", [200.0, 0.3], False,
                       {"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                        "max_inc": 1.0})

        def solve():
            system = FEMSystem(mesh, mat, config=cfg, device="cpu")
            system.solve(inp)
            return system.dof, system._last_cg_iters
    else:
        fixed = np.zeros(mesh.n_dof, dtype=bool)
        fixed[bottom[:, None] * 3 + np.arange(3)] = True
        fixed[top * 3] = True
        sval = np.where(fixed & (np.arange(mesh.n_dof) % 3 == 0)
                        & np.repeat(z > 1 - 1e-9, 3), 0.01, 0.0)

        def solve():
            system = MultiBlockSystem(
                mesh.nodes, [ElementBlock(mesh.elements, mesh.element, mat)],
                cfg, device="cpu")
            system.solve(np.zeros(mesh.n_dof), fixed, sval)
            return system.dof, system._last_cg_iters

    x_ref, it_ref = solve()

    def refuse(*args):
        raise AssertionError("M2 launched under spmv='slices'")

    monkeypatch.setattr(tcg, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(k_ell, "spmv", refuse)
    x, it = solve()
    assert it == it_ref > 0 and torch.equal(x, x_ref)


def test_amg_fused_step_takes_m2(monkeypatch):
    """Under ``preconditioner="amg"`` the AMG solve applies M3, but the
    Jacobi PCG of the fused Newton step takes the layout's M2 pair: with
    the device check reading "cuda", every product of that CG goes
    through M2's wrapper (one an iteration) and none through the plain
    gather, with the same bits as without the patches."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.io.inp import DirichletBC, InpModel
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    mesh = unstructured_box_tets(3)
    z = mesh.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > 1 - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 2, 0.02))
    inp = InpModel(mesh.nodes, mesh.elements, "C3D4", {}, {}, {}, bcs, [],
                   "Elastic", [200.0, 0.3], True,
                   {"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1e-5,
                    "max_inc": 1.0})
    cfg = SolverConfig(preconditioner="amg", linear_solver="cg",
                       fused_newton=True)

    def solve():
        system = FEMSystem(mesh, LinearIsotropic(200.0, 0.3), True,
                           config=cfg, device="cpu")
        report = system.solve(inp)
        assert report.success and system.dia is None
        return system.dof, list(system._cg_iters_log)

    x_ref, log_ref = solve()
    calls = []
    wrapper = k_ell.spmv

    def counted(plan, values_t, v):
        calls.append(1)
        return wrapper(plan, values_t, v)

    def refuse(*args):
        raise AssertionError("the fused step ran the plain gather")

    monkeypatch.setattr(tcg, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(tcg, "ell_spmv_plain", refuse)
    monkeypatch.setattr(k_ell, "spmv", counted)
    x, log = solve()
    assert log == log_ref and len(log) > 0 and torch.equal(x, x_ref)
    assert len(calls) == sum(log)


def test_other_devices_raise():
    tp, values, b = _ell_system()
    meta = {"device": "meta"}
    vals = torch.empty(values.shape, dtype=torch.float64, **meta)
    colidx = torch.empty(tp.colidx.shape, dtype=torch.int64, **meta)
    vec = torch.empty(tp.n_dof, dtype=torch.float64, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tsolvers.ell_spmv(vals, colidx, vec)
    with pytest.raises(ValueError, match="unsupported device"):
        tsolvers.pcg_solve(vals, colidx, torch.empty(
            tp.n_dof, dtype=torch.int64, **meta), vec)


# --- direct parity of small public helpers --------------------------------


def _tiny():
    jm = j_box(2, 1, 1)
    return jm, convert.mesh_from(jm)


def _case_gradients_and_volume_x():
    jm, _ = _tiny()
    x = np.asarray(jm.nodes)[np.asarray(jm.elements)]
    x = x + 0.05 * np.random.default_rng(20).standard_normal(x.shape)
    dN = np.asarray(jm.element.dshape_at_gp)
    w = np.asarray(jm.element.gauss_weights)
    ref = jasm.gradients_and_volume_x(jnp.asarray(x), jnp.asarray(dN),
                                      jnp.asarray(w))
    got = tasm.gradients_and_volume_x(
        torch.from_numpy(x), torch.from_numpy(dN), torch.from_numpy(w))
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-12


def _case_consistent_tangent_elems():
    jm, _ = _tiny()
    x0 = np.asarray(jm.nodes)[np.asarray(jm.elements)]
    u = 0.02 * np.random.default_rng(21).standard_normal(x0.shape)
    dN = np.asarray(jm.element.dshape_at_gp)
    w = np.asarray(jm.element.gauss_weights)
    jm_mat = jmat.NeoHookean(200.0, 0.3)
    ref = jasm.consistent_tangent_elems(jnp.asarray(u), jnp.asarray(x0),
                                        jnp.asarray(dN), jnp.asarray(w),
                                        jm_mat)
    got = tasm.consistent_tangent_elems(
        torch.from_numpy(u), torch.from_numpy(x0), torch.from_numpy(dN),
        torch.from_numpy(w), convert.material_from(jm_mat))
    assert got.shape == ref.shape and _rel(got, ref) < 1e-12


def _case_b_matrix_host():
    from femcy_tpu.assembly_host import b_matrix_host as ref_fn

    from femcy_tpu_torch.assembly_host import b_matrix_host

    rng = np.random.default_rng(22)
    for dm in (2, 3):
        dsdx = rng.standard_normal((3, 2, 4, dm))
        np.testing.assert_array_equal(b_matrix_host(dsdx), ref_fn(dsdx))


def _case_dirichlet_dof_indices():
    from femcy_tpu.bc import dirichlet_dof_indices as ref_fn
    from femcy_tpu.io.inp import DirichletBC as JBC

    from femcy_tpu_torch.bc import dirichlet_dof_indices
    from femcy_tpu_torch.io.inp import DirichletBC

    nodes = np.array([4, 0, 7])
    for dm, dof in ((2, 1), (3, 2)):
        np.testing.assert_array_equal(
            dirichlet_dof_indices(DirichletBC(nodes, dof, 0.5), dm),
            ref_fn(JBC(nodes, dof, 0.5), dm))


def _case_neumann_unit_pattern():
    from femcy_tpu.bc import neumann_unit_pattern as ref_fn
    from femcy_tpu.io.inp import NeumannBC as JBC

    from femcy_tpu_torch.bc import neumann_unit_pattern
    from femcy_tpu_torch.io.inp import NeumannBC

    jm, tm = _tiny()
    top = [f for f in tm.boundary if (tm.nodes[list(f), 2] > 1 - 1e-9).all()]
    assert top
    for direction in (None, np.array([0.0, 0.6, 0.8])):
        got = neumann_unit_pattern(tm, NeumannBC(top, 1.5, direction))
        ref = ref_fn(jm, JBC(top, 1.5, direction))
        assert np.abs(got).max() > 0 and _rel(got, ref) < 1e-13


def _case_analytic_cell_tensor():
    jm, tm = _tiny()
    C = jmat.LinearIsotropic(200.0, 0.3).C
    got = tst.analytic_cell_tensor(tm, C, build_structured_dia_pattern(tm))
    ref = jst.analytic_cell_tensor(jm, C, j_dia_pattern(jm))
    assert _rel(got, ref) < 1e-13


def _case_cell_gradients():
    jm = j_box(2, 3, 1, 2.0, 1.5, 0.5)
    for g, r in zip(tst.cell_gradients(convert.mesh_from(jm)),
                    jst.cell_gradients(jm)):
        np.testing.assert_array_equal(g, r)


def _case_colidx_valid_mask():
    from femcy_tpu.topology import colidx_valid_mask as ref_fn

    from femcy_tpu_torch.topology import colidx_valid_mask

    colidx = np.arange(12).reshape(4, 3)
    counts = np.array([3, 0, 2, 1])
    np.testing.assert_array_equal(colidx_valid_mask(colidx, counts),
                                  ref_fn(colidx, counts))


def _case_block_jacobi_inverse():
    from femcy_tpu.solvers.dia import block_jacobi_inverse as ref_fn

    from femcy_tpu_torch.solvers.dia import block_jacobi_inverse

    jm, tm = _tiny()
    C = jmat.LinearIsotropic(200.0, 0.3).C
    td = build_structured_dia_pattern(tm)
    fixed = np.zeros(td.n_dof, dtype=bool)
    fixed[[0, 4, 5]] = True  # rows of a node half eliminated
    values = tst.dia_dirichlet_linear_numpy(
        tst.analytic_structured_dia_values(tm, C, td), td.offsets,
        td.diag_idx, fixed)
    got = block_jacobi_inverse(torch.from_numpy(values), td.offsets, 3)
    ref = ref_fn(jnp.asarray(values), td.offsets, 3)
    assert _rel(got, ref) < 1e-12


def _case_rcm_permutation():
    from femcy_tpu.parallel.banded import rcm_permutation as ref_fn

    from femcy_tpu_torch.parallel.banded import rcm_permutation

    tp = build_pattern(convert.mesh_from(j_unstructured(2)))
    np.testing.assert_array_equal(rcm_permutation(tp), ref_fn(tp))


def _case_femcy_colormap():
    from femcy_tpu.io.colormap import femcy_colormap as ref_fn

    from femcy_tpu_torch.io.colormap import femcy_colormap

    xs = np.linspace(0.0, 1.0, 11)
    for mod in (1, 4, 7):
        got, ref = femcy_colormap(mod, 64), ref_fn(mod, 64)
        assert got.name == ref.name
        np.testing.assert_array_equal(got(xs), ref(xs))


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("_case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    """One case per public helper that no other test of the port names.
    Some are also reached through callers: ``b_matrix_host`` through
    ``assemble_csr_host`` (tests/test_torch_topology.py),
    ``neumann_unit_pattern`` through the pressure models of
    tests/test_torch_general.py, ``cell_gradients`` through the slab
    solver (tests/test_torch_slab.py), ``block_jacobi_inverse`` through
    ``preconditioner="block_jacobi"`` (tests/test_torch_general.py)."""
    CASES[name]()
