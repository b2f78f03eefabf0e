"""Mixed-precision refinement (``SolverConfig.mixed_precision_refine``) of
femcy_tpu_torch against femcy_tpu's, on the CPU.

float32 comes from ``FEMCY_TPU_X64=0`` in the port (set per test) and from
``jax_enable_x64=False`` in femcy_tpu, restored in a ``finally`` so no
other test of the worker's file runs in float32.

- Linear refinement on a nu = 0.4999 box in float32, the inner solve the
  host direct solve or the Jacobi CG: each package's f64 refined state
  within 1e-9 relative (max |dof|) of femcy_tpu's float64 direct solve,
  the plain float32 solve at least 100x further off.  femcy_tpu returns
  the refined state in float32; its f64 state is read from the array it
  hands to ``jnp.asarray`` (checked against the float32 dof it returns).
- Newton refinement on a nu = 0.45 cantilever in float32 (at nu = 0.4999
  the float32 Newton of either package cuts back to min_inc on these
  locking tets): the certified
  equilibrium rms(r64)/rms(f) of ``dof_refined``, from the f64 host
  internal force, below 1e-9 in both packages, an unrefined run's at least
  1e4 times larger (femcy_tpu's tests/test_precision.py:263-298 gates).
- Newton refinement with stabilization in float64 (both Newton runs
  without the boost line search, for fewer evaluations): the refined
  state's
  STABILIZED f64 residual below 1e-8 of its scale in both packages
  (test_precision.py:205-260), the two refined states within 1e-8.
- The near-incompressible warning fires on femcy_tpu's condition.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC

import femcy_tpu_torch as T
from femcy_tpu_torch import assembly_host as thost
from femcy_tpu_torch import bc as tbc
from femcy_tpu_torch import convert


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


class _JaxF32:
    """femcy_tpu in float32 inside the block, float64 again after it."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", False)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def port_f32(monkeypatch):
    monkeypatch.setenv("FEMCY_TPU_X64", "0")


def _box_model(nu):
    """box_tets(4, 4, 4): z=0 clamped, ux = 0.01 on z=1, linear."""
    jm = F.meshgen.box_tets(4, 4, 4)
    z = jm.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > 1 - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, 0.01))
    inp = InpModel(
        nodes=jm.nodes, elements=jm.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic", material_params=[1000.0, nu],
        geometric_nonlinear=False,
        time_incs=dict(ini_inc=1.0, max_time=1.0, min_inc=1e-5, max_inc=1.0))
    return jm, F.LinearIsotropic(1000.0, nu), inp


def _port(jm, mat, nlgeom, cfg):
    return T.FEMSystem(convert.mesh_from(jm), convert.material_from(mat),
                       nlgeom, T.SolverConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def box_f64_direct():
    """The nu = 0.4999 box and femcy_tpu's float64 direct solution."""
    jm, mat, inp = _box_model(0.4999)
    ref = F.FEMSystem(jm, mat, False, F.SolverConfig(linear_solver="direct"))
    assert ref.solve(inp).success
    return jm, mat, inp, np.asarray(ref.dof)


@pytest.mark.parametrize("inner", ["direct", "cg"])
def test_linear_refinement_in_f32_matches_f64(inner, box_f64_direct,
                                              port_f32, monkeypatch):
    jm, mat, inp, ref = box_f64_direct
    assert ref.dtype == np.float64
    cfg = dict(linear_solver=inner)
    if inner == "cg":
        cfg["cg_max_iters"] = 50_000

    # femcy_tpu: the last float64 (n,) array handed to jnp.asarray inside
    # the solve is the refinement's f64 state (its return)
    seen = []
    asarray = jnp.asarray

    def recording(a, *args, **kw):
        if (isinstance(a, np.ndarray) and a.dtype == np.float64
                and a.shape == ref.shape and not args and not kw):
            seen.append(a.copy())
        return asarray(a, *args, **kw)

    with _JaxF32():
        plain_j = F.FEMSystem(jm, mat, False, F.SolverConfig(**cfg))
        assert plain_j.solve(inp).success
        js = F.FEMSystem(jm, mat, False, F.SolverConfig(
            mixed_precision_refine=True, **cfg))
        monkeypatch.setattr(jnp, "asarray", recording)
        assert js.solve(inp).success
        monkeypatch.setattr(jnp, "asarray", asarray)
        j_dof32 = np.asarray(js.dof)
    assert j_dof32.dtype == np.float32
    x_j = seen[-1]
    assert np.array_equal(x_j.astype(np.float32), j_dof32)

    plain_t = _port(jm, mat, False, cfg)
    assert plain_t.solve(convert.inp_from(inp)).success
    ts = _port(jm, mat, False, dict(mixed_precision_refine=True, **cfg))
    assert ts.solve(convert.inp_from(inp)).success
    assert ts.dof.dtype == torch.float32
    x_t = ts.dof_refined
    assert x_t.dtype == np.float64 and ts._refine_iters > 0
    assert np.array_equal(ts.dof.numpy(), x_t.astype(np.float32))
    if inner == "cg":
        assert len(ts._cg_iters_log) == ts._refine_iters

    for x, plain in ((x_j, plain_j.dof), (x_t, plain_t.dof)):
        err = _rel(x, ref)
        assert err < 1e-9
        assert _rel(plain, ref) >= 100.0 * max(err, 1e-12)


def _cantilever(nu, traction):
    """cantilever_tets(6, 2) of LinearIsotropic(1000, nu): x=0 clamped, a
    *Dsload traction along z on the x=10 end face, two increments."""
    jm, fixed, loaded = F.meshgen.cantilever_tets(6, 2)
    lset = set(loaded.tolist())
    faces = [f for f in jm.boundary if all(n in lset for n in f)]
    inp = InpModel(
        nodes=jm.nodes, elements=jm.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(fixed, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(face_set=faces, traction=traction,
                               direction=np.array([0.0, 0.0, 1.0]))],
        material_type="Elastic", material_params=[1000.0, nu],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5))
    return jm, F.LinearIsotropic(1000.0, nu), inp


def _quality(system, inp, dof, stab=None):
    """rms of the f64 host residual at dof (Dirichlet rows zeroed; with
    ``stab`` = (scale, diag, ref), the stabilization force added) over the
    rms of the force it balances."""
    mesh = convert.mesh_from(system.mesh)
    mat = convert.material_from(system.material)
    patterns, tractions = tbc.build_neumann_patterns(
        mesh, convert.inp_from(inp).neumann_bcs)
    rhs = tractions @ patterns
    fixed = np.asarray(system._last_dirichlet[0], bool)
    d = np.asarray(dof, np.float64)
    f = thost.internal_force_host(mesh, mat, d)
    if stab is not None:
        scale, diag, ref = stab
        f = f + scale * np.asarray(diag, np.float64) * (
            d - np.asarray(ref, np.float64))
    r = f - rhs
    r[fixed] = 0.0
    return float(np.sqrt(np.mean(r * r)) / np.sqrt(np.mean(f * f)))


def test_newton_refinement_in_f32(port_f32):
    jm, mat, inp = _cantilever(0.45, 2.0)
    cfg = dict(newton_boost_max=0)
    with _JaxF32():
        js = F.FEMSystem(jm, mat, True, F.SolverConfig(
            mixed_precision_refine=True, **cfg))
        assert js.solve(inp).success
        plain_j = F.FEMSystem(jm, mat, True, F.SolverConfig(**cfg))
        assert plain_j.solve(inp).success
    ts = _port(jm, mat, True, dict(mixed_precision_refine=True, **cfg))
    tr = ts.solve(convert.inp_from(inp))
    assert tr.success and ts.timer.summary()["newton_refine"]["count"] == 2
    plain_t = _port(jm, mat, True, cfg)
    assert plain_t.solve(convert.inp_from(inp)).success
    assert plain_t.dof_refined is None and ts.dof.dtype == torch.float32
    for refined, plain in ((js, plain_j), (ts, plain_t)):
        q_ref = _quality(refined, inp, refined.dof_refined)
        q_plain = _quality(plain, inp, np.asarray(plain.dof))
        assert q_ref < 1e-9, q_ref
        assert q_plain > 1e4 * q_ref, (q_plain, q_ref)
    assert _rel(ts.dof_refined, js.dof_refined) < 1e-6


def test_newton_refinement_respects_stabilization():
    jm, mat, inp = _cantilever(0.3, 8.0)
    cfg = dict(stabilize_factor=1e-2, mixed_precision_refine=True,
               newton_boost_max=0)
    js = F.FEMSystem(jm, mat, True, F.SolverConfig(**cfg))
    assert js.solve(inp).success
    ts = _port(jm, mat, True, cfg)
    assert ts.solve(convert.inp_from(inp)).success
    j_stab = (float(js._arrs["stab_scale"]), js._arrs["stab_diag"],
              js._arrs["stab_ref"])
    t_stab = (float(ts._stab_scale), ts._stab_diag.numpy(),
              ts._stab_ref.numpy())
    assert t_stab[0] > 0.0
    for system, stab in ((js, j_stab), (ts, t_stab)):
        q = _quality(system, inp, system.dof_refined, stab=stab)
        assert q < 1e-8, q
    assert _rel(ts.dof_refined, js.dof_refined) < 1e-8


@pytest.mark.parametrize("case, warns", [
    ("linear", True), ("linear refined", False), ("newton refined", False),
    ("fused refined", True), ("f64", False)])
def test_near_incompressible_warning(case, warns, monkeypatch, caplog):
    jm, mat, _ = _box_model(0.4999)
    cfg = {} if case in ("linear", "f64") else dict(
        mixed_precision_refine=True)
    if case.startswith("fused"):
        cfg["fused_newton"] = True
    nlgeom = case.startswith(("newton", "fused"))
    if case != "f64":
        monkeypatch.setenv("FEMCY_TPU_X64", "0")
    with caplog.at_level(logging.WARNING):
        if case != "f64":
            with _JaxF32():
                F.FEMSystem(jm, mat, nlgeom, F.SolverConfig(**cfg))
        else:
            F.FEMSystem(jm, mat, nlgeom, F.SolverConfig(**cfg))
        _port(jm, mat, nlgeom, cfg)
    by = {name: [r.getMessage() for r in caplog.records if r.name == name
                 and "near-incompressible" in r.getMessage()]
          for name in ("femcy_tpu", "femcy_tpu_torch")}
    assert bool(by["femcy_tpu"]) == bool(by["femcy_tpu_torch"]) == warns
    for msgs in by.values():
        assert all("mixed_precision_refine" in m for m in msgs)
        assert all(("NOT the fused_newton" in m) == case.startswith("fused")
                   for m in msgs)
