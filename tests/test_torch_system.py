"""The slice as a whole: femcy_tpu_torch.FEMSystem against femcy_tpu's on
the structured box, linear static, on the CPU.

The model: a non-cubic box_tets with the z=0 face clamped, a prescribed
shear (x-displacement) on the z=max face and one *Dsload pressure on the
x=max face.  Compared: dof, stress, Mises, strain, elastic energy, the
GP->node extrapolation and the increment records.

Tolerances (float64):
- direct solve: 1e-10 relative to the largest entry -- both packages hand
  SuperLU operators equal to ~1e-15, so only its roundoff remains;
- CG: equal iteration counts, and 1e-8 relative -- the same PCG iteration,
  with dot products and assembly summed in another order; the difference
  is roundoff amplified over the iterations, far below cg_eps = 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC

import femcy_tpu_torch as T
from femcy_tpu_torch import convert
from femcy_tpu_torch.system import default_dtype

DIMS = (4, 3, 3, 2.0, 1.5, 1.0)


def _model(mesh, ini_inc=1.0):
    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, 0.02))  # prescribed shear
    xmax = mesh.nodes[:, 0].max()
    face = sorted(f for f in mesh.boundary
                  if all(mesh.nodes[n, 0] > xmax - 1e-9 for n in f))
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={"bottom": bottom, "top": top}, ele_sets={},
        face_sets={"xmax": face}, dirichlet_bcs=bcs,
        neumann_bcs=[NeumannBC(face, -5.0)],  # a *Dsload pressure
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=False,
        time_incs={"ini_inc": ini_inc, "max_time": 1.0, "min_inc": 1e-5,
                   "max_inc": ini_inc},
    )


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize(
    "solver, ini_inc, tol", [("direct", 0.4, 1e-10), ("cg", 1.0, 1e-8)]
)
def test_slice_matches_jax(solver, ini_inc, tol):
    jm = F.meshgen.box_tets(*DIMS)
    inp = _model(jm, ini_inc)
    jmat = F.LinearIsotropic(1000.0, 0.3)
    js = F.FEMSystem(jm, jmat, False, F.SolverConfig(linear_solver=solver))
    jr = js.solve(inp)
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(jmat), False,
                     T.SolverConfig(linear_solver=solver), device="cpu")
    tr = ts.solve(convert.inp_from(inp))

    assert jr.success and tr.success
    assert [dataclasses.astuple(r) for r in tr.increments] == [
        dataclasses.astuple(r) for r in jr.increments
    ]
    assert ts._last_cg_iters == js._last_cg_iters
    if solver == "cg":
        assert ts._last_cg_iters > 0
    assert ts.dof.dtype == torch.float64
    assert _rel(ts.dof, js.dof) < tol
    assert torch.equal(convert.dof_from(np.asarray(js.dof)),
                       torch.from_numpy(np.array(js.dof)))
    t_out, j_out = ts.compute_strain_stress(), js.compute_strain_stress()
    for t, j in zip(t_out, j_out):  # strain, stress, mises
        assert _rel(t, j) < tol
    j_energy = js.elastic_energy()
    assert abs(ts.elastic_energy() - j_energy) < tol * j_energy
    (_, t_stress, t_mises), (_, j_stress, j_mises) = t_out, j_out
    assert _rel(ts.extrapolate(t_mises), js.extrapolate(j_mises)) < tol
    assert _rel(ts.extrapolate(t_stress[:, :, 0, 1]),
                js.extrapolate(jnp.asarray(j_stress)[:, :, 0, 1])) < tol
    assert _rel(T.mises_stress(t_stress, ts.material),
                F.system.mises_stress(j_stress, jmat)) < tol


def test_spmv_slices_is_the_plain_path():
    """spmv="slices" (the user's explicit request for the plain SpMV) and the
    default give the same iterates on the CPU, where both run plain."""
    mesh = T.meshgen.box_tets(3, 3, 2)
    inp = convert.inp_from(_model(F.meshgen.box_tets(3, 3, 2)))
    out = {}
    for spmv in ("auto", "slices"):
        s = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3),
                        config=T.SolverConfig(linear_solver="cg", spmv=spmv),
                        device="cpu")
        assert (s._spmv is None) == (spmv == "slices")
        s.solve(inp)
        out[spmv] = (s.dof, s._last_cg_iters)
    assert out["auto"][1] == out["slices"][1]
    assert torch.equal(out["auto"][0], out["slices"][0])


def test_float32_switch(monkeypatch):
    """FEMCY_TPU_X64=0 selects float32, as in femcy_tpu; the f32 solve
    stays within f32 roundoff of the f64 one (1e-4 relative: the operator's
    condition number times f32 eps)."""
    mesh = T.meshgen.box_tets(3, 3, 2)
    inp = convert.inp_from(_model(F.meshgen.box_tets(3, 3, 2)))
    mat = T.LinearIsotropic(1000.0, 0.3)
    cfg = T.SolverConfig(linear_solver="direct")
    s64 = T.FEMSystem(mesh, mat, config=cfg, device="cpu")
    monkeypatch.setenv("FEMCY_TPU_X64", "0")
    assert default_dtype() == torch.float32
    s32 = T.FEMSystem(mesh, mat, config=cfg, device="cpu")
    assert s32.dtype == torch.float32 and s64.dtype == torch.float64
    s64.solve(inp)
    s32.solve(inp)
    assert s32.dof.dtype == torch.float32
    assert _rel(s32.dof, s64.dof) < 1e-4


def test_bad_dtype_and_device_raise():
    mesh = T.meshgen.box_tets(2, 2, 2)
    mat = T.LinearIsotropic(1000.0, 0.3)
    with pytest.raises(ValueError):
        T.FEMSystem(mesh, mat, device="meta")


def test_checkpoint_roundtrip(tmp_path):
    mesh = T.meshgen.box_tets(2, 2, 2)
    inp = convert.inp_from(_model(F.meshgen.box_tets(2, 2, 2), ini_inc=0.5))
    path = str(tmp_path / "ck")
    cfg = T.SolverConfig(checkpoint_path=path)
    s = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3), config=cfg,
                    device="cpu")
    rep = s.solve(inp)
    assert rep.n_increments == 2
    r = T.FEMSystem(mesh, T.LinearIsotropic(1000.0, 0.3), device="cpu")
    r.load_checkpoint(path)
    assert torch.equal(r.dof, s.dof) and r.time0 == 1.0 and r.dt == s.dt


@pytest.mark.parametrize(
    "material",
    [F.LinearIsotropicPlaneStress(200.0, 0.25),
     F.LinearIsotropicPlaneStrain(200.0, 0.45)],
    ids=lambda m: m.type,
)
def test_plane_mises_matches_jax(material):
    """The plane-stress/plane-strain out-of-plane treatment of Mises."""
    s = np.random.default_rng(7).standard_normal((5, 3, 2, 2))
    s = s + np.swapaxes(s, -1, -2)
    ref = F.system.mises_stress(jnp.asarray(s), material)
    out = T.mises_stress(torch.from_numpy(s), convert.material_from(material))
    assert _rel(out, ref) < 1e-12


def test_pin_dof_matches_jax():
    from femcy_tpu.bc import pin_dof as j_pin
    from femcy_tpu_torch.bc import pin_dof as t_pin

    rng = np.random.default_rng(8)
    dof, sval = rng.standard_normal(12), rng.standard_normal(12)
    fixed = rng.uniform(size=12) < 0.5
    out = t_pin(torch.from_numpy(dof), torch.from_numpy(fixed),
                torch.from_numpy(sval))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(j_pin(jnp.asarray(dof), jnp.asarray(fixed),
                                      jnp.asarray(sval))))
