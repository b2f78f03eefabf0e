"""The general slice as a whole: femcy_tpu_torch.FEMSystem against
femcy_tpu's on meshes without the box structure (and boxes forced onto
the ELL layout), linear static, on the CPU.

Meshes: rect_tris / rect_quads (CPS3 / CPS4, plane stress and plane
strain), box_hexes, box_hexes20, unstructured_box_tets, and an inline
C3D4 .inp model with a *Dsload pressure.  The model clamps the lowest face
along the last axis, prescribes an x-displacement on the highest one and
(3D) presses on the x=max face.

Tolerances (float64): the assembled and eliminated operator and rhs to
1e-12 relative to the largest entry (the same element matrices summed in
the same order; only the einsum's rounding differs); the direct solve to
1e-10 (SuperLU on operators equal to ~1e-15); the CG to 1e-9 with equal
iteration counts (the same iteration, dot products summed in another
order).  That bound holds for well-conditioned operators only: the
roundoff grows with the condition number, and with the same operator and
rhs in both packages the CG's x differed by 7e-9 on rect_quads(6, 5) in
plane strain at nu = 0.45 and by 3e-8 on box_hexes20(2, 2, 2), so those
run the direct solve here.  float32 against float64: 1e-4 (the operator's
condition number times f32 eps).
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
from femcy_tpu_torch.kernels import dia_spmv as k_dia
from femcy_tpu_torch.kernels import ell_scatter as k_scat
from femcy_tpu_torch.kernels import ell_spmv as k_ell
from femcy_tpu_torch.system import default_dtype

MESHES = {
    "tri3": (lambda: F.meshgen.rect_tris(6, 5, 2.0, 1.0),
             lambda: F.LinearIsotropicPlaneStress(200.0, 0.25)),
    "quad4": (lambda: F.meshgen.rect_quads(6, 5, 2.0, 1.0),
              lambda: F.LinearIsotropicPlaneStrain(200.0, 0.3)),
    "hex8": (lambda: F.meshgen.box_hexes(4, 4, 4, 2.0, 1.5, 1.0),
             lambda: F.LinearIsotropic(1000.0, 0.3)),
    "hex20": (lambda: F.meshgen.box_hexes20(2, 2, 2),
              lambda: F.LinearIsotropic(1000.0, 0.3)),
    "tet4_unstructured": (lambda: F.meshgen.unstructured_box_tets(6),
                          lambda: F.LinearIsotropic(1000.0, 0.3)),
    "tet4_box": (lambda: F.meshgen.box_tets(4, 3, 3, 2.0, 1.5, 1.0),
                 lambda: F.LinearIsotropic(1000.0, 0.3)),
}


def _model(mesh, ini_inc=1.0, pressure=True):
    ax = mesh.dm - 1
    c = mesh.nodes[:, ax]
    low = np.nonzero(c < c.min() + 1e-9)[0]
    high = np.nonzero(c > c.max() - 1e-9)[0]
    bcs = [DirichletBC(low, d, 0.0) for d in range(mesh.dm)]
    bcs.append(DirichletBC(high, 0, 0.02))
    neumann, faces = [], {}
    if pressure and mesh.dm == 3:
        xmax = mesh.nodes[:, 0].max()
        face = sorted(f for f in mesh.boundary
                      if all(mesh.nodes[n, 0] > xmax - 1e-9 for n in f))
        neumann, faces = [NeumannBC(face, -5.0)], {"xmax": face}
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={"low": low, "high": high}, ele_sets={}, face_sets=faces,
        dirichlet_bcs=bcs, neumann_bcs=neumann, material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=False,
        time_incs={"ini_inc": ini_inc, "max_time": 1.0, "min_inc": 1e-5,
                   "max_inc": ini_inc},
    )


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _pair(name, **cfg):
    make_mesh, make_mat = MESHES[name]
    jm, jmat = make_mesh(), make_mat()
    js = F.FEMSystem(jm, jmat, False, F.SolverConfig(**cfg))
    ts = T.FEMSystem(convert.mesh_from(jm), convert.material_from(jmat), False,
                     T.SolverConfig(**cfg), device="cpu")
    return jm, js, ts


def _compare_solves(js, ts, jr, tr, tol):
    assert jr.success and tr.success
    assert [dataclasses.astuple(r) for r in tr.increments] == [
        dataclasses.astuple(r) for r in jr.increments
    ]
    assert ts._last_cg_iters == js._last_cg_iters
    assert ts.dof.dtype == torch.float64
    assert _rel(ts.dof, js.dof) < tol
    t_out, j_out = ts.compute_strain_stress(), js.compute_strain_stress()
    for t, j in zip(t_out, j_out):  # strain, stress, mises
        assert _rel(t, j) < tol
    j_energy = js.elastic_energy()
    assert abs(ts.elastic_energy() - j_energy) < tol * j_energy
    assert _rel(ts.extrapolate(t_out[2]), js.extrapolate(j_out[2])) < tol


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "name, fmt, layout",
    [
        ("tri3", "auto", "dia"),
        ("quad4", "auto", "dia"),
        ("hex8", "auto", "dia"),
        ("hex20", "auto", "ell"),
        ("tet4_unstructured", "auto", "ell"),
        ("hex8", "ell", "ell"),
        ("tet4_box", "ell", "ell"),
        ("hex20", "dia", "dia"),
    ],
)
def test_layout_choice_matches_jax(name, fmt, layout):
    _, js, ts = _pair(name, sparse_format=fmt)
    assert ts._structured_plan is None and ts.pattern is not None
    assert (ts.dia is not None) == (js.dia is not None) == (layout == "dia")
    # the device assembly needs no dof-level scatter map: none is expanded
    assert ts.pattern.scatter_targets is None
    if layout == "dia":
        assert ts.dia.offsets == js.dia.offsets
        assert ts.dia.scatter_targets is None
        np.testing.assert_array_equal(ts.dia.ensure_scatter_targets(),
                                      js.dia.scatter_targets)
    assert ts._scatter_plan.out_shape == (
        ts.mesh.n_dof, ts.dia.n_offsets if layout == "dia" else ts.pattern.width)
    assert set(ts._init_seconds) == (
        {"pattern", "scatter_map", "upload", "gradients"}
        | ({"dia_pattern"} if fmt != "ell" else set()))


@pytest.mark.parametrize("name", ["tri3", "quad4", "hex8", "hex20",
                                  "tet4_unstructured"])
def test_linear_system_matches_jax(name):
    jm, js, ts = _pair(name)
    inp = _model(jm)
    fixed, sval = F.bc.build_dirichlet_arrays(inp.dirichlet_bcs, jm, 1.0, 0.5)
    pats, tracs = F.bc.build_neumann_patterns(jm, inp.neumann_bcs)
    rhs = (tracs * 0.5) @ pats if pats.shape[0] else np.zeros(jm.n_dof)
    vj, rj, volj = js._jit_linear_system(
        js._arrs, jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval))
    vt, rt, volt = ts._linear_system(
        torch.from_numpy(rhs), torch.from_numpy(fixed), torch.from_numpy(sval))
    assert tuple(vt.shape) == tuple(vj.shape)
    assert _rel(vt, vj) < 1e-12
    assert _rel(rt, rj) < 1e-12
    assert _rel(volt, volj) < 1e-12


@pytest.mark.parametrize(
    "name, solver, preconditioner, tol",
    [
        ("tri3", "direct", "jacobi", 1e-10),
        ("quad4", "direct", "jacobi", 1e-10),
        ("hex8", "direct", "jacobi", 1e-10),
        ("hex20", "direct", "jacobi", 1e-10),
        ("tet4_unstructured", "direct", "jacobi", 1e-10),
        ("tri3", "cg", "block_jacobi", 1e-9),
        ("quad4", "cg", "jacobi", 1e-9),
        ("hex8", "cg", "jacobi", 1e-9),
        ("hex8", "cg", "block_jacobi", 1e-9),
        ("tet4_unstructured", "cg", "jacobi", 1e-9),
        ("tet4_unstructured", "cg", "block_jacobi", 1e-9),
    ],
)
def test_solve_matches_jax(name, solver, preconditioner, tol):
    jm, js, ts = _pair(name, linear_solver=solver, preconditioner=preconditioner)
    inp = _model(jm, ini_inc=0.5)
    jr = js.solve(inp)
    tr = ts.solve(convert.inp_from(inp))
    _compare_solves(js, ts, jr, tr, tol)
    assert tr.n_increments == 2
    if solver == "cg":
        assert ts._last_cg_iters > 0


@pytest.mark.parametrize("name", ["tet4_box", "hex8"])
def test_box_forced_onto_ell_matches_jax(name):
    jm, js, ts = _pair(name, linear_solver="cg", sparse_format="ell")
    assert ts.dia is None and js.dia is None
    inp = _model(jm)
    _compare_solves(js, ts, js.solve(inp), ts.solve(convert.inp_from(inp)), 1e-9)


def _inp_text(mesh, etype):
    """An Abaqus .inp of ``mesh``: z=0 clamped, ux=0.01 on z=1, pressure
    on the x=max face through a *Surface of per-face-number element sets."""
    lines = ["*Heading", "general mesh", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(mesh.nodes)]
    lines.append(f"*Element, type={etype}")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in conn)
              for e, conn in enumerate(mesh.elements)]
    z, x = mesh.nodes[:, 2], mesh.nodes[:, 0]
    faces = {}
    for e, conn in enumerate(mesh.elements):
        for k, facets in enumerate(mesh.element.inp_surface_num):
            nodes = [int(conn[ln]) for f in facets for ln in f]
            if (x[nodes] > x.max() - 1e-9).all():
                faces.setdefault(k + 1, []).append(e + 1)
    for name, sel in (("bot", z < 1e-9), ("top", z > z.max() - 1e-9)):
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in np.nonzero(sel)[0])]
    for k, eles in faces.items():
        lines += [f"*Elset, elset=_x{k}, internal, instance=a",
                  ", ".join(str(e) for e in eles)]
    lines.append("*Surface, type=ELEMENT, name=xload")
    lines += [f"_x{k}, S{k}" for k in faces]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              "*Step, name=s, nlgeom=NO", "*Static", "1., 1., 1e-05, 1.",
              "*Boundary", "bot, 1, 1", "bot, 2, 2", "bot, 3, 3",
              "top, 1, 1, 0.01", "*Dsload", "xload, P, 2.", "*End Step"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("solver, tol", [("direct", 1e-10), ("cg", 1e-9)])
def test_inp_model_matches_jax(tmp_path, solver, tol):
    """The user's entry point: read_inp -> FEMesh -> material_from_inp ->
    FEMSystem -> solve, on an unstructured C3D4 model with a pressure."""
    path = tmp_path / "general.inp"
    path.write_text(_inp_text(T.meshgen.unstructured_box_tets(4), "C3D4"))
    out = {}
    for pkg in (F, T):
        inp = pkg.read_inp(str(path))
        mat = pkg.material_from_inp(inp.material_type, inp.material_params,
                                    inp.element_type)
        kw = {"device": "cpu"} if pkg is T else {}
        s = pkg.FEMSystem(pkg.FEMesh(inp.nodes, inp.elements, inp.element),
                          mat, inp.geometric_nonlinear,
                          pkg.SolverConfig(linear_solver=solver), **kw)
        out[pkg] = (s, s.solve(inp), inp)
    (js, jr, _), (ts, tr, inp) = out[F], out[T]
    assert ts.dia is None and tr.n_increments == 1
    assert len(inp.neumann_bcs) == 1 and len(inp.neumann_bcs[0].face_set) > 0
    _compare_solves(js, ts, jr, tr, tol)


def test_cps3_inp_membrane_matches_jax(tmp_path):
    """The verify skill's canonical drive (a CPS3 membrane .inp -> GP
    sigma_yy -> nodal extrapolation) on a generated plane-stress model."""
    m = F.meshgen.rect_tris(8, 6, 2.0, 1.0)
    x = m.nodes[:, 0]
    lines = ["*Heading", "membrane", "*Node"]
    lines += [f"{i + 1}, {float(p[0])!r}, {float(p[1])!r}"
              for i, p in enumerate(m.nodes)]
    lines.append("*Element, type=CPS3")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in c)
              for e, c in enumerate(m.elements)]
    for name, sel in (("left", x < 1e-9), ("right", x > x.max() - 1e-9)):
        lines += [f"*Nset, nset={name}, instance=a",
                  ", ".join(str(i + 1) for i in np.nonzero(sel)[0])]
    lines += ["*Material, name=m", "*Elastic", "200., 0.25",
              "*Step, name=s, nlgeom=NO", "*Static", "1., 1., 1e-05, 1.",
              "*Boundary", "left, 1, 1", "left, 2, 2", "right, 1, 1, 0.01",
              "*End Step"]
    path = tmp_path / "membrane.inp"
    path.write_text("\n".join(lines) + "\n")
    out = {}
    for pkg in (F, T):
        inp = pkg.read_inp(str(path))
        mat = pkg.material_from_inp(inp.material_type, inp.material_params,
                                    inp.element_type)
        kw = {"device": "cpu"} if pkg is T else {}
        s = pkg.FEMSystem(pkg.FEMesh(inp.nodes, inp.elements, inp.element),
                          mat, inp.geometric_nonlinear, **kw)
        assert s.solve(inp).success
        _, stress, _ = s.compute_strain_stress()
        syy = np.asarray(stress)[:, :, 1, 1]
        nodal = s.extrapolate(torch.from_numpy(syy) if pkg is T
                              else jnp.asarray(syy))
        out[pkg] = (s, np.asarray(nodal))
    (js, jn), (ts, tn) = out[F], out[T]
    assert type(ts.material).__name__ == "LinearIsotropicPlaneStress"
    assert ts.dia is not None and js.dia is not None
    assert _rel(ts.dof, js.dof) < 1e-10
    assert _rel(tn, jn) < 1e-10


@pytest.mark.parametrize("name, solver", [("tet4_unstructured", "direct"),
                                          ("tet4_unstructured", "cg"),
                                          ("hex8", "cg")])
def test_float32_general(monkeypatch, name, solver):
    """FEMCY_TPU_X64=0 runs the general layouts in float32 within f32
    roundoff of the float64 solve."""
    make_mesh, make_mat = MESHES[name]
    mesh = convert.mesh_from(make_mesh())
    mat = convert.material_from(make_mat())
    inp = convert.inp_from(_model(mesh))
    cfg = T.SolverConfig(linear_solver=solver, cg_eps=1e-8)
    s64 = T.FEMSystem(mesh, mat, config=cfg, device="cpu")
    monkeypatch.setenv("FEMCY_TPU_X64", "0")
    assert default_dtype() == torch.float32
    s32 = T.FEMSystem(mesh, mat, config=cfg, device="cpu")
    s64.solve(inp)
    s32.solve(inp)
    assert s32.dof.dtype == torch.float32
    assert _rel(s32.dof, s64.dof) < 1e-4


def test_general_path_on_cpu_launches_no_kernel():
    _, _, ts = _pair("tet4_unstructured", linear_solver="cg")
    _, _, td = _pair("hex8", linear_solver="cg")
    inp = convert.inp_from(_model(ts.mesh))
    before = (k_scat.scatter.launches, k_ell.spmv.launches, k_dia.spmv.launches)
    ts.solve(inp)
    td.solve(convert.inp_from(_model(td.mesh)))
    assert ts._last_cg_iters > 0 and td._last_cg_iters > 0
    assert (k_scat.scatter.launches, k_ell.spmv.launches,
            k_dia.spmv.launches) == before


def test_spmv_slices_on_ell_is_the_plain_gather():
    """spmv="slices" keeps the plain row gather (its (prep, apply) pair,
    ``cg.gather_spmv``, takes the values as they are); the default's pair
    runs the same plain SpMV on the transposed operand on the CPU: equal
    iteration counts, x equal to roundoff (1e-10)."""
    out = {}
    for spmv in ("auto", "slices"):
        _, _, s = _pair("tet4_unstructured", linear_solver="cg", spmv=spmv)
        probe = torch.zeros(s.pattern.n_dof, s.pattern.width, dtype=s.dtype)
        assert (s._spmv[0](probe) is probe) == (spmv == "slices")
        s.solve(convert.inp_from(_model(s.mesh)))
        out[spmv] = (s.dof, s._last_cg_iters)
    assert out["auto"][1] == out["slices"][1] > 0
    assert _rel(out["auto"][0], out["slices"][0]) < 1e-10


@pytest.mark.parametrize(
    "name, cfg",
    [
        ("tet4_unstructured", {"preconditioner": "multigrid"}),
        ("tet4_box", {"preconditioner": "multigrid", "sparse_format": "ell"}),
        ("tet4_unstructured", {"sparse_format": "dia"}),
        ("hex8", {"sparse_format": "dia", "dia_max_offsets": 20}),
    ],
)
def test_unsupported_layouts_raise_value_error(name, cfg):
    """The general mesh has no geometric multigrid, and sparse_format="dia"
    needs bounded offsets: both packages raise ValueError."""
    make_mesh, make_mat = MESHES[name]
    jm, jmat = make_mesh(), make_mat()
    cfg = dict(cfg, linear_solver="cg")
    with pytest.raises(ValueError):
        F.FEMSystem(jm, jmat, False, F.SolverConfig(**cfg))
    with pytest.raises(ValueError):
        T.FEMSystem(convert.mesh_from(jm), convert.material_from(jmat),
                    config=T.SolverConfig(**cfg), device="cpu")
