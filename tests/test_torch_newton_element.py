"""The box's Newton element kernel (M9, kernels/newton_element.py) and its
route through ``FEMSystem._newton_eval``.

- its plain version (``structured.newton_element_plain``, what CPU tensors
  run) against the einsum chain composed explicitly, on seeded random
  displacements: the planes, the element forces and the volumes bit for
  bit in float32 and float64 (the plain version is the same torch ops, so
  any difference is a wrong layout or a missed term), and P2's plain
  accumulate of its planes bit for bit ``structured_dia_scatter`` of Ke +
  Kg;
- the dispatch: only a C3D4 box under ``LinearIsotropic`` with the secant
  tangent and the geometric stiffness takes the route; the ELL layout,
  NeoHookean, the consistent tangent, the box without Kg and 2D keep the
  einsum route; on the CPU a whole twist (multigrid CG, stabilized, fused
  step) gives the einsum route's displacements and residuals bit for bit;
- on a card (marker ``cuda``, skipped without one): the kernel against its
  plain version, f64 within 1e-13 of the largest value (the kernel sums
  the same terms in its own order, with FMAs: a few ulps), f32 within
  1e-5; and the launch counter, once per evaluation on the box route and
  never on the others.
"""

import numpy as np
import pytest
import torch

import femcy_tpu_torch as T
from femcy_tpu_torch import assembly
from femcy_tpu_torch.io.inp import DirichletBC, InpModel
from femcy_tpu_torch.kernels import newton_element
from femcy_tpu_torch.meshgen import box_tets, rect_tris, unstructured_box_tets
from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
from femcy_tpu_torch.structured import (
    accumulate_planes,
    build_structured_plan,
    newton_element_plain,
    structured_dia_scatter,
    structured_element_nodes,
)
from femcy_tpu_torch.user import make_rotation_dirichlet

BOXES = [(3, 4, 5), (4, 4, 4)]
DTYPES = [torch.float32, torch.float64]
MATERIAL = T.LinearIsotropic(1000.0, 0.3)


def _inputs(dims, dtype, device="cpu", seed=0):
    """(mesh, plan, nodes, a seeded displacement, dsdX0 as the system makes
    it) of box_tets(*dims)."""
    mesh = box_tets(*dims)
    plan = build_structured_plan(mesh, build_structured_dia_pattern(mesh))

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    nodes = dev(mesh.nodes)
    dsdX0, _ = assembly.gradients_and_volume(
        nodes, dev(mesh.elements, torch.int64),
        dev(mesh.element.dshape_at_gp), dev(mesh.element.gauss_weights))
    # a turn of a few percent of a cell, as a Newton iterate of the twist
    u = dev(np.random.default_rng(seed).standard_normal(mesh.n_dof)
            * 0.05 / max(dims))
    return mesh, plan, nodes, u, dsdX0


def _composed(mesh, plan, nodes, u, dsdX0):
    """The einsum route of ``FEMSystem._internal_force_parts`` and
    ``_newton_eval`` written out: (planes, f_elem, vol, Ke + Kg)."""
    elem = mesh.element
    dN = torch.as_tensor(np.asarray(elem.dshape_at_gp), dtype=nodes.dtype)
    w = torch.as_tensor(np.asarray(elem.gauss_weights), dtype=nodes.dtype)
    C = torch.as_tensor(MATERIAL.C, dtype=nodes.dtype)
    u3 = u.reshape(-1, 3)
    F = assembly.deformation_gradient_u(structured_element_nodes(u3, mesh),
                                        dsdX0)
    dsdx, vol = assembly.gradients_and_volume_x(
        structured_element_nodes(nodes + u3, mesh), dN, w)
    sigma = assembly.gp_stress(F, MATERIAL, large=True)
    f_elem = assembly.element_internal_force(dsdx, sigma, vol)
    Ke = (assembly.element_stiffness(dsdx, vol, C)
          + assembly.geometric_stiffness(dsdx, sigma, vol))
    nc = plan.nx * plan.ny * plan.nz
    planes = Ke.reshape(nc, 6, 144).permute(1, 2, 0)
    return planes, f_elem, vol, Ke


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("dims", BOXES, ids=str)
def test_plain_version_is_the_composed_einsum_route(dims, dtype):
    mesh, plan, nodes, u, dsdX0 = _inputs(dims, dtype)
    before = newton_element.evaluate.launches
    planes, f_elem, vol = newton_element.evaluate(nodes, u, dsdX0, MATERIAL,
                                                  plan, mesh)
    want_planes, want_f, want_vol, Ke = _composed(mesh, plan, nodes, u, dsdX0)
    nc = plan.nx * plan.ny * plan.nz
    assert planes.shape == (6, 144, nc) and planes.is_contiguous()
    assert f_elem.shape == (mesh.n_elements, 4, 3) and f_elem.is_contiguous()
    assert vol.shape == (mesh.n_elements, 1)
    assert torch.equal(planes, want_planes)
    assert torch.equal(f_elem, want_f)
    assert torch.equal(vol, want_vol)
    # P2's input: the planes accumulate to structured_dia_scatter's values
    assert torch.equal(accumulate_planes(planes, plan),
                       structured_dia_scatter(Ke, plan))
    assert newton_element.evaluate.launches == before  # no kernel on the CPU


def test_evaluate_refuses_what_the_kernel_does_not_compute():
    mesh, plan, nodes, u, dsdX0 = _inputs(BOXES[0], torch.float64)
    with pytest.raises(ValueError, match="NeoHookean"):
        newton_element.evaluate(nodes, u, dsdX0, T.NeoHookean(), plan, mesh)
    with pytest.raises(ValueError, match="u shape"):
        newton_element.evaluate(nodes, u[:-3], dsdX0, MATERIAL, plan, mesh)
    with pytest.raises(ValueError, match="dsdX0 is torch.float32"):
        newton_element.evaluate(nodes, u, dsdX0.float(), MATERIAL, plan, mesh)


ROUTES = {
    # name: (mesh, material, SolverConfig keywords, takes the route)
    "box": (lambda: box_tets(3, 3, 3), MATERIAL, {}, True),
    "box_multigrid": (lambda: box_tets(4, 4, 4), MATERIAL,
                      dict(preconditioner="multigrid", linear_solver="cg"),
                      True),
    "ell": (lambda: unstructured_box_tets(3), MATERIAL, {}, False),
    "box_as_ell": (lambda: box_tets(3, 3, 3), MATERIAL,
                   dict(sparse_format="ell"), False),
    "box_neo_hookean": (lambda: box_tets(3, 3, 3), T.NeoHookean(), {}, False),
    "box_consistent": (lambda: box_tets(3, 3, 3), MATERIAL,
                       dict(tangent="consistent"), False),
    "box_no_kg": (lambda: box_tets(3, 3, 3), MATERIAL,
                  dict(geometric_stiffness=False), False),
    "tris_2d": (lambda: rect_tris(4, 3), T.LinearIsotropicPlaneStrain(),
                {}, False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_route_is_taken_only_where_it_applies(name):
    make_mesh, material, cfg, takes = ROUTES[name]
    system = T.FEMSystem(make_mesh(), material, True, T.SolverConfig(**cfg),
                         device="cpu")
    assert system._newton_element is takes


def _twist(mesh):
    z = mesh.nodes[:, 2]
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs += [DirichletBC(top, d, 0.0, True) for d in range(3)]
    return InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={}, dirichlet_bcs=bcs,
        neumann_bcs=[], material_type="Elastic",
        material_params=[1000.0, 0.3], geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.004, max_time=0.012, min_inc=1e-5,
                       max_inc=0.004))


TWISTS = {
    "multigrid": dict(preconditioner="multigrid", linear_solver="cg"),
    "stabilized": dict(preconditioner="multigrid", linear_solver="cg",
                       stabilize_factor=2e-4),
    "fused": dict(fused_newton=True),
}


@pytest.mark.parametrize("name", sorted(TWISTS))
def test_a_cpu_twist_gives_the_einsum_routes_displacements(name):
    mesh = box_tets(4, 4, 4)
    inp = _twist(mesh)
    hook = make_rotation_dirichlet((0.5, 0.5, 0.0))
    got = {}
    for route in (True, False):
        system = T.FEMSystem(mesh, MATERIAL, True,
                             T.SolverConfig(**TWISTS[name]), device="cpu")
        assert system._newton_element
        system._newton_element = route
        report = system.solve(inp, hook)
        assert report.success
        got[route] = (system.dof, [(r.newton_iters, r.residual)
                                   for r in report.increments])
    assert torch.equal(got[True][0], got[False][0])
    assert got[True][1] == got[False][1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: M9 is a CUDA kernel with no CPU "
                    "mode (its plain version is held above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("dims", BOXES + [(2, 3, 1), (17, 9, 13)], ids=str)
def test_kernel_matches_its_plain_version(card, dims, dtype):
    mesh, plan, nodes, u, dsdX0 = _inputs(dims, dtype, device=card)
    before = newton_element.evaluate.launches
    got = newton_element.evaluate(nodes, u, dsdX0, MATERIAL, plan, mesh)
    assert newton_element.evaluate.launches == before + 1
    want = newton_element_plain(nodes.cpu(), u.cpu(), dsdX0.cpu(), MATERIAL,
                                mesh)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())
    again = newton_element.evaluate(nodes, u, dsdX0, MATERIAL, plan, mesh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_kernel_launches_once_an_evaluation_on_its_route(card, name):
    make_mesh, material, cfg, takes = ROUTES[name]
    mesh = make_mesh()
    system = T.FEMSystem(mesh, material, True, T.SolverConfig(**cfg),
                         device=card)
    fixed = torch.zeros(mesh.n_dof, dtype=torch.bool, device=card)
    zero = torch.zeros(mesh.n_dof, dtype=system.dtype, device=card)
    before = newton_element.evaluate.launches
    for _ in range(2):
        system._newton_eval(system.dof, zero, fixed, zero)
    assert newton_element.evaluate.launches - before == (2 if takes else 0)
