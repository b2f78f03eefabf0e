"""The port's structured assembly and element math against femcy_tpu's.

- the plain prep + accumulate against JAX ``structured_assemble_coords(...,
  accumulate="xla")`` and the f64 ``analytic_structured_dia_values``;
- the accumulate kernel's CSR combo table and gather rule, emulated in
  numpy, against the plain accumulate (the CUDA kernel itself runs only on
  the card, in chip_smoke.py);
- linalg, materials and the element kinematics against their JAX twins.

Tolerance: float64 results agree to 1e-12 relative to the largest entry
(the same arithmetic summed in another order; f64 roundoff is ~1e-16 per
operation).  The kernel emulation sums in the kernel's order, so it is
held to the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu.assembly as jasm
import femcy_tpu.materials as jmat
from femcy_tpu.meshgen import box_tets as j_box
from femcy_tpu.solvers.dia import build_structured_dia_pattern as j_pattern
from femcy_tpu.structured import (
    analytic_structured_dia_values as j_analytic,
    build_structured_plan as j_plan,
    structured_assemble_coords as j_assemble,
)

import femcy_tpu_torch.assembly as tasm
import femcy_tpu_torch.materials as tmat
from femcy_tpu_torch import convert
from femcy_tpu_torch.kernels import structured_accumulate as kacc
from femcy_tpu_torch.structured import (
    accumulate_planes,
    analytic_structured_dia_values as t_analytic,
    stiffness_planes,
    structured_element_nodes,
)

TOL = 1e-12
BOXES = [(3, 4, 2), (4, 3, 5, 2.0, 1.5, 1.0)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _setup(dims, material=None):
    jm = j_box(*dims)
    tm = convert.mesh_from(jm)
    mat = material or jmat.LinearIsotropic(200.0, 0.3)
    from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
    from femcy_tpu_torch.structured import build_structured_plan

    td = build_structured_dia_pattern(tm)
    return jm, tm, mat, td, build_structured_plan(tm, td)


def _planes(tm, mat):
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    return stiffness_planes(
        t(tm.nodes), tm, t(tm.element.dshape_at_gp),
        t(tm.element.gauss_weights), t(mat.C),
    )


@pytest.mark.parametrize("dims", BOXES)
def test_prep_accumulate_matches_analytic(dims):
    jm, tm, mat, td, tplan = _setup(dims)
    oracle = j_analytic(jm, mat.C, j_pattern(jm))
    np.testing.assert_array_equal(t_analytic(tm, mat.C, td), oracle)
    out = accumulate_planes(_planes(tm, mat), tplan).numpy()
    assert out.shape == oracle.shape == (tm.n_dof, td.n_offsets)
    assert _rel(out, oracle) < TOL


def test_prep_accumulate_matches_jax_xla():
    jm, tm, mat, _, tplan = _setup(BOXES[1])
    jplan = j_plan(jm, j_pattern(jm))
    assemble = jax.jit(lambda x, dN, w, C: j_assemble(
        x, jm, dN, w, C, jplan, accumulate="xla"))
    ref = assemble(
        jnp.asarray(jm.nodes), jnp.asarray(jm.element.dshape_at_gp),
        jnp.asarray(jm.element.gauss_weights), jnp.asarray(mat.C),
    )
    assert _rel(accumulate_planes(_planes(tm, mat), tplan), ref) < TOL


def _emulate_kernel(planes, table):
    """numpy re-statement of csrc/structured_accumulate.cu's gather rule:
    out[(node*3 + i)*K + k] = sum over column c = i*K + k's combos, in CSR
    order, of planes[plane, cell(node - shift)] where that cell exists."""
    plan = table.plan
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    flat = planes.reshape(6 * 144, nx * ny * nz).numpy()
    ix, iy, iz = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1),
                             np.arange(nz + 1), indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    out = np.zeros((ix.size, table.n_cols))
    for c in range(table.n_cols):
        lo, hi = table.col_start[c], table.col_start[c + 1]
        for plane, dx, dy, dz in table.entries[lo:hi]:
            cx, cy, cz = ix - dx, iy - dy, iz - dz
            ok = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
                  & (cz >= 0) & (cz < nz))
            cell = (cx * ny + cy) * nz + cz
            out[ok, c] += flat[plane, cell[ok]]
    return out.reshape(-1, K)


@pytest.mark.parametrize("dims", BOXES)
def test_accumulate_table_and_gather_rule(dims):
    _, tm, mat, td, tplan = _setup(dims)
    table = kacc.AccumulateTable(tplan)
    K = td.n_offsets
    assert table.n_cols == 3 * K
    assert table.col_start[0] == 0 and table.col_start[-1] == 864
    assert table.entries.shape == (864, 4) and table.entries.dtype == np.int32
    assert (np.diff(table.col_start) >= 0).all()
    planes = _planes(tm, mat)
    ref = accumulate_planes(planes, tplan).numpy()
    assert _rel(_emulate_kernel(planes, table), ref) < TOL


def test_accumulate_wrapper_cpu_and_checks():
    _, tm, mat, _, tplan = _setup((3, 2, 2))
    table = kacc.AccumulateTable(tplan)
    planes = _planes(tm, mat)
    before = kacc.accumulate.launches
    assert torch.equal(kacc.accumulate(planes, table),
                       accumulate_planes(planes, tplan))
    assert kacc.accumulate.launches == before
    with pytest.raises(ValueError):
        kacc.accumulate(planes[:, :, :-1], table)
    with pytest.raises(ValueError):
        kacc.accumulate(
            planes.transpose(1, 2).contiguous().transpose(1, 2), table)
    with pytest.raises(TypeError):
        kacc.accumulate(planes.to(torch.int64), table)
    col_start, entries = table.on("cpu")
    assert col_start.dtype == entries.dtype == torch.int32


def test_structured_element_nodes_matches_gather():
    _, tm, _, _, _ = _setup((3, 4, 2))
    vals = np.random.default_rng(1).standard_normal((tm.n_nodes, 3))
    out = structured_element_nodes(torch.from_numpy(vals), tm).numpy()
    np.testing.assert_array_equal(out, vals[tm.elements])


@pytest.mark.parametrize(
    "material",
    [
        jmat.LinearIsotropic(1000.0, 0.3),
        jmat.LinearIsotropicPlaneStress(200.0, 0.25),
        jmat.LinearIsotropicPlaneStrain(200.0, 0.45),
        jmat.NeoHookean(0.4, 0.00025),
    ],
    ids=lambda m: type(m).__name__,
)
def test_materials_match_jax(material):
    tm_ = convert.material_from(material)
    np.testing.assert_array_equal(tm_.C, material.C)
    assert (tm_.type, tm_.dm) == (material.type, material.dm)
    dm = material.dm
    rng = np.random.default_rng(5)
    F = np.eye(dm) + 0.05 * rng.standard_normal((6, 2, dm, dm))
    Ft = torch.from_numpy(F)
    for name in ("cauchy_small", "cauchy_large", "energy_density"):
        ref = jax.vmap(jax.vmap(getattr(material, name)))(jnp.asarray(F))
        assert _rel(getattr(tm_, name)(Ft), ref) < TOL, name


def test_material_from_inp_matches():
    for etype, mtype, params in [
        ("C3D4", "Elastic", [1000.0, 0.3]),
        ("CPS3", "Elastic", [100.0, 0.2]),
        ("CPE4", "Elastic", [100.0, 0.2]),
        ("C3D10", "Hyperelastic, neo hooke", [0.4, 4000.0]),
    ]:
        j = jmat.material_from_inp(mtype, params, etype)
        t = tmat.material_from_inp(mtype, params, etype)
        assert type(j).__name__ == type(t).__name__
        np.testing.assert_array_equal(j.C, t.C)


def test_element_kinematics_match_jax():
    jm, tm, mat, _, _ = _setup((3, 2, 2))
    rng = np.random.default_rng(6)
    coords = jm.nodes + 0.02 * rng.standard_normal(jm.nodes.shape)
    dof = 0.01 * rng.standard_normal(jm.n_dof)
    dN, w = jm.element.dshape_at_gp, jm.element.gauss_weights
    j_ds, j_vol = jasm.gradients_and_volume(
        jnp.asarray(coords), jnp.asarray(jm.elements), jnp.asarray(dN), jnp.asarray(w))
    el = torch.as_tensor(tm.elements, dtype=torch.int64)
    t_ds, t_vol = tasm.gradients_and_volume(
        torch.from_numpy(coords), el, torch.from_numpy(dN), torch.from_numpy(w))
    assert _rel(t_ds, j_ds) < TOL and _rel(t_vol, j_vol) < TOL
    assert _rel(tasm.b_matrix(t_ds), jasm.b_matrix(j_ds)) < TOL
    C = mat.C
    for layout in ("eij", "ije"):
        assert _rel(
            tasm.element_stiffness(t_ds, t_vol, torch.from_numpy(C), layout=layout),
            jasm.element_stiffness(j_ds, j_vol, jnp.asarray(C), layout=layout),
        ) < TOL
    j_F = jasm.deformation_gradient(jnp.asarray(dof), jnp.asarray(jm.elements), j_ds)
    t_F = tasm.deformation_gradient(torch.from_numpy(dof), el, t_ds)
    assert _rel(t_F, j_F) < TOL
    tmat_ = convert.material_from(mat)
    for large in (False, True):
        assert _rel(tasm.gp_stress(t_F, tmat_, large),
                    jasm.gp_stress(j_F, mat, large)) < TOL
    assert _rel(tasm.gp_energy_density(t_F, tmat_),
                jasm.gp_energy_density(j_F, mat)) < TOL
