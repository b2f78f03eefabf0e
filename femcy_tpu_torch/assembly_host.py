"""Host (numpy, f64) twins of the device assembly: the exactly assembled
global stiffness of any mesh, as scipy CSR.

Host copy of ``femcy_tpu.assembly_host``.  In the JAX package it is the
f64 operator and residual of mixed-precision refinement; in the port it is
also the oracle the card is held against (``chip_smoke.py``): the
assembled operator of a general mesh (the counterpart of the box's
analytic operator), and the internal force of a Newton state
(``internal_force_host``).  Same math as assembly.py (reference
updated-Lagrangian assembly, stiffnessMtrx.py:132-216, 532-556, 609-644);
pure numpy.
"""

from __future__ import annotations

import numpy as np

from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.topology import ELLPattern


def b_matrix_host(dsdx: np.ndarray) -> np.ndarray:
    """Voigt B (same row order as assembly.b_matrix): (E, G, n, dm) ->
    (E, G, nv, n*dm)."""
    E, G, n, dm = dsdx.shape
    if dm == 2:
        B = np.zeros((E, G, 3, n * dm))
        Nx, Ny = dsdx[..., 0], dsdx[..., 1]
        B[:, :, 0, 0::2] = Nx
        B[:, :, 1, 1::2] = Ny
        B[:, :, 2, 0::2] = Ny
        B[:, :, 2, 1::2] = Nx
    else:
        B = np.zeros((E, G, 6, n * dm))
        Nx, Ny, Nz = dsdx[..., 0], dsdx[..., 1], dsdx[..., 2]
        B[:, :, 0, 0::3] = Nx
        B[:, :, 1, 1::3] = Ny
        B[:, :, 2, 2::3] = Nz
        B[:, :, 3, 0::3] = Ny
        B[:, :, 3, 1::3] = Nx
        B[:, :, 4, 0::3] = Nz
        B[:, :, 4, 2::3] = Nx
        B[:, :, 5, 1::3] = Nz
        B[:, :, 5, 2::3] = Ny
    return B


def element_stiffness_block_host(
    nodes: np.ndarray, elements: np.ndarray, element, C: np.ndarray
) -> np.ndarray:
    """f64 element stiffnesses of one homogeneous block of elements on the
    initial configuration: (E, edof, edof)."""
    x = np.asarray(nodes, np.float64)[elements]
    dN = np.asarray(element.dshape_at_gp, np.float64)
    w = np.asarray(element.gauss_weights, np.float64)
    dxdn = np.einsum("enD,gnd->egDd", x, dN)
    inv = np.linalg.inv(dxdn)
    vol = np.linalg.det(dxdn) * w[None]
    dsdx = np.einsum("gnd,egdD->egnD", dN, inv)
    B = b_matrix_host(dsdx)
    # batched-matmul form of einsum("egai,ab,egbj,eg->eij", B, C, B, vol):
    # two pairwise products instead of one 4-operand contraction (~5x
    # faster in numpy at 0.5M C3D4 elements)
    CB = np.einsum("ab,egbj->egaj", np.asarray(C, np.float64), B)
    CB *= vol[..., None, None]
    E_, G_, nv_, ed_ = B.shape
    return np.matmul(
        B.reshape(E_, G_ * nv_, ed_).transpose(0, 2, 1),
        CB.reshape(E_, G_ * nv_, ed_),
    )


def element_stiffness_host(mesh: FEMesh, C: np.ndarray) -> np.ndarray:
    """f64 element stiffnesses on the initial configuration: (E, edof, edof)."""
    return element_stiffness_block_host(
        mesh.nodes, mesh.elements, mesh.element, C
    )


def assemble_csr_host(mesh: FEMesh, pattern: ELLPattern, C: np.ndarray):
    """The raw (no-BC) f64 global stiffness as scipy CSR."""
    Ke = element_stiffness_host(mesh, C)
    # bincount is ~5x np.add.at for this scatter shape
    values = np.bincount(
        pattern.ensure_scatter_targets(),
        weights=Ke.reshape(-1),
        minlength=pattern.n_dof * pattern.width,
    )
    return pattern.to_scipy(values.reshape(pattern.n_dof, pattern.width))


def dirichlet_csr_host(K, rhs, fixed, sval):
    """Symmetric zero-one elimination on the f64 CSR operator (the host
    twin of bc.apply_dirichlet_linear / solvers.dia.dia_dirichlet_linear)."""
    import scipy.sparse as sp

    fixed = np.asarray(fixed, bool)
    sval = np.asarray(sval, np.float64)
    rhs = np.asarray(rhs, np.float64).copy()
    rhs -= K @ np.where(fixed, sval, 0.0)
    rhs[fixed] = sval[fixed]
    free = sp.diags((~fixed).astype(np.float64))
    K_bc = (free @ K @ free + sp.diags(fixed.astype(np.float64))).tocsr()
    return K_bc, rhs


# --------------------------------------------------------------------------- #
# f64 nonlinear residual twins
# --------------------------------------------------------------------------- #
def _gradients_and_volume_host(coords, elements, dN, w):
    """numpy twin of assembly.gradients_and_volume (f64)."""
    x = coords[elements]
    dxdn = np.einsum("enD,gnd->egDd", x, dN)
    inv = np.linalg.inv(dxdn)
    dsdx = np.einsum("gnd,egdD->egnD", dN, inv)
    vol = np.linalg.det(dxdn) * w[None]
    return dsdx, vol


def gp_stress_host(F: np.ndarray, material, large: bool) -> np.ndarray:
    """Batched f64 Cauchy stress (E, G, dm, dm), the numpy twin of
    assembly.gp_stress over materials/constitutive.py's closed forms.

    Dispatches on the material class by name, so this module stays
    numpy-only."""
    name = type(material).__name__
    dm = F.shape[-1]
    eye = np.eye(3)

    def _voigt(E3):  # (..., 3, 3) -> (..., 6) strain Voigt
        return np.stack(
            [E3[..., 0, 0], E3[..., 1, 1], E3[..., 2, 2],
             E3[..., 0, 1] + E3[..., 1, 0],
             E3[..., 2, 0] + E3[..., 0, 2],
             E3[..., 1, 2] + E3[..., 2, 1]], axis=-1,
        )

    def _sym(s):  # (..., 6) stress Voigt -> (..., 3, 3)
        out = np.zeros(s.shape[:-1] + (3, 3))
        out[..., 0, 0], out[..., 1, 1], out[..., 2, 2] = (
            s[..., 0], s[..., 1], s[..., 2])
        out[..., 0, 1] = out[..., 1, 0] = s[..., 3]
        out[..., 2, 0] = out[..., 0, 2] = s[..., 4]
        out[..., 1, 2] = out[..., 2, 1] = s[..., 5]
        return out

    if name == "NeoHookean":
        J = np.linalg.det(F)[..., None, None]
        B = F @ np.swapaxes(F, -1, -2)
        return (2.0 * material.C1 / J * (B - eye)
                + 2.0 * material.D1 * (J - 1.0) * eye)

    # linear-elastic family: embed F in 3D (plane-stress thickness closure /
    # plane-strain F33=1), PK2 from Green strain, push forward
    if dm == 2:
        F3 = np.zeros(F.shape[:-2] + (3, 3))
        F3[..., :2, :2] = F
        if name == "LinearIsotropicPlaneStress":
            nu = material.poisson_ratio
            F3[..., 2, 2] = 1.0 - nu / (1.0 - nu) * (
                F[..., 0, 0] + F[..., 1, 1] - 2.0
            )
        elif name == "LinearIsotropicPlaneStrain":
            F3[..., 2, 2] = 1.0
        else:
            raise NotImplementedError(
                f"no f64 host twin for 2D material {name}")
        C66 = np.asarray(material.C_6x6, np.float64)
    else:
        if name != "LinearIsotropic":
            raise NotImplementedError(f"no f64 host twin for material {name}")
        F3 = F
        C66 = np.asarray(material.C, np.float64)

    if large:
        E3 = (np.swapaxes(F3, -1, -2) @ F3 - eye) / 2.0
    else:
        E3 = (F3 + np.swapaxes(F3, -1, -2)) / 2.0 - eye
    s = _sym(np.einsum("ab,...b->...a", C66, _voigt(E3)))
    if not large:
        return s[..., :dm, :dm]
    J = np.linalg.det(F3)[..., None, None]
    return (F3 @ s @ np.swapaxes(F3, -1, -2) / J)[..., :dm, :dm]


def internal_force_host(mesh: FEMesh, material, dof: np.ndarray,
                        large: bool = True) -> np.ndarray:
    """f64 internal nodal force at displacement ``dof``: the numpy twin of
    the device path (deformation gradient on the initial configuration,
    Cauchy stress, gradients and volumes on the current configuration;
    ref: stiffnessMtrx.py:532-556 + 609-644)."""
    nodes = np.asarray(mesh.nodes, np.float64)
    dN = np.asarray(mesh.element.dshape_at_gp, np.float64)
    w = np.asarray(mesh.element.gauss_weights, np.float64)
    dm = mesh.dm
    u = np.asarray(dof, np.float64).reshape(-1, dm)
    dsdX0, _ = _gradients_and_volume_host(nodes, mesh.elements, dN, w)
    F = np.einsum("enU,egnX->egUX", u[mesh.elements], dsdX0) + np.eye(dm)
    sigma = gp_stress_host(F, material, large=large)
    dsdx, vol = _gradients_and_volume_host(nodes + u, mesh.elements, dN, w)
    f_elem = np.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    dof_ids = (
        mesh.elements.astype(np.int64)[:, :, None] * dm + np.arange(dm)
    ).reshape(-1)
    # bincount is ~5x np.add.at for this scatter shape
    return np.bincount(dof_ids, weights=f_elem.reshape(-1),
                       minlength=mesh.n_dof)
