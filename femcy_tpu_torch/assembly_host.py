"""Host (numpy, f64) twins of the device assembly: the exactly assembled
global stiffness of any mesh, as scipy CSR.

Host copy of the linear part of ``femcy_tpu.assembly_host`` (:24-110).
In the JAX package it is the f64 operator of mixed-precision refinement;
in the port it is also the oracle the card's assembled operator is held
against (``chip_smoke.py``), the general mesh's counterpart of the box's
analytic operator.  Same math as assembly.py (reference updated-Lagrangian
assembly, stiffnessMtrx.py:132-216); pure numpy.
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
