"""Element kinematics and element stiffness as batched torch ops.

Torch counterpart of the parts of ``femcy_tpu.assembly`` that the
structured linear slice runs: shape gradients and volumes, the B matrix,
B^T C B per element, the deformation gradient and the per-Gauss-point
stress and energy density.  Every function is a plain function of tensors
and keeps its inputs' dtype and device.  The scatters of the general ELL
path come with that slice.
"""

from __future__ import annotations

import torch

from femcy_tpu_torch.linalg import det_small, inv_small


def gradients_and_volume_x(x, dshape_gp, weights_gp):
    """Shape gradients and volumes from element coordinates.

    x : (E, n, dm) element node coordinates
    dshape_gp : (G, n, dm) d(shape)/d(natural) at the Gauss points
    weights_gp : (G,) Gauss weights

    Returns dsdx (E, G, n, dm) and vol (E, G) = det(dx/dxi) * weight.
    """
    dxdn = torch.einsum("enD,gnd->egDd", x, dshape_gp)
    inv = inv_small(dxdn)  # (E, G, d, D)
    dsdx = torch.einsum("gnd,egdD->egnD", dshape_gp, inv)
    vol = det_small(dxdn) * weights_gp[None, :]
    return dsdx, vol


def gradients_and_volume(coords, elements, dshape_gp, weights_gp):
    """gradients_and_volume_x on ``coords[elements]`` (coords (N, dm),
    elements (E, n) int64)."""
    return gradients_and_volume_x(coords[elements], dshape_gp, weights_gp)


def b_matrix(dsdx):
    """Voigt strain-displacement matrix from shape gradients.

    dsdx: (..., n, dm) -> B: (..., n_voigt, n*dm) with the reference's row
    order (2D: [e00, e11, gamma01]; 3D: [e00, e11, e22, gamma01, gamma20,
    gamma12], ref element_linear_tetrahedral.py:137-177).
    """
    dm = dsdx.shape[-1]
    lead = dsdx.shape[:-2]

    def interleave(*cols):
        # per-node column vectors -> flat (..., n*dm) dof-ordered row
        return torch.stack(cols, dim=-1).reshape(*lead, -1)

    Z = torch.zeros_like(dsdx[..., 0])
    if dm == 2:
        Nx, Ny = dsdx[..., 0], dsdx[..., 1]
        rows = [interleave(Nx, Z), interleave(Z, Ny), interleave(Ny, Nx)]
    else:
        Nx, Ny, Nz = dsdx[..., 0], dsdx[..., 1], dsdx[..., 2]
        rows = [
            interleave(Nx, Z, Z),
            interleave(Z, Ny, Z),
            interleave(Z, Z, Nz),
            interleave(Ny, Nx, Z),
            interleave(Nz, Z, Nx),
            interleave(Z, Nz, Ny),
        ]
    return torch.stack(rows, dim=-2)


def element_stiffness(dsdx, vol, C, layout: str = "eij"):
    """Ke = sum_gp B^T C B * vol -> (E, edof, edof).

    layout="ije" gives (edof, edof, E): the structured assembly reads Ke one
    (row-dof, col-dof) plane at a time, and in this layout each plane is a
    contiguous run of E values.
    (ref: stiffnessMtrx.py:161-186 without the scatter)
    """
    if layout not in ("eij", "ije"):
        raise ValueError(f"layout must be 'eij' or 'ije', got {layout!r}")
    B = b_matrix(dsdx)  # (E, G, nv, edof)
    CB = torch.einsum("ab,egbj->egaj", C, B)
    Ke = torch.einsum("egai,egaj,eg->eij", B, CB, vol)
    if layout == "ije":
        return Ke.permute(1, 2, 0).contiguous()
    return Ke


def deformation_gradient(dof, elements, dsdX0):
    """F = I + du/dX at each (element, GP) w.r.t. the initial configuration.

    dsdX0 : (E, G, n, dm) precomputed initial-configuration shape gradients.
    """
    dm = dsdX0.shape[-1]
    return deformation_gradient_u(dof.reshape(-1, dm)[elements], dsdX0)


def deformation_gradient_u(u_e, dsdX0):
    """deformation_gradient on element displacements u_e (E, n, dm)."""
    dm = dsdX0.shape[-1]
    dudX = torch.einsum("enU,egnX->egUX", u_e, dsdX0)
    return dudX + torch.eye(dm, dtype=u_e.dtype, device=u_e.device)


def gp_stress(F, material, large: bool):
    """Cauchy stress at every (element, GP) from the deformation gradient."""
    return material.cauchy_large(F) if large else material.cauchy_small(F)


def gp_energy_density(F, material):
    return material.energy_density(F)
