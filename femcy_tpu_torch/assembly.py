"""Element kinematics, element stiffness and internal force as batched
torch ops.

Torch counterpart of ``femcy_tpu.assembly``: shape gradients and volumes,
the B matrix, B^T C B per element, the geometric (initial-stress)
stiffness, the plain element-stiffness scatters of the general (ELL) path,
the deformation gradient, the element internal forces, the consistent
Newton tangent (forward-mode autodiff, ``torch.func.jvp``) and the
per-Gauss-point stress and energy density.  Every function is a plain
function of tensors and keeps its inputs' dtype and device.  On CUDA the
general path scatters the stiffness through the deterministic kernel of
kernels/ell_scatter.py (M1) instead of the indexed adds here; element
forces are summed into dofs by kernels/internal_force.py (M4) on every
device (``internal_force`` here is femcy_tpu's public segment-sum, which
no path of the port calls).
"""

from __future__ import annotations

import torch
import torch.func

from femcy_tpu_torch.linalg import det_small, inv_small
from femcy_tpu_torch.utils.timing import span

#: most elements x points x edof^2 of one call of the element-stiffness
#: einsum, whose intermediates (B, C B and their contiguous copies, each
#: G x 6 x edof an element) grow with it: 1M C3D4 stay one call, 64,000
#: C3D20 run in 24 blocks (``element_stiffness``)
KE_BLOCK_ENTRIES = 1 << 28


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
    """Ke = sum_gp B^T C B * vol -> (E, edof, edof), contiguous.

    layout="ije" gives (edof, edof, E): the structured assembly reads Ke one
    (row-dof, col-dof) plane at a time, and in this layout each plane is a
    contiguous run of E values.

    The einsum's intermediates dwarf Ke for many-point elements: one call
    for 64,000 C3D20 in float64 peaks at 24.9 GiB on an H100, Ke itself
    1.7 GiB.  So past ``KE_BLOCK_ENTRIES`` it runs on element blocks, each
    the same einsum (every element's sum in the same order), each block a
    span "femcy.assemble.ke.block"; below it, one call.
    (ref: stiffnessMtrx.py:161-186 without the scatter)
    """
    if layout not in ("eij", "ije"):
        raise ValueError(f"layout must be 'eij' or 'ije', got {layout!r}")
    E, G, n, dm = dsdx.shape
    edof = n * dm
    block = max(1, KE_BLOCK_ENTRIES // (G * edof * edof))
    if block >= E:
        Ke = _stiffness_einsum(dsdx, vol, C)
        if layout == "ije":
            return Ke.permute(1, 2, 0).contiguous()
        return Ke.contiguous()
    out = dsdx.new_empty((E, edof, edof) if layout == "eij"
                         else (edof, edof, E))
    for s in range(0, E, block):
        with span("femcy.assemble.ke.block"):
            Ke = _stiffness_einsum(dsdx[s:s + block], vol[s:s + block], C)
            if layout == "ije":
                out[:, :, s:s + block] = Ke.permute(1, 2, 0)
            else:
                out[s:s + block] = Ke
    return out


def _stiffness_einsum(dsdx, vol, C):
    """Ke (E, edof, edof) of ``element_stiffness``, in one call."""
    B = b_matrix(dsdx)  # (E, G, nv, edof)
    CB = torch.einsum("ab,egbj->egaj", C, B)
    return torch.einsum("egai,egaj,eg->eij", B, CB, vol)


def geometric_stiffness(dsdx, sigma, vol):
    """Initial-stress (geometric) stiffness: Kg[(a,i),(b,j)] = d_ij
    int grad(N_a) . sigma . grad(N_b) dv -> (E, edof, edof), contiguous.

    The reference's Newton Jacobian is the secant material stiffness only
    (README.md:93); adding this term gives the updated-Lagrangian tangent
    (SolverConfig.geometric_stiffness).
    """
    E, G, n, dm = dsdx.shape
    kg = torch.einsum("egaj,egjk,egbk,eg->eab", dsdx, sigma, dsdx, vol)
    eye = torch.eye(dm, dtype=dsdx.dtype, device=dsdx.device)
    return torch.einsum("eab,ij->eaibj", kg, eye).reshape(E, n * dm, n * dm)


def scatter_stiffness(Ke, scatter_targets, n_dof: int, width: int):
    """Element stiffnesses (E, edof, edof) -> padded ELL values
    (n_dof, width) by one indexed add over the dof-level targets, in Ke
    layout order."""
    flat = Ke.new_zeros(n_dof * width)
    flat.index_add_(0, scatter_targets, Ke.reshape(-1))
    return flat.reshape(n_dof, width)


def expand_block_targets(block_targets, node_width: int, dm: int, width: int,
                         npe: int):
    """NODE-block scatter map (E*npe*npe,) -> dof-level (E*edof*edof,), in
    Ke layout order.

    Contribution (e, a, di, b, dj) goes to (n*dm+di)*width + pos*dm + dj
    where block_targets[e, a, b] = n*node_width + pos.  Ke's flat order is
    k = (a*dm+di)*edof + (b*dm+dj); for each k the base entry is (a, b) and
    the in-block offset di*width + dj, so the expansion is one gather of
    the (E, npe*npe) base table by a static (edof*edof,) index plus a
    static offset.
    """
    bt = block_targets.reshape(-1, npe * npe).long()
    n = bt // node_width
    pos = bt % node_width
    base = (n * dm) * width + pos * dm  # (E, npe*npe)
    edof = npe * dm
    k = torch.arange(edof * edof, device=bt.device)
    a = k // (dm * edof)
    di = (k // edof) % dm
    b = (k % edof) // dm
    dj = k % dm
    return (base[:, a * npe + b] + (di * width + dj)[None, :]).reshape(-1)


def scatter_stiffness_blocks(Ke, block_targets, n_dof: int, width: int,
                             node_width: int, dm: int):
    """scatter_stiffness driven by the compact node-block map: the plain
    version of the scatter kernel's ELL route (kernels/ell_scatter.py)."""
    E, edof, _ = Ke.shape
    targets = expand_block_targets(
        block_targets, node_width, dm, width, edof // dm
    )
    return scatter_stiffness(Ke, targets, n_dof, width)


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


def element_internal_force(dsdx, sigma, vol):
    """Per-element nodal forces f[e, a, i] = sum_gp dsdx[a, :] . sigma[:, i]
    * vol -> (E, n, dm) (ref: stiffnessMtrx.py:609-644)."""
    return torch.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)


def internal_force(dsdx, sigma, vol, force_targets, n_dof: int):
    """Internal nodal force (n_dof,): the element forces
    (``element_internal_force``) summed into ``n_dof`` segments by
    ``force_targets`` (E * n * dm,) int64, femcy_tpu's segment-sum.

    A public helper for arbitrary segment ids, one ``index_add_``; no path
    of the port calls it.  The Newton path sums element forces with the
    deterministic kernel of kernels/internal_force.py (``scatter_force``,
    M4) on node plans.  On CUDA the atomics of ``index_add_`` make the
    last bits of the sum depend on the run.
    """
    f_elem = element_internal_force(dsdx, sigma, vol)
    out = f_elem.new_zeros(n_dof)
    return out.index_add_(0, force_targets, f_elem.reshape(-1))


def _element_internal_force(u_e, x0_e, dN, w, material):
    """Internal force of a batch of elements, (E, n, dm) displacements and
    initial coordinates -> (E, edof) forces.

    The same math as the global path (F from the initial configuration,
    Cauchy stress, gradients and volumes on the current configuration),
    written per element so that it can be differentiated.
    """
    dm = x0_e.shape[-1]
    dxdn0 = torch.einsum("enD,gnd->egDd", x0_e, dN)
    dsdX = torch.einsum("gnd,egdD->egnD", dN, inv_small(dxdn0))
    eye = torch.eye(dm, dtype=u_e.dtype, device=u_e.device)
    F = eye + torch.einsum("enU,egnX->egUX", u_e, dsdX)
    sigma = material.cauchy_large(F)
    x_e = x0_e + u_e
    dxdn = torch.einsum("enD,gnd->egDd", x_e, dN)
    dsdx = torch.einsum("gnd,egdD->egnD", dN, inv_small(dxdn))
    vol = det_small(dxdn) * w
    f = torch.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    return f.reshape(f.shape[0], -1)


def consistent_tangent(dof, elements, coords0, dN, w, material):
    """Exact per-element Newton tangent Ke = d f_int_e / d u_e by
    forward-mode autodiff -> (E, edof, edof): material, geometric and
    configuration terms, with no hand-derived tensor algebra."""
    dm = coords0.shape[1]
    u_e = dof.reshape(-1, dm)[elements]  # (E, n, dm)
    return consistent_tangent_elems(u_e, coords0[elements], dN, w, material)


def consistent_tangent_elems(u_e, x0_e, dN, w, material):
    """consistent_tangent on per-element arrays (E, n, dm).

    The ``torch.func.jvp`` of the batched element force with the unit
    seed e_j in every element gives column j of every element's Jacobian,
    the values the JAX package's scan of per-element JVPs gives; one
    ``torch.func.vmap`` over the edof seeds runs all the columns as one
    pass of batched ops (a loop of edof jvps costs edof times the op
    dispatches, which bound it at small and mid sizes).
    """
    E, n, dm = u_e.shape
    edof = n * dm
    u_flat = u_e.reshape(E, edof)

    def fe(u):
        return _element_internal_force(u.reshape(E, n, dm), x0_e, dN, w,
                                       material)

    def column(seed):
        return torch.func.jvp(fe, (u_flat,), (seed,))[1]

    eye = torch.eye(edof, dtype=u_e.dtype, device=u_e.device)
    seeds = eye[:, None, :].expand(edof, E, edof)
    cols = torch.func.vmap(column)(seeds)  # (edof, E, edof): [j, e, i]
    return cols.permute(1, 2, 0).contiguous()


def gp_stress(F, material, large: bool):
    """Cauchy stress at every (element, GP) from the deformation gradient."""
    return material.cauchy_large(F) if large else material.cauchy_small(F)


def gp_energy_density(F, material):
    return material.energy_density(F)
