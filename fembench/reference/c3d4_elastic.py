"""Plain reference of the configurations' physics: 4-node tetrahedra (C3D4,
linear shape functions, one integration point) of a linear isotropic
elastic solid, small strain or large rotation (Green strain, second
Piola-Kirchhoff stress S = lam tr(E) I + 2 mu E, Cauchy stress
F S F^T / det F).

Written from the equations in plain torch, matrix-free: the stiffness is
never assembled; K u is the nodal force of the stress that u strains.  It
imports nothing of the program and takes nothing the program made: the
benchmark hands it the mesh arrays it built itself, the material, and the
program's outputs to judge.  Every function takes element blocks of any
size, so a caller can run it in blocks on the card.
"""

from __future__ import annotations

import torch


def lame(modulus: float, poisson_ratio: float):
    """(lambda, mu) of an isotropic material."""
    lam = modulus * poisson_ratio / ((1 + poisson_ratio) * (1 - 2 * poisson_ratio))
    mu = modulus / (2 * (1 + poisson_ratio))
    return lam, mu


def shape_gradients(X):
    """Reference-configuration shape-function gradients and volumes of
    tets with corner coordinates ``X`` (E, 4, 3): (E, 4, 3) gradients
    dN_a/dX and (E,) volumes det[X1-X0, X2-X0, X3-X0] / 6."""
    J = (X[:, 1:, :] - X[:, :1, :]).transpose(1, 2)  # columns: edge vectors
    Jinv = torch.linalg.inv(J)  # rows: gradients of N1, N2, N3
    g = torch.cat([-Jinv.sum(dim=1, keepdim=True), Jinv], dim=1)
    return g, torch.linalg.det(J) / 6.0


def displacement_gradient(u_e, g):
    """H = sum_a u_a (x) grad N_a, (E, 3, 3), from element nodal
    displacements (E, 4, 3) and gradients (E, 4, 3)."""
    return torch.einsum("eai,eaj->eij", u_e, g)


def small_strain(H):
    return 0.5 * (H + H.transpose(1, 2))


def green_strain(H):
    return 0.5 * (H + H.transpose(1, 2) + H.transpose(1, 2) @ H)


def isotropic(eps, lam: float, mu: float):
    """lam tr(eps) I + 2 mu eps."""
    tr = eps.diagonal(dim1=1, dim2=2).sum(-1)
    eye = torch.eye(3, dtype=eps.dtype, device=eps.device)
    return lam * tr[:, None, None] * eye + 2.0 * mu * eps


def large_stresses(H, lam: float, mu: float):
    """(first Piola-Kirchhoff P = F S, Cauchy F S F^T / det F) of the
    St Venant-Kirchhoff solid."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    F = eye + H
    S = isotropic(green_strain(H), lam, mu)
    P = F @ S
    cauchy = P @ F.transpose(1, 2) / torch.linalg.det(F)[:, None, None]
    return P, cauchy


def mises(sigma):
    """von Mises stress of (E, 3, 3) stresses."""
    tr = sigma.diagonal(dim1=1, dim2=2).sum(-1)
    eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
    dev = sigma - tr[:, None, None] / 3.0 * eye
    return torch.sqrt(1.5 * (dev * dev).sum(dim=(1, 2)))


def nodal_force(P, g, vol, elements, n_nodes: int):
    """Assembled nodal force sum_e vol_e P_e grad N_a, (n_nodes, 3): the
    internal force of a first Piola-Kirchhoff (or, in small strain, the
    Cauchy) stress field on the reference configuration."""
    f_e = vol[:, None, None] * torch.einsum("eij,eaj->eai", P, g)
    out = torch.zeros(n_nodes, 3, dtype=P.dtype, device=P.device)
    out.index_add_(0, elements.reshape(-1), f_e.reshape(-1, 3))
    return out


class Model:
    """The reference's view of one configuration: the mesh and material,
    on ``device`` in float64, and the per-element geometry.

    ``block`` elements at a time go through each element computation, so
    the reference fits beside whatever the card still holds."""

    def __init__(self, nodes, elements, modulus: float, poisson_ratio: float,
                 device, block: int = 1 << 20):
        self.device = torch.device(device)
        self.nodes = torch.as_tensor(nodes, dtype=torch.float64,
                                     device=self.device)
        self.elements = torch.as_tensor(elements, dtype=torch.int64,
                                        device=self.device)
        self.lam, self.mu = lame(modulus, poisson_ratio)
        self.block = block
        g, vol = [], []
        for e in self._blocks():
            gb, vb = shape_gradients(self.nodes[e])
            g.append(gb)
            vol.append(vb)
        self.g = torch.cat(g)
        self.vol = torch.cat(vol)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    def _blocks(self):
        E = self.elements.shape[0]
        for s in range(0, E, self.block):
            yield self.elements[s:s + self.block]

    def _slices(self):
        E = self.elements.shape[0]
        for s in range(0, E, self.block):
            yield slice(s, s + self.block)

    def _H(self, u, sl):
        return displacement_gradient(u[self.elements[sl]], self.g[sl])

    def recover(self, u, large: bool):
        """(strain, Cauchy stress, Mises) per element of the displacement
        ``u`` (n_nodes, 3): small strain and stress, or Green strain and
        the large-rotation Cauchy stress."""
        strain, stress = [], []
        for sl in self._slices():
            H = self._H(u, sl)
            if large:
                strain.append(green_strain(H))
                stress.append(large_stresses(H, self.lam, self.mu)[1])
            else:
                eps = small_strain(H)
                strain.append(eps)
                stress.append(isotropic(eps, self.lam, self.mu))
        stress = torch.cat(stress)
        return torch.cat(strain), stress, mises(stress)

    def internal_force(self, u, large: bool):
        """Assembled internal force (n_nodes, 3) at the displacement ``u``:
        K u in small strain, the St Venant-Kirchhoff force otherwise."""
        out = torch.zeros(self.n_nodes, 3, dtype=torch.float64,
                          device=self.device)
        for sl in self._slices():
            H = self._H(u, sl)
            if large:
                P = large_stresses(H, self.lam, self.mu)[0]
            else:
                P = isotropic(small_strain(H), self.lam, self.mu)
            out += nodal_force(P, self.g[sl], self.vol[sl],
                               self.elements[sl], self.n_nodes)
        return out
