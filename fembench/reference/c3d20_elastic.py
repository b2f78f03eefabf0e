"""Plain reference of 20-node quadratic bricks (Abaqus C3D20: serendipity
shape functions, full 3 x 3 x 3 Gauss integration) of a linear isotropic
elastic solid, small strain or large rotation (Green strain, St
Venant-Kirchhoff second Piola-Kirchhoff stress, Cauchy stress
F S F^T / det F): the material law of ``c3d4_elastic``, integrated at 27
points an element.

Node order (Abaqus): corners 1-8 at the natural coordinates of ``CORNERS``,
then the midpoints of edges 1-2, 2-3, 3-4, 4-1, 5-6, 6-7, 7-8, 8-5, 1-5,
2-6, 3-7, 4-8.  Gauss points: the products of the 3-point Gauss-Legendre
rule (-sqrt(3/5), 0, sqrt(3/5); weights 5/9, 8/9, 5/9) in each natural
direction, point 9 a + 3 b + c at (xi_a, eta_b, zeta_c): xi outermost,
zeta innermost.  ``recover`` gives every field at every point in that
order, (E, 27, ...).

Written from the equations in plain torch, float64, matrix-free: K u is
the nodal force of the stress that u strains.  It imports nothing of the
program and takes nothing the program made.  Element blocks of ``block``
elements go through each computation, so it fits beside what the card
still holds.
"""

from __future__ import annotations

import math

import torch

from fembench.harness import named

_law = named.module("reference", "c3d4_elastic")
lame, mises = _law.lame, _law.mises

#: natural coordinates of the corners, Abaqus order
CORNERS = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
           (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
#: the corner pairs whose midpoints are nodes 9-20
EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]


def natural_nodes():
    """(20, 3) natural coordinates of the nodes."""
    c = torch.tensor(CORNERS, dtype=torch.float64)
    mids = torch.stack([(c[a] + c[b]) / 2 for a, b in EDGES])
    return torch.cat([c, mids])


def gauss_rule():
    """(27, 3) points and (27,) weights, xi outermost, zeta innermost."""
    g = math.sqrt(0.6)
    x = torch.tensor([-g, 0.0, g], dtype=torch.float64)
    w = torch.tensor([5.0, 8.0, 5.0], dtype=torch.float64) / 9.0
    a, b, c = torch.meshgrid(x, x, x, indexing="ij")
    wa, wb, wc = torch.meshgrid(w, w, w, indexing="ij")
    pts = torch.stack([a, b, c], -1).reshape(-1, 3)
    return pts, (wa * wb * wc).reshape(-1)


def shape_derivatives(pts):
    """(G, 20, 3) derivatives dN_a / d(xi, eta, zeta) at ``pts`` (G, 3).

    A corner with natural coordinates p: N = (1/8) prod_d (1 + p_d x_d)
    (sum_d p_d x_d - 2), so dN/dx_d = (1/8) p_d prod_{e != d} (1 + p_e x_e)
    (sum_e p_e x_e - 1 + p_d x_d).  A midpoint with p_z = 0: N = (1/4)
    (1 - x_z^2) prod_{d != z} (1 + p_d x_d), each factor's derivative times
    the other two."""
    p = natural_nodes()  # (20, 3)
    x = pts[:, None, :]  # (G, 1, 3)
    edge = p == 0
    q = torch.where(edge, 1 - x * x, 1 + p * x)  # (G, 20, 3)
    dq = torch.where(edge, -2 * x, p.expand_as(q))
    others = torch.stack([q[..., 1] * q[..., 2], q[..., 0] * q[..., 2],
                          q[..., 0] * q[..., 1]], -1)
    s = (p * x).sum(-1, keepdim=True)
    corner = p * others * (s - 1 + p * x) / 8
    mid = dq * others / 4
    is_mid = edge.any(-1, keepdim=True)
    return torch.where(is_mid, mid, corner)


def shape_gradients(X, dN, w):
    """Reference-configuration shape-function gradients (E, G, 20, 3) and
    point volumes (E, G), det(dX/dxi) times the weight, of bricks with
    node coordinates ``X`` (E, 20, 3)."""
    J = torch.einsum("eai,gaj->egij", X, dN)  # dX_i / dxi_j
    g = torch.einsum("gaj,egjk->egak", dN, torch.linalg.inv(J))
    return g, torch.linalg.det(J) * w


def _flat(fn, H, *args):
    """``fn`` of c3d4_elastic's (n, 3, 3) batches on (E, G, 3, 3)."""
    out = fn(H.reshape(-1, 3, 3), *args)
    if isinstance(out, tuple):
        return tuple(o.reshape(H.shape) for o in out)
    return out.reshape(H.shape)


class Model:
    """The reference's view of one configuration: the mesh and material,
    on ``device`` in float64, and the per-point geometry."""

    def __init__(self, nodes, elements, modulus: float, poisson_ratio: float,
                 device, block: int = 1 << 15):
        self.device = torch.device(device)
        self.nodes = torch.as_tensor(nodes, dtype=torch.float64,
                                     device=self.device)
        self.elements = torch.as_tensor(elements, dtype=torch.int64,
                                        device=self.device)
        self.lam, self.mu = lame(modulus, poisson_ratio)
        self.block = block
        pts, w = gauss_rule()
        dN = shape_derivatives(pts).to(self.device)
        w = w.to(self.device)
        g, vol = [], []
        for sl in self._slices():
            gb, vb = shape_gradients(self.nodes[self.elements[sl]], dN, w)
            g.append(gb)
            vol.append(vb)
        self.g = torch.cat(g)
        self.vol = torch.cat(vol)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    def _slices(self):
        E = self.elements.shape[0]
        for s in range(0, E, self.block):
            yield slice(s, s + self.block)

    def _H(self, u, sl):
        """Displacement gradients (e, 27, 3, 3) of the elements ``sl``."""
        return torch.einsum("eai,egaj->egij", u[self.elements[sl]],
                            self.g[sl])

    def _stresses(self, H, large: bool):
        """(strain, the stress that does work on the reference gradients,
        Cauchy stress) at every point."""
        if large:
            P, cauchy = _flat(_law.large_stresses, H, self.lam, self.mu)
            return _flat(_law.green_strain, H), P, cauchy
        eps = _flat(_law.small_strain, H)
        sigma = _flat(_law.isotropic, eps, self.lam, self.mu)
        return eps, sigma, sigma

    def recover(self, u, large: bool):
        """(strain (E, 27, 3, 3), Cauchy stress (E, 27, 3, 3), Mises
        (E, 27)) of the displacement ``u`` (n_nodes, 3): small strain and
        stress, or Green strain and the large-rotation Cauchy stress."""
        strain, stress = [], []
        for sl in self._slices():
            eps, _, sigma = self._stresses(self._H(u, sl), large)
            strain.append(eps)
            stress.append(sigma)
        stress = torch.cat(stress)
        return (torch.cat(strain), stress,
                mises(stress.reshape(-1, 3, 3)).reshape(stress.shape[:2]))

    def internal_force(self, u, large: bool):
        """Assembled internal force (n_nodes, 3) at the displacement ``u``:
        sum over points of vol P grad N_a, K u in small strain."""
        out = torch.zeros(self.n_nodes, 3, dtype=torch.float64,
                          device=self.device)
        for sl in self._slices():
            _, P, _ = self._stresses(self._H(u, sl), large)
            f_e = torch.einsum("egij,egaj,eg->eai", P, self.g[sl],
                               self.vol[sl])
            out.index_add_(0, self.elements[sl].reshape(-1),
                           f_e.reshape(-1, 3))
        return out
