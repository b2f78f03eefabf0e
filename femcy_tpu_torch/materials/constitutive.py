"""Material zoo: constitutive models as batched torch functions.

Torch counterpart of ``femcy_tpu.materials.constitutive``.  A material is a
small frozen dataclass of elastic constants (the same fields as the JAX
package) plus functions ``F -> cauchy stress`` and ``F -> energy density``.
Where the JAX package writes them for ONE deformation gradient and ``vmap``s
them, here they take any batch of them, (..., dm, dm), with the batch
written out as leading dimensions.

Voigt ordering matches the reference throughout:
  2D: [e00, e11, gamma01]                 (sigma: [s00, s11, s01])
  3D: [e00, e11, e22, gamma01, gamma20, gamma12]
      (sigma: [s00, s11, s22, s01, s20, s12])
(ref: linear_isotropic.py:22-31, element strainMtrx row order.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from femcy_tpu_torch.linalg import det_small


def _sym_from_voigt_3d(s):
    """(..., 6) [s00,s11,s22,s01,s20,s12] -> (..., 3, 3) symmetric
    (ref: linear_isotropic.py:48-53)."""
    rows = [
        [s[..., 0], s[..., 3], s[..., 4]],
        [s[..., 3], s[..., 1], s[..., 5]],
        [s[..., 4], s[..., 5], s[..., 2]],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _voigt_strain_3d(E):
    """(..., 3, 3) symmetric strain -> (..., 6) [E00,E11,E22,2E01,2E20,2E12]."""
    return torch.stack(
        [E[..., 0, 0], E[..., 1, 1], E[..., 2, 2],
         2.0 * E[..., 0, 1], 2.0 * E[..., 2, 0], 2.0 * E[..., 1, 2]],
        dim=-1,
    )


def _apply(C: np.ndarray, v):
    """C @ v over the trailing axis, C in v's dtype and on v's device."""
    Ct = torch.as_tensor(C, dtype=v.dtype, device=v.device)
    return torch.einsum("ab,...b->...a", Ct, v)


def _eye(F, n: int):
    return torch.eye(n, dtype=F.dtype, device=F.device)


def _embed_3d(F, f33):
    """(..., 2, 2) F and (...,) F33 (or a float) -> (..., 3, 3) with zero
    coupling.  Out of place, so that forward-mode differentiation
    (``assembly.consistent_tangent``) can pass through it."""
    f33 = torch.as_tensor(f33, dtype=F.dtype, device=F.device).expand(
        F.shape[:-2])
    z = torch.zeros_like(f33)
    rows = [
        torch.stack([F[..., 0, 0], F[..., 0, 1], z], dim=-1),
        torch.stack([F[..., 1, 0], F[..., 1, 1], z], dim=-1),
        torch.stack([z, z, f33], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


@dataclasses.dataclass(frozen=True)
class Material:
    """Base class: static constants + batched constitutive functions.

    ``C`` is the (n_voigt, n_voigt) tangent used to build the stiffness
    matrix (the reference initialises the per-GP ``ddsdde`` to this constant
    and never updates it, stiffnessMtrx.py:64-67, 124-129).
    """

    type: str = dataclasses.field(init=False, default="3d")
    dm: int = dataclasses.field(init=False, default=3)

    @property
    def C(self) -> np.ndarray:
        raise NotImplementedError

    def cauchy_small(self, F):
        """Cauchy stress from F, small-deformation kinematics."""
        raise NotImplementedError

    def cauchy_large(self, F):
        """Cauchy stress from F, finite-deformation kinematics."""
        raise NotImplementedError

    def energy_density(self, F):
        """Elastic energy density psi(F)."""
        raise NotImplementedError


# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LinearIsotropic(Material):
    """3D linear isotropic elasticity (ref: material_zoo/linear_isotropic.py)."""

    modulus: float = 1.0
    poisson_ratio: float = 0.3

    def __post_init__(self):
        object.__setattr__(self, "type", "3d")
        object.__setattr__(self, "dm", 3)

    @property
    def G(self) -> float:
        return self.modulus / 2.0 / (1.0 + self.poisson_ratio)

    @property
    def C(self) -> np.ndarray:
        E, nu, G = self.modulus, self.poisson_ratio, self.G
        c00 = E * (1.0 - nu) / (1.0 + nu) / (1.0 - 2.0 * nu)
        c01 = E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)
        C = np.zeros((6, 6))
        C[:3, :3] = c01
        np.fill_diagonal(C[:3, :3], c00)
        C[3, 3] = C[4, 4] = C[5, 5] = G
        return C

    def cauchy_small(self, F):
        # ref: linear_isotropic.py:35-53
        E = (F + F.transpose(-1, -2)) / 2.0 - _eye(F, 3)
        return _sym_from_voigt_3d(_apply(self.C, _voigt_strain_3d(E)))

    def cauchy_large(self, F):
        # PK2 from Green strain, pushed forward (ref: linear_isotropic.py:55-76)
        Ft = F.transpose(-1, -2)
        E = (Ft @ F - _eye(F, 3)) / 2.0
        pk2 = _sym_from_voigt_3d(_apply(self.C, _voigt_strain_3d(E)))
        return F @ pk2 @ Ft / det_small(F)[..., None, None]

    def energy_density(self, F):
        # ref: linear_isotropic.py:78-99 (psi = E:C:E / 2 on Green strain)
        E = (F.transpose(-1, -2) @ F - _eye(F, 3)) / 2.0
        Ev = _voigt_strain_3d(E)
        return (Ev * _apply(self.C, Ev)).sum(-1) / 2.0


# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LinearIsotropicPlaneStress(Material):
    """Plane-stress linear isotropic
    (ref: material_zoo/linear_isotropic_plane_stress.py)."""

    modulus: float = 1.0
    poisson_ratio: float = 0.3

    def __post_init__(self):
        object.__setattr__(self, "type", "planeStress")
        object.__setattr__(self, "dm", 2)

    @property
    def G(self) -> float:
        return self.modulus / 2.0 / (1.0 + self.poisson_ratio)

    @property
    def C(self) -> np.ndarray:
        c00 = self.modulus / (1.0 - self.poisson_ratio**2)
        c01 = c00 * self.poisson_ratio
        return np.array([[c00, c01, 0.0], [c01, c00, 0.0], [0.0, 0.0, self.G]])

    @property
    def C_6x6(self) -> np.ndarray:
        # used to recover the full 3D stress state
        # (ref: linear_isotropic_plane_stress.py:22-31)
        c00 = self.modulus / (1.0 - self.poisson_ratio**2)
        c01 = c00 * self.poisson_ratio
        C = np.zeros((6, 6))
        C[0, 0] = C[1, 1] = c00
        C[0, 1] = C[1, 0] = c01
        C[3, 3] = self.G
        return C

    def _F_3d(self, F):
        # plane-stress thickness stretch: F33 = 1 - nu/(1-nu)*(F00+F11-2)
        # (ref: linear_isotropic_plane_stress.py:49-51)
        nu = self.poisson_ratio
        f33 = -nu / (1.0 - nu) * (F[..., 0, 0] + F[..., 1, 1] - 2.0) + 1.0
        return _embed_3d(F, f33)

    def cauchy_small(self, F):
        F3 = self._F_3d(F)
        E = (F3 + F3.transpose(-1, -2)) / 2.0 - _eye(F, 3)
        s = _sym_from_voigt_3d(_apply(self.C_6x6, _voigt_strain_3d(E)))
        return s[..., :2, :2]

    def cauchy_large(self, F):
        F3 = self._F_3d(F)
        F3t = F3.transpose(-1, -2)
        E = (F3t @ F3 - _eye(F, 3)) / 2.0
        pk2 = _sym_from_voigt_3d(_apply(self.C_6x6, _voigt_strain_3d(E)))
        s = F3 @ pk2 @ F3t / det_small(F3)[..., None, None]
        return s[..., :2, :2]

    def energy_density(self, F):
        F3 = self._F_3d(F)
        E = (F3.transpose(-1, -2) @ F3 - _eye(F, 3)) / 2.0
        Ev = _voigt_strain_3d(E)
        return (Ev * _apply(self.C_6x6, Ev)).sum(-1) / 2.0


# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LinearIsotropicPlaneStrain(Material):
    """Plane-strain linear isotropic
    (ref: material_zoo/linear_isotropic_plane_strain.py)."""

    modulus: float = 1.0
    poisson_ratio: float = 0.3

    def __post_init__(self):
        object.__setattr__(self, "type", "planeStrain")
        object.__setattr__(self, "dm", 2)

    @property
    def G(self) -> float:
        return self.modulus / 2.0 / (1.0 + self.poisson_ratio)

    def _terms(self):
        # the +1e-30 guard keeps nu -> 0.5 finite
        # (ref: linear_isotropic_plane_strain.py:17-22)
        term1 = self.modulus / (1.0 + self.poisson_ratio)
        term2 = self.poisson_ratio / (
            abs(1.0 - 2.0 * self.poisson_ratio) + 1.0e-30
        )
        return term1 * (1.0 + term2), term1 * term2

    @property
    def C(self) -> np.ndarray:
        c00, c01 = self._terms()
        return np.array([[c00, c01, 0.0], [c01, c00, 0.0], [0.0, 0.0, self.G]])

    @property
    def C_6x6(self) -> np.ndarray:
        # ref: linear_isotropic_plane_strain.py:30-39 (note C[2,2]=0 quirk
        # kept for parity -- it only feeds visualisation/energy paths)
        c00, c01 = self._terms()
        C = np.zeros((6, 6))
        C[0, 0] = C[1, 1] = c00
        C[0, 1] = C[1, 0] = c01
        C[0, 2] = C[2, 0] = C[1, 2] = C[2, 1] = c01
        C[3, 3] = self.G
        return C

    def _stress_2d(self, E):
        Ev = torch.stack(
            [E[..., 0, 0], E[..., 1, 1], E[..., 0, 1] + E[..., 1, 0]], dim=-1
        )
        s = _apply(self.C, Ev)
        return torch.stack(
            [torch.stack([s[..., 0], s[..., 2]], dim=-1),
             torch.stack([s[..., 2], s[..., 1]], dim=-1)],
            dim=-2,
        )

    def cauchy_small(self, F):
        # ref: linear_isotropic_plane_strain.py:44-66
        return self._stress_2d((F + F.transpose(-1, -2)) / 2.0 - _eye(F, 2))

    def cauchy_large(self, F):
        # ref: linear_isotropic_plane_strain.py:68-86
        Ft = F.transpose(-1, -2)
        pk2 = self._stress_2d((Ft @ F - _eye(F, 2)) / 2.0)
        return F @ pk2 @ Ft / det_small(F)[..., None, None]

    def energy_density(self, F):
        # F33 = 1 for plane strain (ref: linear_isotropic_plane_strain.py:88-100)
        F3 = _embed_3d(F, 1.0)
        E = (F3.transpose(-1, -2) @ F3 - _eye(F, 3)) / 2.0
        Ev = _voigt_strain_3d(E)
        return (Ev * _apply(self.C_6x6, Ev)).sum(-1) / 2.0


# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class NeoHookean(Material):
    """Compressible neo-Hookean solid (ref: material_zoo/neo_hookean.py).

    psi = C1 (I1 - 3 - 2 ln J) + D1 (J - 1)^2
    sigma = 2 C1 / J (B - I) + 2 D1 (J - 1) I
    """

    C1: float = 0.4
    D1: float = 0.00025

    def __post_init__(self):
        object.__setattr__(self, "type", "3d")
        object.__setattr__(self, "dm", 3)

    @property
    def C(self) -> np.ndarray:
        # constant approximate tangent: 4 C1 I6 + 2 D1 (1 (x) 1)
        # (ref: neo_hookean.py:22-42)
        vol = np.zeros((6, 6))
        vol[:3, :3] = 1.0
        return 4.0 * self.C1 * np.eye(6) + 2.0 * self.D1 * vol

    def _cauchy(self, F):
        J = det_small(F)[..., None, None]
        B = F @ F.transpose(-1, -2)
        eye = _eye(F, 3)
        return 2.0 * self.C1 / J * (B - eye) + 2.0 * self.D1 * (J - 1.0) * eye

    def cauchy_small(self, F):
        # the reference uses the same expression in both paths
        # (neo_hookean.py:45-81)
        return self._cauchy(F)

    def cauchy_large(self, F):
        return self._cauchy(F)

    def energy_density(self, F):
        J = det_small(F)
        B = F @ F.transpose(-1, -2)
        trB = B.diagonal(dim1=-2, dim2=-1).sum(-1)
        return self.C1 * (trB - 3.0 - 2.0 * torch.log(J)) + self.D1 * (J - 1.0) ** 2


# --------------------------------------------------------------------------- #
def material_from_inp(material_type: str, params, element_name: str) -> Material:
    """Build a material from the parsed ``.inp`` keyword + element family.

    Mirrors the element-type-driven dispatch of the reference reader
    (reader/inp_info.py:275-316): CPS* -> plane stress, CPE* -> plane strain,
    C3D* -> 3D; ``*Hyperelastic, neo hooke`` -> NeoHookean(C1, D1=1/p2).
    """
    family = element_name[:3]
    if family in ("CPS", "CPE"):
        if material_type != "Elastic":
            raise ValueError(
                "only linear elastic materials are supported for 2D elements "
                f"(got {material_type!r})"
            )
        cls = (
            LinearIsotropicPlaneStress if family == "CPS" else LinearIsotropicPlaneStrain
        )
        return cls(modulus=params[0], poisson_ratio=params[1])
    if family == "C3D":
        if material_type == "Elastic":
            return LinearIsotropic(modulus=params[0], poisson_ratio=params[1])
        if "neo hooke" in material_type.lower():
            return NeoHookean(C1=params[0], D1=1.0 / params[1])
        raise ValueError(f"material type {material_type!r} is not supported")
    raise ValueError(f"unsupported element family {element_name!r}")
