from femcy_tpu_torch.materials.constitutive import (
    LinearIsotropic,
    LinearIsotropicPlaneStrain,
    LinearIsotropicPlaneStress,
    Material,
    NeoHookean,
    material_from_inp,
)

__all__ = [
    "Material",
    "LinearIsotropic",
    "LinearIsotropicPlaneStress",
    "LinearIsotropicPlaneStrain",
    "NeoHookean",
    "material_from_inp",
]
