"""femcy_tpu_torch: the PyTorch / CUDA port of femcy_tpu for NVIDIA Hopper.

A second package beside ``femcy_tpu`` (the JAX reference, which it never
imports).  It grows slice by slice (ROADMAP.md); what exists now is the
static analysis of any mesh, linear or geometric-nonlinear: ``read_inp``
or ``meshgen`` -> ``FEMesh`` -> ``material_from_inp`` -> ``FEMSystem`` ->
assembly -> Dirichlet elimination -> direct solve or PCG (inside the
Newton loop on the nonlinear path) -> strain, stress, Mises, energy and
extrapolation.  A structured box (``meshgen.box_tets``)
assembles from its node coordinates into the analytic DIA layout and
solves with a Jacobi, block-Jacobi or geometric-multigrid PCG; any other
mesh goes through the ELL pattern (native C++ code, native/) and, where its
offsets are bounded, the general DIA layout, with a Jacobi (or, on DIA,
block-Jacobi) PCG.  The three TPU kernels of the JAX package are
rewritten by hand in CUDA for sm_90a (kernels/, csrc/): the DIA SpMV
(every DIA PCG iteration and multigrid level), the structured accumulate
(the two-stage box assembly) and the fused coordinates-to-DIA assembly
(the isotropic box default); so are the general path's deterministic
stiffness scatter and ELL SpMV, and the Newton path's internal-force
scatters (general and box).

Tensors live on the device given to ``FEMSystem``: the card unless
``device="cpu"`` is passed (no auto-detection, and no CPU fallback), in
float64 by default; ``FEMCY_TPU_X64=0`` selects float32, as in femcy_tpu.
TF32 is off for matmuls and convolutions: f32 products run at full f32
precision (the twin of femcy_tpu forcing "highest" matmul precision).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from femcy_tpu_torch.config import SolverConfig  # noqa: E402
from femcy_tpu_torch.mesh import FEMesh  # noqa: E402
from femcy_tpu_torch.system import FEMSystem, mises_stress  # noqa: E402
from femcy_tpu_torch.io.inp import InpModel, read_inp  # noqa: E402
from femcy_tpu_torch.materials import (  # noqa: E402
    LinearIsotropic,
    LinearIsotropicPlaneStrain,
    LinearIsotropicPlaneStress,
    NeoHookean,
    material_from_inp,
)
from femcy_tpu_torch import meshgen  # noqa: E402

__all__ = [
    "SolverConfig",
    "FEMesh",
    "FEMSystem",
    "mises_stress",
    "InpModel",
    "read_inp",
    "LinearIsotropic",
    "LinearIsotropicPlaneStress",
    "LinearIsotropicPlaneStrain",
    "NeoHookean",
    "material_from_inp",
    "meshgen",
    "__version__",
]
