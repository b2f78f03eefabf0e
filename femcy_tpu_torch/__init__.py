"""femcy_tpu_torch: the PyTorch / CUDA port of femcy_tpu for NVIDIA Hopper.

A second package beside ``femcy_tpu`` (the JAX reference, which it never
imports).  It grows slice by slice (ROADMAP.md); what exists now is the
static analysis of any mesh, linear or geometric-nonlinear: ``read_inp``
or ``meshgen`` -> ``FEMesh`` -> ``material_from_inp`` -> ``FEMSystem`` ->
assembly -> Dirichlet elimination -> direct solve or PCG (inside the
Newton loop on the nonlinear path) -> strain, stress, Mises, energy and
extrapolation; models of several element types or materials
(``read_inp_multi`` -> ``system_from_model`` -> ``MultiBlockSystem``,
each block scattered over one union pattern) and B31 beam lattices
(``read_beam_inp`` -> ``solve_beam``, a dense Cholesky solve), and
frame-stiffened solids that mix B31 beams and continuum blocks over 6-dof
nodes (``read_mixed_inp`` -> ``solve_mixed`` -> ``MixedSystem``), and the
Riks arc-length continuation (``solvers.riks.riks_solve``).  A
structured box (``meshgen.box_tets``) assembles from its node coordinates into the analytic DIA layout and
solves with a Jacobi, block-Jacobi or geometric-multigrid PCG; any other
mesh goes through the ELL pattern (native C++ code, native/) and, where its
offsets are bounded, the general DIA layout, with a Jacobi (or, on DIA,
block-Jacobi) PCG, or on ELL the smoothed-aggregation algebraic-multigrid
PCG.  The three TPU kernels of the JAX package are
rewritten by hand in CUDA for sm_90a (kernels/, csrc/): the DIA SpMV
(every DIA PCG iteration and multigrid level), the structured accumulate
(the two-stage box assembly) and the fused coordinates-to-DIA assembly
(the isotropic box default); so are the general path's deterministic
stiffness scatter and ELL SpMV, the algebraic multigrid's block-ELL
SpMV, the Newton path's internal-force scatters (general and box), and
the mixed beam + continuum scatter.

Tensors live on the device given to ``FEMSystem`` (and
``MultiBlockSystem``, ``solve_beam``, ``MixedSystem``): the card unless
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
from femcy_tpu_torch.io.inp import (  # noqa: E402
    InpBlockModel,
    InpModel,
    read_inp,
    read_inp_multi,
)
from femcy_tpu_torch.materials import (  # noqa: E402
    LinearIsotropic,
    LinearIsotropicPlaneStrain,
    LinearIsotropicPlaneStress,
    NeoHookean,
    material_from_inp,
)
from femcy_tpu_torch.multiblock import (  # noqa: E402
    ElementBlock,
    MultiBlockSystem,
    system_from_model,
)
from femcy_tpu_torch.beam import (  # noqa: E402
    BeamModel,
    BeamSection,
    read_beam_inp,
    solve_beam,
)
from femcy_tpu_torch.mixed import (  # noqa: E402
    BeamBlock,
    MixedModel,
    MixedResult,
    MixedSystem,
    read_mixed_inp,
    solve_mixed,
)
from femcy_tpu_torch import meshgen  # noqa: E402

# femcy_tpu's public names, the same set; mises_stress, BeamBlock and
# MixedResult are importable from here too
__all__ = [
    "SolverConfig",
    "FEMesh",
    "FEMSystem",
    "InpModel",
    "read_inp",
    "InpBlockModel",
    "read_inp_multi",
    "LinearIsotropic",
    "LinearIsotropicPlaneStress",
    "LinearIsotropicPlaneStrain",
    "NeoHookean",
    "material_from_inp",
    "ElementBlock",
    "MultiBlockSystem",
    "system_from_model",
    "BeamModel",
    "BeamSection",
    "read_beam_inp",
    "solve_beam",
    "MixedModel",
    "MixedSystem",
    "read_mixed_inp",
    "solve_mixed",
    "meshgen",
    "__version__",
]
