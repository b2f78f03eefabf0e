"""Structured-box internal-force scatter on Hopper: the wrapper of
csrc/structured_force.cu (M5).

Replaces ``femcy_tpu/structured.py`` ``structured_force_scatter``
(:476-495), the box's Newton-path internal force: element forces (E, 4, 3)
of a Kuhn box in cell-major order -> the global force (n_dof,), by the 24
(orientation, local node) corner shifts, with no scatter and no atomics.
It is the force twin of the structured accumulate (P2).

One thread per grid node gathers its 24 corner-shifted cells in the order
of the plain version, orientation outer, local node inner (see the
source).  ``force_scatter`` launches the kernel for CUDA tensors and raises
if it cannot; for CPU tensors, and only for them, it runs the plain
version (``structured.structured_force_scatter``).
``force_scatter.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.structured import StructuredPlan, structured_force_scatter

_ENTRY = {torch.float32: "femcy_structured_force_f32",
          torch.float64: "femcy_structured_force_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])  # the stream, appended by _build.launch


def force_scatter(f_elem, plan: StructuredPlan, mesh: FEMesh):
    """Element forces (E, 4, 3) in box_tets cell-major order -> global
    internal force (n_dof,)."""
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    shape = (6 * nx * ny * nz, 4, 3)
    if tuple(f_elem.shape) != shape:
        raise ValueError(f"f_elem shape {tuple(f_elem.shape)} != {shape}")
    if f_elem.dtype not in _ENTRY:
        raise TypeError(
            f"f_elem must be float32 or float64, got {f_elem.dtype}")
    if not f_elem.is_contiguous():
        raise ValueError("f_elem must be contiguous")
    if f_elem.device.type == "cpu":
        return structured_force_scatter(f_elem, plan, mesh)
    if f_elem.device.type != "cuda":
        raise ValueError(f"unsupported device {f_elem.device}")
    shifts = plan.force_shifts  # built once per plan
    fn = _build.entry(_ENTRY[f_elem.dtype], _ARGTYPES)
    out = torch.empty(3 * (nx + 1) * (ny + 1) * (nz + 1), dtype=f_elem.dtype,
                      device=f_elem.device)
    _build.launch(fn, f_elem.device, "structured_force kernel launch",
                  f_elem.data_ptr(), out.data_ptr(), shifts.ctypes.data,
                  nx, ny, nz)
    force_scatter.launches += 1
    return out


force_scatter.launches = 0
