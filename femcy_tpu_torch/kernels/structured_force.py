"""Structured-box internal-force scatter on Hopper: the wrapper of
csrc/structured_force.cu (M5).

Replaces ``femcy_tpu/structured.py`` ``structured_force_scatter``
(:476-495), the box's Newton-path internal force: element forces (E, 4, 3)
of a Kuhn box in cell-major order -> the global force (n_dof,), by the 24
(orientation, local node) corner shifts, with no scatter and no atomics.
It is the force twin of the structured accumulate (P2).

A block stages the cell slabs of a (y, z) tile of grid nodes in shared
memory and marches along x; one thread per (grid node, component) adds
its 24 corner-shifted cells in the order of the plain version,
orientation outer, local node inner (see the source).  The tile comes
from the plan (``StructuredPlan.force_tile``).  ``force_scatter``
launches the kernel for CUDA tensors and raises if it cannot; for CPU
tensors, and only for them, it runs the plain version
(``structured.structured_force_scatter``).
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
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])  # the stream, appended by _build.launch
#: (ty, tz, blocks an SM) by dtype name: a block's (y, z) tile of grid
#: nodes, and how many such blocks an SM holds.  Three slabs of (ty + 1)
#: (tz + 1) cells (592 bytes a cell in f64, 304 in f32, padded) sit in
#: shared memory: 112 KB in f64, two blocks an SM; 74 KB in f32, three
FORCE_TILES = {"float32": (8, 8, 3), "float64": (6, 8, 2)}
#: the SMs an H100 SXM holds: the count the tile is sized for where no
#: card is visible
H100_SMS = 132


def card_sms() -> int:
    """The SMs of the current CUDA card, or ``H100_SMS`` without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return H100_SMS


def force_tile(nx: int, ny: int, nz: int, dtype_name: str, sms: int):
    """M5's (ty, tz, lx) for an nx x ny x nz box: the tile of
    ``FORCE_TILES``, marching over lx node planes, lx cut so that the
    blocks fill ``sms`` SMs in one wave where the box allows."""
    ty, tz, per_sm = FORCE_TILES[dtype_name]
    tiles = -(-(ny + 1) // ty) * -(-(nz + 1) // tz)
    chunks = max(1, sms * per_sm // tiles)
    return ty, tz, -(-(nx + 1) // chunks)


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
    out = launch_at(f_elem, plan,
                    plan.force_tile[str(f_elem.dtype).split(".")[1]])
    force_scatter.launches += 1
    return out


def launch_at(f_elem, plan: StructuredPlan, tile):
    """The kernel on f_elem, a contiguous CUDA tensor of
    ``force_scatter``'s shape, at ``tile`` = (ty, tz, lx), uncounted:
    ``force_scatter``'s launch at the plan's tile, and the checks' at
    others."""
    if f_elem.device.type != "cuda":
        raise ValueError(f"unsupported device {f_elem.device}")
    if f_elem.data_ptr() % 16:
        raise ValueError("f_elem must start on a 16-byte boundary")
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    shifts = plan.force_shifts  # built once per plan
    fn = _build.entry(_ENTRY[f_elem.dtype], _ARGTYPES)
    out = torch.empty(3 * (nx + 1) * (ny + 1) * (nz + 1), dtype=f_elem.dtype,
                      device=f_elem.device)
    _build.launch(fn, f_elem.device, "structured_force kernel launch",
                  f_elem.data_ptr(), out.data_ptr(), shifts.ctypes.data,
                  nx, ny, nz, *tile)
    return out


force_scatter.launches = 0
