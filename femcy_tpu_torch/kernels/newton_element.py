"""The box's C3D4 Newton element evaluation on Hopper: the wrapper of
csrc/c3d4_newton_element.cu (M9).

Replaces no Pallas kernel: it takes the place of femcy_tpu's XLA einsums
of the Newton evaluation on the structured box (``system.py``
``_internal_force_parts`` and ``_newton_eval``: the kinematics,
``gp_stress(large=True)``, ``element_internal_force``,
``element_stiffness`` + ``geometric_stiffness``) and of the Ke -> planes
transpose of ``structured_dia_scatter``.  One thread an element computes
F, the current gradients and volume, sigma = F (C : E) F^T / det F, the
element force and every 3x3 node block of Ke + Kg in registers, and writes
the tangent straight into P2's (6, 144, nx*ny*nz) planes, the element
force (E, 4, 3) in the order M5 reads, and the volume (E, 1).  No 12 x 12
element matrix, F, sigma or B reaches device memory.  Memory bound:
~1,433 MB at NX=56 in f64, 0.428 ms at 3.35 TB/s (see the source).

``route_applies`` says whether an evaluation can take this route:
a box_tets plan, one-Gauss-point 4-node 3D elements, a material whose
large-deformation stress is C : E pushed forward (``PK2_MATERIALS``), the
secant tangent with the geometric stiffness.  ``evaluate`` launches the
kernel for CUDA tensors and raises if it cannot; for CPU tensors, and only
for them, it runs the plain version (``structured.newton_element_plain``,
the einsum chain).  ``evaluate.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.materials import LinearIsotropic
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.structured import StructuredPlan, newton_element_plain

_ENTRY = {torch.float32: ("femcy_newton_element_f32", ctypes.c_float),
          torch.float64: ("femcy_newton_element_f64", ctypes.c_double)}
_NP = {torch.float32: np.float32, torch.float64: np.float64}
#: materials whose ``cauchy_large`` is F (C : E) F^T / det F, E the Green
#: strain, with ``C`` their Voigt tangent: the law the kernel computes
#: (an exact type match, so that a subclass with another law is refused)
PK2_MATERIALS = (LinearIsotropic,)


def _argtypes(scalar):
    return ([ctypes.c_void_p] * 8 + [scalar, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
            + [ctypes.c_void_p])  # the stream, appended by _build.launch


def route_applies(mesh: FEMesh, material, config, plan) -> bool:
    """Whether ``evaluate`` computes this system's Newton element work: a
    structured box plan, C3D4 shapes (one Gauss point, 4 nodes, 3D), a
    material of ``PK2_MATERIALS``, the secant tangent with the geometric
    stiffness."""
    dN = np.asarray(mesh.element.dshape_at_gp)
    return (plan is not None and dN.shape == (1, 4, 3)
            and type(material) in PK2_MATERIALS
            and config.tangent == "secant" and config.geometric_stiffness)


def evaluate(nodes, u, dsdX0, material, plan: StructuredPlan, mesh: FEMesh):
    """Node coordinates (N, 3), the pinned displacement (3 N,) and the
    initial gradients dsdX0 (E, 1, 4, 3, at any strides: the setup's einsum
    leaves them strided) of a box_tets C3D4 mesh -> (planes (6, 144,
    nx*ny*nz), f_elem (E, 4, 3), vol (E, 1)), all contiguous."""
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    E = 6 * nx * ny * nz
    n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
    for name, t, shape in (("nodes", nodes, (n_nodes, 3)),
                           ("u", u, (3 * n_nodes,)),
                           ("dsdX0", dsdX0, (E, 1, 4, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != nodes.dtype or t.device != nodes.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; nodes are "
                             f"{nodes.dtype} on {nodes.device}")
        if name != "dsdX0" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodes.dtype not in _ENTRY:
        raise TypeError(
            f"nodes must be float32 or float64, got {nodes.dtype}")
    if type(material) not in PK2_MATERIALS:
        raise ValueError(f"{type(material).__name__}: the kernel computes "
                         "the stress of " + ", ".join(
                             m.__name__ for m in PK2_MATERIALS))
    if nodes.device.type == "cpu":
        return newton_element_plain(nodes, u, dsdX0, material, mesh)
    if nodes.device.type != "cuda":
        raise ValueError(f"unsupported device {nodes.device}")
    out = _launch(nodes, u, dsdX0, material, plan, mesh)
    evaluate.launches += 1
    return out


def _launch(nodes, u, dsdX0, material, plan, mesh):
    dtype = nodes.dtype
    entry, scalar = _ENTRY[dtype]
    fn = _build.entry(entry, _argtypes(scalar))
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    nc = nx * ny * nz
    planes = nodes.new_empty((6, 144, nc))
    f_elem = nodes.new_empty((6 * nc, 4, 3))
    vol = nodes.new_empty((6 * nc, 1))
    # host copies passed by value, kept alive through the call
    C = np.ascontiguousarray(material.C, dtype=_NP[dtype])
    dN = np.ascontiguousarray(mesh.element.dshape_at_gp, dtype=_NP[dtype])
    w = float(np.asarray(mesh.element.gauss_weights)[0])
    shifts = plan.force_shifts  # (24, 3) int32, built once per plan
    _build.launch(fn, nodes.device, "newton_element kernel launch",
                  nodes.data_ptr(), u.data_ptr(), dsdX0.data_ptr(),
                  planes.data_ptr(), f_elem.data_ptr(), vol.data_ptr(),
                  C.ctypes.data, dN.ctypes.data, w, shifts.ctypes.data,
                  nx, ny, nz, dsdX0.stride(0), dsdX0.stride(2),
                  dsdX0.stride(3))
    return planes, f_elem, vol


def kernel_attributes(dtype) -> dict:
    """The compiled kernel's registers and local (spilled) bytes a thread
    in ``dtype``."""
    fn = _build.entry("femcy_newton_element_attributes",
                      [ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 2)()
    code = fn(int(dtype == torch.float64), ctypes.addressof(out))
    if code != 0:
        raise RuntimeError(f"newton_element attributes: CUDA error {code}")
    return {"registers": out[0], "local_bytes": out[1]}


evaluate.launches = 0
