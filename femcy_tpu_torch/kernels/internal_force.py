"""Deterministic internal-force scatter on Hopper: the wrapper of
csrc/internal_force.cu (M4).

Replaces the segment-sum of the JAX package's general Newton path --
``femcy_tpu/assembly.py`` ``internal_force`` (:198-207), called from
``system._internal_force_parts`` (:665-676) -- with one gather-form kernel
and no atomics: element forces (E, npe, dm) -> the global internal force
(n_dof,).

It reads the inverse of the element-node map that the stiffness scatter
already holds (``ell_scatter.ScatterPlan``: ``node_ptr`` and ``pairs``), so
a general ``FEMSystem`` builds no second map.  One thread per node walks
its pairs in ascending order (see the source).
``scatter_force`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors, and only for them, it runs the plain version
(``scatter_force_plain``: an indexed add of f_e over its dofs, in element
order, femcy_tpu's segment-sum).  ``scatter_force.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.kernels.ell_scatter import ScatterPlan, pair_nodes

_ENTRY = {torch.float32: "femcy_internal_force_f32",
          torch.float64: "femcy_internal_force_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p])  # the stream, appended by _build.launch


def force_targets(plan: ScatterPlan):
    """The dof of every element-force value, in f_e's order: node * dm + i
    (femcy_tpu's ``elements * dm + i``), (E * npe * dm,) int64."""
    dm = plan.dm
    arange = torch.arange(dm, device=plan.node_ptr.device)
    return (pair_nodes(plan)[:, None] * dm + arange).reshape(-1)


def scatter_force_plain(f_elem, plan: ScatterPlan):
    """The plain version: an indexed add of f_e over its dofs, in element
    order.  Each dof receives its values in ascending pair order from +0,
    the order the kernel sums in."""
    f = f_elem.new_zeros(plan.n_dof)
    f.index_add_(0, force_targets(plan), f_elem.reshape(-1))
    return f


def scatter_force(f_elem, plan: ScatterPlan):
    """Element forces (E, npe, dm) -> global internal force (n_dof,)."""
    shape = (plan.n_elements, plan.npe, plan.dm)
    if tuple(f_elem.shape) != shape:
        raise ValueError(f"f_elem shape {tuple(f_elem.shape)} != {shape}")
    if f_elem.dtype not in _ENTRY:
        raise TypeError(
            f"f_elem must be float32 or float64, got {f_elem.dtype}")
    if f_elem.device != plan.node_ptr.device:
        raise ValueError(
            f"f_elem and the plan must share a device, got {f_elem.device} "
            f"and {plan.node_ptr.device}")
    if not f_elem.is_contiguous():
        raise ValueError("f_elem must be contiguous")
    if f_elem.device.type == "cpu":
        return scatter_force_plain(f_elem, plan)
    if f_elem.device.type != "cuda":
        raise ValueError(f"unsupported device {f_elem.device}")
    if plan.dm not in (2, 3):
        raise ValueError(f"dm={plan.dm}: the kernel takes 2 or 3")

    fn = _build.entry(_ENTRY[f_elem.dtype], _ARGTYPES)
    out = torch.empty(plan.n_dof, dtype=f_elem.dtype, device=f_elem.device)
    _build.launch(fn, f_elem.device, "internal_force kernel launch",
                  f_elem.data_ptr(), plan.node_ptr.data_ptr(),
                  plan.pairs.data_ptr(), out.data_ptr(),
                  plan.node_ptr.shape[0] - 1, plan.dm)
    scatter_force.launches += 1
    return out


scatter_force.launches = 0
