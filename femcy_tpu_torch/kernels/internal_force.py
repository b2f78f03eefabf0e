"""Deterministic internal-force scatter on Hopper: the wrapper of
csrc/internal_force.cu (M4).

Replaces the segment-sum of the JAX package's general Newton path --
``femcy_tpu/assembly.py`` ``internal_force`` (:198-207), called from
``system._internal_force_parts`` (:665-676) -- with one gather-form kernel
and no atomics: element forces (E, npe, dm) -> the global internal force
(n_dof,).

It reads the inverse of the element-node map that the stiffness scatter
already holds (``ell_scatter.ScatterPlan``: ``node_ptr`` and ``pairs``), so
a general ``FEMSystem`` builds no second map, and the plan's
``node_order`` (nodes sorted by their first pair).  A group of eight
lanes sums node ``node_order[t]``, loading eight pairs at once and adding
them in ascending order (see the source).
``scatter_force`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors, and only for them, it runs the plain version
(``scatter_force_plain``: an indexed add of f_e over its dofs, in element
order, femcy_tpu's segment-sum).  ``scatter_force.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.kernels.ell_scatter import ScatterPlan, pair_nodes

_ENTRY = {torch.float32: "femcy_internal_force_f32",
          torch.float64: "femcy_internal_force_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p])  # the stream, appended by _build.launch


def force_targets(plan: ScatterPlan):
    """The dof of every element-force value, in f_e's order: node * dm + i
    (femcy_tpu's ``elements * dm + i``), (E * npe * dm,) int64."""
    dm = plan.dm
    arange = torch.arange(dm, device=plan.node_ptr.device)
    return (pair_nodes(plan)[:, None] * dm + arange).reshape(-1)


def m4_read_sectors(plan: ScatterPlan, itemsize: int) -> dict:
    """The kernel's reads at the DRAM's 32-byte sector granularity, in
    bytes: the distinct sectors of f_e and of the pair list that its loads
    touch (each fetched once: the floor), and the sectors that each
    record of f_e and each node's run of the pair list span on their own
    (no sector shared: the cost with no reuse)."""
    ptr = plan.node_ptr.cpu().numpy()
    pairs = plan.pairs.cpu().numpy()
    p = np.where(pairs < 0, ~pairs, pairs).astype(np.int64)
    rec = plan.dm * itemsize
    first, last = p * rec // 32, (p * rec + rec - 1) // 32
    touched = np.zeros(int(last.max()) + 1, dtype=bool)
    touched[first] = touched[last] = True
    has = np.diff(ptr) > 0
    lo, hi = ptr[:-1][has] * 4 // 32, (ptr[1:][has] * 4 - 1) // 32
    cover = np.zeros(int(hi.max()) + 2, dtype=np.int64)  # runs lo..hi
    np.add.at(cover, lo, 1)
    np.add.at(cover, hi + 1, -1)
    listed = np.cumsum(cover)[:-1] > 0
    return {"f_e distinct": int(touched.sum()) * 32,
            "f_e per thread": int((last - first + 1).sum()) * 32,
            "pairs distinct": int(listed.sum()) * 32,
            "pairs per thread": int((hi - lo + 1).sum()) * 32}


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
                  plan.pairs.data_ptr(), plan.node_order.data_ptr(),
                  out.data_ptr(),
                  plan.node_ptr.shape[0] - 1, plan.dm)
    scatter_force.launches += 1
    return out


scatter_force.launches = 0
