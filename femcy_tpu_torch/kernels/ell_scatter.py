"""Deterministic stiffness scatter on Hopper: the wrapper of
csrc/ell_scatter.cu (M1).

Replaces the segment-sum scatters of the JAX package's general path --
``femcy_tpu/assembly.py`` ``scatter_stiffness_blocks`` (:167-176, ELL
layout) and ``femcy_tpu/solvers/dia.py`` ``dia_scatter`` (:155-160,
general-DIA layout), called from ``system._scatter`` (:583-596) -- with
one gather-form kernel and no atomics: element stiffnesses (E, edof, edof)
-> values (n_dof, W) on the ELL layout or (n_dof, K) on the DIA layout.

``build_scatter_plan`` inverts the node-block scatter map once per
pattern on the host (a stable argsort of ``ELLPattern.block_targets``:
each node-ELL slot's contributions in element order) and uploads it.
``scatter`` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors, and only for them, it runs the plain version
(``scatter_plain``: the indexed add of the expanded targets).
``scatter.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from femcy_tpu_torch.assembly import expand_block_targets, scatter_stiffness
from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.solvers.dia import DIAPattern, ell_to_dia_slots
from femcy_tpu_torch.topology import ELLPattern

_ENTRY = {torch.float32: "femcy_ell_scatter_f32",
          torch.float64: "femcy_ell_scatter_f64"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    n_dof: int
    #: dof-level ELL width W = node_width * dm
    width: int
    node_width: int
    dm: int
    npe: int
    n_elements: int
    #: (n_dof, W) on the ELL layout, (n_dof, K) on the DIA layout
    out_shape: Tuple[int, int]
    #: (n_nodes * node_width + 1,) int64: node slot -> start in ``ids``
    ptr: torch.Tensor
    #: (E * npe * npe,) int32 contributions (e * npe + a) * npe + b, grouped
    #: by node slot, ascending within each
    ids: torch.Tensor
    #: (n_dof * W,) int64 flat DIA slot of each flat ELL slot, -1 on
    #: padding; None on the ELL layout
    out_map: Optional[torch.Tensor] = None


def block_inverse(block_targets: np.ndarray, n_node_slots: int):
    """(ptr, ids): the contributions of each node slot, in ascending order
    (the stable argsort of the block map), in CSR form."""
    ids = np.argsort(block_targets, kind="stable").astype(np.int32)
    counts = np.bincount(block_targets, minlength=n_node_slots)
    ptr = np.zeros(n_node_slots + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, ids


def build_scatter_plan(pattern: ELLPattern, device,
                       dia: Optional[DIAPattern] = None) -> ScatterPlan:
    """The kernel's operands for ``pattern`` on ``device``; with ``dia``
    the output is that DIA layout's values (every (col - row) offset of the
    pattern must be one of ``dia.offsets``)."""
    if pattern.block_targets is None or pattern.node_width == 0:
        raise ValueError("the scatter needs a pattern with a node-block map")
    bt = np.asarray(pattern.block_targets)
    E = pattern.element_dofs.shape[0]
    npe = int(round((bt.shape[0] // E) ** 0.5))
    dm = pattern.width // pattern.node_width
    if npe * npe * E != bt.shape[0] or dm * pattern.node_width != pattern.width:
        raise ValueError("block map does not match the pattern's shapes")
    if bt.shape[0] >= 2**31:
        raise ValueError("more than 2^31 node-pair contributions")
    n_node_slots = (pattern.n_dof // dm) * pattern.node_width
    ptr, ids = block_inverse(bt, n_node_slots)
    out_map = None
    out_shape = (pattern.n_dof, pattern.width)
    if dia is not None:
        out_map = torch.as_tensor(ell_to_dia_slots(pattern, dia.offsets),
                                  device=device)
        out_shape = (pattern.n_dof, dia.n_offsets)
    return ScatterPlan(
        n_dof=pattern.n_dof,
        width=pattern.width,
        node_width=pattern.node_width,
        dm=dm,
        npe=npe,
        n_elements=E,
        out_shape=out_shape,
        ptr=torch.as_tensor(ptr, device=device),
        ids=torch.as_tensor(ids, device=device),
        out_map=out_map,
    )


def block_targets(plan: ScatterPlan):
    """The node-block map (E * npe * npe,) int64, recovered from the plan's
    inverse: contribution ids[j] goes to the node slot whose range in
    ``ptr`` holds j."""
    counts = plan.ptr.diff()
    slots = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts,
        output_size=plan.ids.shape[0])
    bt = torch.empty_like(slots)
    bt[plan.ids.long()] = slots
    return bt


def scatter_plain(Ke, plan: ScatterPlan):
    """The plain version: an indexed add of Ke over the expanded dof-level
    targets (remapped to the DIA slots on the DIA layout), in contribution
    order -- femcy_tpu's segment-sum."""
    targets = expand_block_targets(block_targets(plan), plan.node_width,
                                   plan.dm, plan.width, plan.npe)
    if plan.out_map is not None:
        targets = plan.out_map[targets]
    return scatter_stiffness(Ke, targets, *plan.out_shape)


def scatter(Ke, plan: ScatterPlan):
    """Element stiffnesses (E, edof, edof) -> values of ``plan.out_shape``."""
    edof = plan.npe * plan.dm
    if Ke.shape != (plan.n_elements, edof, edof):
        raise ValueError(
            f"Ke shape {tuple(Ke.shape)} != ({plan.n_elements}, {edof}, {edof})"
        )
    if Ke.dtype not in _ENTRY:
        raise TypeError(f"Ke must be float32 or float64, got {Ke.dtype}")
    if Ke.device != plan.ptr.device:
        raise ValueError(
            f"Ke and the plan must share a device, got {Ke.device} and "
            f"{plan.ptr.device}"
        )
    if not Ke.is_contiguous():
        raise ValueError("Ke must be contiguous")
    if Ke.device.type == "cpu":
        return scatter_plain(Ke, plan)
    if Ke.device.type != "cuda":
        raise ValueError(f"unsupported device {Ke.device}")

    fn = _build.entry(_ENTRY[Ke.dtype], _ARGTYPES)
    if plan.out_map is None:
        out = torch.empty(plan.out_shape, dtype=Ke.dtype, device=Ke.device)
        out_map = None
    else:
        # DIA slots no ELL slot maps to stay 0
        out = torch.zeros(plan.out_shape, dtype=Ke.dtype, device=Ke.device)
        out_map = plan.out_map.data_ptr()
    n_slots = plan.ptr.shape[0] - 1
    _build.launch(fn, Ke.device, "ell_scatter kernel launch", Ke.data_ptr(),
                  plan.ptr.data_ptr(), plan.ids.data_ptr(), out_map,
                  out.data_ptr(), n_slots, plan.node_width, plan.width,
                  plan.npe, plan.dm)
    scatter.launches += 1
    return out


scatter.launches = 0
