"""Block-tridiagonal scatter on Hopper: the wrapper of csrc/btd_scatter.cu
(M8).

Replaces the segment-sums of the JAX package's banded path --
``femcy_tpu/parallel/banded.py`` ``_btd_assemble`` (:679), the Newton
tangent (:641) and the internal force (:611) -- with one gather-form
kernel and no atomics: a shard's element entries (Ke flattened in element
order, or its element forces) -> its flat (nbl + 1) * 3 * B * B
block-tridiagonal buffer, or its (nbl + 1) * B force rows, at the targets
that ``parallel.banded.build_banded_operands`` computes on the host.

``build_plan`` inverts the targets once per shard: a stable sort of the
targets gives each touched slot its run of entries, in entry order (int32
entry ids where they fit).  The kernel zeroes the output and sums each run
from 0 in that order, so it is bit for bit the plain version
(``scatter_plain``: an indexed add of the entries at their targets, in
entry order, femcy_tpu's segment-sum), which the wrapper runs for CPU
tensors, and only for them; for CUDA tensors ``scatter`` launches the
kernel or raises.  ``scatter.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from femcy_tpu_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p])  # the stream, appended by _build.launch
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_INDEX = {torch.int32: "i32", torch.int64: "i64"}


@dataclasses.dataclass(frozen=True)
class BtdScatterPlan:
    #: values the scatter takes (the shard's entries)
    n_entries: int
    #: slots of the output
    n_out: int
    #: (n_entries,) int32 (int64 past 2^31 entries): the entry ids sorted
    #: by target, ascending within a target
    order: torch.Tensor
    #: (n_runs + 1,) int64: run u is order[run_start[u]:run_start[u + 1]]
    run_start: torch.Tensor
    #: (n_runs,) int64: the output slot of run u, ascending
    run_target: torch.Tensor


def build_plan(targets, n_out: int, device) -> BtdScatterPlan:
    """The kernel's operands for entry targets (n_entries,) into an output
    of ``n_out`` slots, on ``device``: one stable sort, made there."""
    t = torch.as_tensor(targets, device=device).reshape(-1).long()
    n = t.shape[0]
    if n and (int(t.min()) < 0 or int(t.max()) >= n_out):
        raise ValueError(f"targets outside the output's {n_out} slots")
    srt, order = torch.sort(t, stable=True)
    run_target, counts = torch.unique_consecutive(srt, return_counts=True)
    run_start = torch.zeros(run_target.shape[0] + 1, dtype=torch.long,
                            device=t.device)
    torch.cumsum(counts, 0, out=run_start[1:])
    if n < 2**31:
        order = order.int()
    return BtdScatterPlan(n_entries=n, n_out=n_out, order=order,
                          run_start=run_start, run_target=run_target)


def targets_of(plan: BtdScatterPlan) -> torch.Tensor:
    """The entry targets (n_entries,) int64, recovered from the plan."""
    counts = plan.run_start.diff()
    t = torch.empty(plan.n_entries, dtype=torch.long,
                    device=plan.order.device)
    t[plan.order.long()] = torch.repeat_interleave(
        plan.run_target, counts, output_size=plan.n_entries)
    return t


def scatter_plain(values, plan: BtdScatterPlan):
    """The plain version: an indexed add of the entries at their targets,
    in entry order, into zeros -- femcy_tpu's segment-sum."""
    out = values.new_zeros(plan.n_out)
    out.index_add_(0, targets_of(plan), values.reshape(-1))
    return out


def scatter(values, plan: BtdScatterPlan):
    """Entries (any shape of n_entries values, contiguous) -> the flat
    (n_out,) output."""
    if values.numel() != plan.n_entries:
        raise ValueError(
            f"{values.numel()} values for a plan of {plan.n_entries} entries")
    if values.dtype not in _DTYPES:
        raise TypeError(
            f"values must be float32 or float64, got {values.dtype}")
    if values.device != plan.order.device:
        raise ValueError(
            f"values and the plan must share a device, got {values.device} "
            f"and {plan.order.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if values.device.type == "cpu":
        return scatter_plain(values, plan)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")

    name = (f"femcy_btd_scatter_{_DTYPES[values.dtype]}_"
            f"{_INDEX[plan.order.dtype]}")
    fn = _build.entry(name, _ARGTYPES)
    out = torch.empty(plan.n_out, dtype=values.dtype, device=values.device)
    _build.launch(fn, values.device, "btd_scatter kernel launch",
                  values.data_ptr(), plan.order.data_ptr(),
                  plan.run_start.data_ptr(), plan.run_target.data_ptr(),
                  out.data_ptr(), plan.run_target.shape[0], plan.n_out)
    scatter.launches += 1
    return out


scatter.launches = 0
