"""DIA SpMV on Hopper: the wrapper of csrc/dia_spmv.cu.

Replaces ``femcy_tpu/kernels/dia_spmv.py`` (``pallas_spmv``, plan
``pallas_spmv_plan``, ``prep_values``, chooser ``make_spmv``): y = A x for a
DIA operator with K static offsets, ``A[r, r + off_k] = values[r, k]``,
read from the (K, n) transposed operand made once per solve.

Bound on the H100 by the values stream (K * n values per call, 262 MB in
f64 at the 1M-element box); x stays in the 50 MB L2.  The kernel reads
values_t coalesced, one thread per row, and bounds-checks each column
instead of padding x (see the source for the design).  The TPU plan's f32
gate, VMEM budget, block sizing and 128-lane base/remainder split have no
counterpart: the kernel runs in the working dtype at any size.

``spmv`` launches the kernel for CUDA tensors and raises if it cannot; for
CPU tensors, and only for them, it runs the plain version
(``solvers.dia.dia_spmv``).  ``spmv.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.solvers.dia import dia_spmv

_ENTRY = {torch.float32: "femcy_dia_spmv_f32", torch.float64: "femcy_dia_spmv_f64"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    n: int
    offsets: Tuple[int, ...]
    #: the offsets as an int32 tensor on the operand's device
    offsets_dev: torch.Tensor

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)


def spmv_plan(n: int, offsets: Tuple[int, ...], device) -> SpmvPlan:
    offsets = tuple(int(o) for o in offsets)
    return SpmvPlan(
        n=n,
        offsets=offsets,
        offsets_dev=torch.tensor(offsets, dtype=torch.int32, device=device),
    )


def prep_values(plan: SpmvPlan, values):
    """(n, K) row-major values -> (K, n) contiguous transposed operand.

    One pass over the values, amortised over every CG iteration of a solve.
    """
    if values.shape != (plan.n, plan.n_offsets):
        raise ValueError(
            f"values shape {tuple(values.shape)} != ({plan.n}, {plan.n_offsets})"
        )
    return values.t().contiguous()


def spmv(plan: SpmvPlan, values_t, x):
    """y = A @ x on the transposed DIA operand."""
    K, n = plan.n_offsets, plan.n
    if values_t.shape != (K, n) or x.shape != (n,):
        raise ValueError(
            f"expected values_t ({K}, {n}) and x ({n},), got "
            f"{tuple(values_t.shape)} and {tuple(x.shape)}"
        )
    if values_t.dtype != x.dtype or x.dtype not in _ENTRY:
        raise TypeError(
            f"values_t and x must share float32 or float64, got "
            f"{values_t.dtype} and {x.dtype}"
        )
    if not (values_t.device == x.device == plan.offsets_dev.device):
        raise ValueError(
            f"values_t, x and the plan's offsets must share a device, got "
            f"{values_t.device}, {x.device}, {plan.offsets_dev.device}"
        )
    if not (values_t.is_contiguous() and x.is_contiguous()):
        raise ValueError("values_t and x must be contiguous")
    if x.device.type == "cpu":
        return dia_spmv(values_t.t(), plan.offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    fn = _build.entry(_ENTRY[x.dtype], _ARGTYPES)
    y = torch.empty_like(x)
    _build.launch(fn, x.device, "dia_spmv kernel launch", values_t.data_ptr(),
                  x.data_ptr(), y.data_ptr(), plan.offsets_dev.data_ptr(), n, K)
    spmv.launches += 1
    return y


spmv.launches = 0


def make_spmv(n: int, offsets: Tuple[int, ...], device):
    """(prep, apply) pair for solvers.dia.dia_pcg_solve."""
    plan = spmv_plan(n, offsets, device)
    return (
        lambda values: prep_values(plan, values),
        lambda values_t, x: spmv(plan, values_t, x),
    )
