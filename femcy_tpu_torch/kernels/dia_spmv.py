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

``spmv_window`` runs the same kernel over a window of a longer x: the
slab-sharded solve's halo SpMV (parallel/structured.py; it replaces the
shifted slices of femcy_tpu/parallel/structured.py ``_spmv_local``), whose
x carries two node planes of halo on each side.  Its plain version is
``solvers.dia.dia_spmv_window``; ``spmv_window.launches`` counts its
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.solvers.dia import dia_spmv, dia_spmv_window

_ENTRY = {torch.float32: "femcy_dia_spmv_f32", torch.float64: "femcy_dia_spmv_f64"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_WINDOW_ENTRY = {torch.float32: "femcy_dia_spmv_window_f32",
                 torch.float64: "femcy_dia_spmv_window_f64"}
_WINDOW_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int, ctypes.c_void_p])


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


def _check_operands(plan: SpmvPlan, values_t, x):
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def spmv(plan: SpmvPlan, values_t, x):
    """y = A @ x on the transposed DIA operand."""
    K, n = plan.n_offsets, plan.n
    if values_t.shape != (K, n) or x.shape != (n,):
        raise ValueError(
            f"expected values_t ({K}, {n}) and x ({n},), got "
            f"{tuple(values_t.shape)} and {tuple(x.shape)}"
        )
    _check_operands(plan, values_t, x)
    if x.device.type == "cpu":
        return dia_spmv(values_t.t(), plan.offsets, x)

    fn = _build.entry(_ENTRY[x.dtype], _ARGTYPES)
    y = torch.empty_like(x)
    _build.launch(fn, x.device, "dia_spmv kernel launch", values_t.data_ptr(),
                  x.data_ptr(), y.data_ptr(), plan.offsets_dev.data_ptr(), n, K)
    spmv.launches += 1
    return y


spmv.launches = 0


def spmv_window(plan: SpmvPlan, values_t, x_ext, base: int):
    """y (plan.n,) with y[r] = sum_k values_t[k, r] * x_ext[base + r +
    off_k], on the transposed DIA operand of the window's rows; every
    column must lie in ``x_ext``."""
    K, n = plan.n_offsets, plan.n
    n_x = x_ext.shape[0] if x_ext.dim() == 1 else -1
    if values_t.shape != (K, n) or n_x < 0:
        raise ValueError(
            f"expected values_t ({K}, {n}) and a 1-D x_ext, got "
            f"{tuple(values_t.shape)} and {tuple(x_ext.shape)}")
    if base + min(plan.offsets) < 0 or base + max(plan.offsets) + n > n_x:
        raise ValueError(
            f"window base {base} with offsets [{min(plan.offsets)}, "
            f"{max(plan.offsets)}] over {n} rows leaves x_ext ({n_x},)")
    _check_operands(plan, values_t, x_ext)
    if x_ext.device.type == "cpu":
        return dia_spmv_window(values_t.t(), plan.offsets, x_ext, base)

    fn = _build.entry(_WINDOW_ENTRY[x_ext.dtype], _WINDOW_ARGTYPES)
    y = x_ext.new_empty(n)
    _build.launch(fn, x_ext.device, "dia_spmv window kernel launch",
                  values_t.data_ptr(), x_ext.data_ptr(), y.data_ptr(),
                  plan.offsets_dev.data_ptr(), n, n_x, base, K)
    spmv_window.launches += 1
    return y


spmv_window.launches = 0


def make_spmv(n: int, offsets: Tuple[int, ...], device):
    """(prep, apply) pair for solvers.dia.dia_pcg_solve."""
    plan = spmv_plan(n, offsets, device)
    return (
        lambda values: prep_values(plan, values),
        lambda values_t, x: spmv(plan, values_t, x),
    )
