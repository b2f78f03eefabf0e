"""ELL SpMV on Hopper: the wrapper of csrc/ell_spmv.cu (M2).

Replaces the gather SpMV of ``femcy_tpu/solvers/cg.py`` (``ell_spmv``,
:20-27) in the Jacobi-PCG of the general ELL layout: y = A x with
``A[r, colidx[r, w]] = values[r, w]``, read from (W, n) transposed
operands -- the values made once per solve (``prep_values``), the column
ids and row counts once per pattern (``spmv_plan``).  The row-sharded
solve of ``parallel/sharded.py`` (femcy_tpu/parallel/sharded.py:211-212)
runs the same kernel on a shard's block of rows with the whole gathered x
(``rows_plan``): the kernel reads x only through the column ids, so x may
be longer than y.

The kernel walks six rows per thread in f64 and one in f32, each summed
in slot order with one multiply-add per slot (see the source).

``spmv`` launches the kernel for CUDA tensors and raises if it cannot; for
CPU tensors, and only for them, it runs the plain version
(``solvers.cg.ell_spmv_plain``).  ``spmv.launches`` counts kernel launches.
The public ``solvers.ell_spmv`` and ``solvers.pcg_solve``, which get no
pattern, take ``colidx_spmv``: a plan built from the column ids alone.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.solvers.cg import ell_spmv_plain
from femcy_tpu_torch.topology import ELLPattern

_ENTRY = {torch.float32: "femcy_ell_spmv_f32", torch.float64: "femcy_ell_spmv_f64"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class EllSpmvPlan:
    n: int
    width: int
    #: (width, n) int32 column ids, transposed, on the operand's device
    colidx_t: torch.Tensor
    #: (n,) int32 valid slots per row
    row_counts: torch.Tensor
    #: the length of x: n for a whole operator, more for a block of its
    #: rows (``rows_plan``)
    n_cols: int


def spmv_plan(pattern: ELLPattern, device) -> EllSpmvPlan:
    """The transposed column ids and the row counts of ``pattern``, on
    ``device`` (once per pattern)."""
    return rows_plan(pattern.colidx, pattern.row_counts, pattern.n_dof, device)


def rows_plan(colidx, row_counts, n_cols: int, device) -> EllSpmvPlan:
    """The plan of a block of ELL rows, (n, W) column ids into an x of
    ``n_cols`` values and each row's count of valid slots: the local SpMV
    of a row-sharded operator, y (n,) from the whole gathered x.  The
    kernel is the same; only its x is longer than its y."""
    n, width = colidx.shape
    if n * width >= 2**31 or n_cols >= 2**31:
        raise ValueError("ELL SpMV operands past 2^31 slots are not supported")
    colidx_t = np.ascontiguousarray(np.asarray(colidx).T, dtype=np.int32)
    return EllSpmvPlan(
        n=n,
        width=width,
        colidx_t=torch.as_tensor(colidx_t, device=device),
        row_counts=torch.as_tensor(
            np.asarray(row_counts, dtype=np.int32), device=device),
        n_cols=n_cols,
    )


def colidx_plan(colidx) -> EllSpmvPlan:
    """The plan of (n, W) int column ids of a square operator, built on
    their own device with no host copy.  Every row takes its full width W:
    padding slots hold value 0 at column 0, so they add only zeros, as in
    the plain gather."""
    n, width = colidx.shape
    if n * width >= 2**31:
        raise ValueError("ELL SpMV operands past 2^31 slots are not supported")
    return EllSpmvPlan(
        n=n,
        width=width,
        colidx_t=colidx.t().to(torch.int32).contiguous(),
        row_counts=torch.full((n,), width, dtype=torch.int32,
                              device=colidx.device),
        n_cols=n,
    )


def prep_values(plan: EllSpmvPlan, values):
    """(n, W) row-major values -> (W, n) contiguous transposed operand: one
    pass over the values, amortised over every CG iteration of a solve."""
    if values.shape != (plan.n, plan.width):
        raise ValueError(
            f"values shape {tuple(values.shape)} != ({plan.n}, {plan.width})"
        )
    return values.t().contiguous()


def spmv(plan: EllSpmvPlan, values_t, x):
    """y = A @ x on the transposed ELL operand: y has ``plan.n`` rows, x
    ``plan.n_cols`` values."""
    W, n = plan.width, plan.n
    if values_t.shape != (W, n) or x.shape != (plan.n_cols,):
        raise ValueError(
            f"expected values_t ({W}, {n}) and x ({plan.n_cols},), got "
            f"{tuple(values_t.shape)} and {tuple(x.shape)}"
        )
    if values_t.dtype != x.dtype or x.dtype not in _ENTRY:
        raise TypeError(
            f"values_t and x must share float32 or float64, got "
            f"{values_t.dtype} and {x.dtype}"
        )
    if not (values_t.device == x.device == plan.colidx_t.device):
        raise ValueError(
            f"values_t, x and the plan must share a device, got "
            f"{values_t.device}, {x.device}, {plan.colidx_t.device}"
        )
    if not (values_t.is_contiguous() and x.is_contiguous()):
        raise ValueError("values_t and x must be contiguous")
    if x.device.type == "cpu":
        return ell_spmv_plain(values_t.t(), plan.colidx_t.t().long(), x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    fn = _build.entry(_ENTRY[x.dtype], _ARGTYPES)
    y = x.new_empty(n)
    _build.launch(fn, x.device, "ell_spmv kernel launch", values_t.data_ptr(),
                  plan.colidx_t.data_ptr(), plan.row_counts.data_ptr(),
                  x.data_ptr(), y.data_ptr(), n)
    spmv.launches += 1
    return y


spmv.launches = 0


def _pair(plan: EllSpmvPlan):
    return (
        lambda values: prep_values(plan, values),
        lambda values_t, x: spmv(plan, values_t, x),
    )


def make_spmv(pattern: ELLPattern, device):
    """(prep, apply) pair for solvers.cg.pcg_solve."""
    return _pair(spmv_plan(pattern, device))


def colidx_spmv(colidx):
    """(prep, apply) pair of ``colidx_plan``, on ``colidx``'s device."""
    return _pair(colidx_plan(colidx))
