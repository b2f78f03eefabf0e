"""Block-ELL SpMV on Hopper: the wrapper of csrc/bell_spmv.cu (M3).

Replaces ``femcy_tpu/solvers/bell.py``'s ``bell_spmv`` (:147-156), the
operator of the algebraic multigrid: y = A x on rectangular block-ELL,
``y[n*br+i] = sum_k sum_j A(n, k)[i, j] * x[ncol[n, k]*bc + j]``.

The kernel reads a :class:`BellOperand`: the block values transposed to
(K, bc, N*br), the block-column ids to (K, N), and the count of blocks per
row past which every block is zero.  ``operand`` makes one from
(N, K, br, bc) block values (the AMG's coarse levels, once at setup);
``fine_plan`` and ``from_ell`` make the fine level's from the eliminated
dof-ELL values, whose transpose is already that layout, once per solve.

``spmv`` launches the kernel for CUDA tensors and raises if it cannot; for
CPU tensors, and only for them, it runs the plain version
(``solvers.bell.bell_spmv`` on the operand's blocks, those past the counts
zeroed).  ``spmv.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.solvers.bell import BellPlan, bell_spmv

_VALUE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
                torch.float64: "f64"}
_X_NAMES = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
#: block widths the kernel is instantiated for (2-D and 3-D dofs, 3 and 6
#: rigid-body modes)
BLOCK_COLS = (2, 3, 6)


@dataclasses.dataclass(frozen=True)
class BellOperand:
    """A block-ELL operator in the kernel's layout."""

    #: (K, bc, N * br): entry [k, j, n*br + i] is block (n, k)'s (i, j)
    values_t: torch.Tensor
    #: (K, N) int32 block-column ids
    ncol_t: torch.Tensor
    #: (N,) int32: the blocks of a row past its count are zero blocks
    counts: torch.Tensor
    br: int
    #: block columns: x has n_cols * bc entries
    n_cols: int

    @property
    def n_blocks(self) -> int:
        return self.counts.shape[0]

    @property
    def bc(self) -> int:
        return self.values_t.shape[1]

    @property
    def bvalues(self) -> torch.Tensor:
        """(N, K, br, bc) view of the blocks."""
        K, bc, _ = self.values_t.shape
        return self.values_t.view(K, bc, self.n_blocks, self.br).permute(2, 0, 3, 1)

    @property
    def ncol(self) -> torch.Tensor:
        """(N, K) view of the block-column ids."""
        return self.ncol_t.t()


def operand(bvalues: torch.Tensor, ncol: torch.Tensor, n_cols: int) -> BellOperand:
    """The operand of (N, K, br, bc) block values and (N, K) ids, on their
    device; each row's count ends after its last block that is nonzero or
    has a nonzero id."""
    N, K, br, bc = bvalues.shape
    if tuple(ncol.shape) != (N, K):
        raise ValueError(f"ncol shape {tuple(ncol.shape)} != ({N}, {K})")
    used = (bvalues != 0).flatten(2).any(2) | (ncol != 0)
    last = torch.where(used, torch.arange(1, K + 1, device=used.device), 0)
    return BellOperand(
        values_t=bvalues.permute(1, 3, 0, 2).reshape(K, bc, N * br).contiguous(),
        ncol_t=ncol.t().to(torch.int32).contiguous(),
        counts=last.max(1).values.to(torch.int32),
        br=br, n_cols=int(n_cols),
    )


@dataclasses.dataclass(frozen=True)
class FinePlan:
    """The fine level's ids and counts on the device (once per pattern)."""

    dm: int
    width: int
    ncol_t: torch.Tensor
    counts: torch.Tensor


def fine_plan(plan: BellPlan, device) -> FinePlan:
    """The block plan's (K, N) ids and valid-block counts on ``device``."""
    return FinePlan(
        dm=plan.dm, width=plan.width,
        ncol_t=torch.as_tensor(np.ascontiguousarray(plan.ncol.T), device=device),
        counts=torch.as_tensor(plan.valid.sum(1).astype(np.int32), device=device),
    )


def from_ell(fine: FinePlan, values: torch.Tensor) -> BellOperand:
    """The fine operand of eliminated dof-ELL values (n_dof, W): their
    transpose, one pass over the values, amortised over a solve.  The
    counts apply the plan's valid mask, as ``bell_from_ell`` does."""
    dm, K = fine.dm, fine.width
    n = fine.counts.shape[0]
    if tuple(values.shape) != (n * dm, K * dm):
        raise ValueError(
            f"values shape {tuple(values.shape)} != ({n * dm}, {K * dm})")
    return BellOperand(
        values_t=values.t().contiguous().view(K, dm, n * dm),
        ncol_t=fine.ncol_t, counts=fine.counts, br=dm, n_cols=n,
    )


def spmv(op: BellOperand, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the operand, (N * br,) in x's dtype."""
    K, bc, m = op.values_t.shape
    N = op.n_blocks
    if x.dim() != 1 or x.shape[0] != op.n_cols * bc or m != N * op.br:
        raise ValueError(
            f"operand ({N}, {K}, {op.br}, {bc}) over {op.n_cols} block "
            f"columns and x {tuple(x.shape)} disagree")
    if tuple(op.ncol_t.shape) != (K, N):
        raise ValueError(f"ncol_t shape {tuple(op.ncol_t.shape)} != ({K}, {N})")
    v_dt = op.values_t.dtype
    if (x.dtype not in _X_NAMES or v_dt not in _VALUE_NAMES
            or (v_dt == torch.float64 and x.dtype == torch.float32)):
        raise TypeError(
            f"values {v_dt} with x {x.dtype}: values must be bfloat16, "
            "float32 or float64 and x float32 or float64, no wider than x")
    if op.ncol_t.dtype != torch.int32 or op.counts.dtype != torch.int32:
        raise TypeError("ncol_t and counts must be int32")
    if not (op.values_t.device == x.device == op.ncol_t.device
            == op.counts.device):
        raise ValueError(
            f"operand and x must share a device, got {op.values_t.device}, "
            f"{op.ncol_t.device}, {op.counts.device} and {x.device}")
    if not all(t.is_contiguous()
               for t in (op.values_t, op.ncol_t, op.counts, x)):
        raise ValueError("operand tensors and x must be contiguous")
    if x.device.type == "cpu":
        live = (torch.arange(K)[None] < op.counts[:, None]).to(v_dt)
        return bell_spmv(op.bvalues * live[:, :, None, None], op.ncol, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if bc not in BLOCK_COLS:
        raise ValueError(f"block width {bc}: the kernel takes {BLOCK_COLS}")

    fn = _build.entry(
        f"femcy_bell_spmv_{_VALUE_NAMES[v_dt]}_{_X_NAMES[x.dtype]}", _ARGTYPES)
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    _build.launch(fn, x.device, "bell_spmv kernel launch",
                  op.values_t.data_ptr(), op.ncol_t.data_ptr(),
                  op.counts.data_ptr(), x.data_ptr(), y.data_ptr(), N, op.br,
                  bc)
    spmv.launches += 1
    return y


spmv.launches = 0
