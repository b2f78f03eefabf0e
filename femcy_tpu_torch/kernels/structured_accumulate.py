"""Structured-box DIA accumulate on Hopper: the wrapper of
csrc/structured_accumulate.cu.

Replaces ``femcy_tpu/kernels/structured_accumulate.py``
(``pallas_accumulate``, its ``_kernel`` and ``build_accumulate_plan``):
the 864 corner-shifted (orientation, p, q) element-stiffness planes of a
Kuhn box summed into DIA values (n_dof, K) with no scatter.

Bound on the H100 by reading the planes once (6 * 144 * nx*ny*nz values,
1.2 GB in f64 at the 1M-element box).  The kernel is the gather form: one
thread per output entry walks its (i, k) group's combo list from
``structured.build_structured_plan``, passed as a CSR table, in list order
and with no atomics, so results are identical bit for bit from run to run;
a block's 32 lanes read 32 consecutive cells of one plane (see the source
for the design).  The TPU plan's f32 gate, VMEM budget, block sizing,
``_PF2`` lane cover (which refused nz > 126), 128-lane splits and padded
cell space have no counterpart: the planes are in plain cell order and the
kernel runs in the working dtype at any box size.

``accumulate`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors, and only for them, it runs the plain version
(``structured.accumulate_planes``).  ``accumulate.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.structured import StructuredPlan, accumulate_planes

_ENTRY = {
    torch.float32: "femcy_structured_accumulate_f32",
    torch.float64: "femcy_structured_accumulate_f64",
}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


class AccumulateTable:
    """The combo list of a StructuredPlan as a CSR table over the 3 K
    output columns c = i * K + k.

    col_start (3K + 1,) int32: column c's combos are
    entries[col_start[c]:col_start[c + 1]], in plan order;
    entries (n_combos, 4) int32: (o * 144 + 12 p + q, dx, dy, dz).
    The device copies are made once per device, at first use.
    """

    def __init__(self, plan: StructuredPlan):
        self.plan = plan
        K = plan.n_offsets
        cols = [[] for _ in range(3 * K)]
        for (i, k), combos in plan.groups.items():
            for o, p, q, (dx, dy, dz) in combos:
                cols[i * K + k].append((o * 144 + 12 * p + q, dx, dy, dz))
        self.col_start = np.zeros(3 * K + 1, dtype=np.int32)
        self.col_start[1:] = np.cumsum([len(c) for c in cols])
        self.entries = np.asarray(
            [e for c in cols for e in c], dtype=np.int32
        ).reshape(-1, 4)
        self._device = {}

    @property
    def n_cols(self) -> int:
        return 3 * self.plan.n_offsets

    def on(self, device):
        """(col_start, entries) as int32 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._device:
            self._device[device] = (
                torch.from_numpy(self.col_start).to(device),
                torch.from_numpy(self.entries).to(device).contiguous(),
            )
        return self._device[device]


def accumulate(planes, table: AccumulateTable):
    """(6, 144, nx*ny*nz) stiffness planes -> DIA values (n_dof, K)."""
    plan = table.plan
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    if planes.shape != (6, 144, nx * ny * nz):
        raise ValueError(
            f"planes shape {tuple(planes.shape)} != (6, 144, {nx * ny * nz})"
        )
    if planes.dtype not in _ENTRY:
        raise TypeError(f"planes must be float32 or float64, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    if planes.device.type == "cpu":
        return accumulate_planes(planes, plan)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")

    col_start, entries = table.on(planes.device)
    n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
    out = planes.new_empty((3 * n_nodes, K))
    fn = _build.entry(_ENTRY[planes.dtype], _ARGTYPES)
    _build.launch(fn, planes.device, "structured_accumulate kernel launch",
                  planes.data_ptr(), out.data_ptr(), col_start.data_ptr(),
                  entries.data_ptr(), nx, ny, nz, table.n_cols)
    accumulate.launches += 1
    return out


accumulate.launches = 0
