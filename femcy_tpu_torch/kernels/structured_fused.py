"""Fused structured assembly on Hopper (P3): the wrapper of
csrc/structured_fused.cu.

Replaces ``femcy_tpu/kernels/structured_fused.py`` (``pallas_fused_assemble``,
its ``_kernel`` and ``build_fused_plan``): node coordinates -> DIA values
(n_dof, K) of a Kuhn box in one kernel, for a one-Gauss-point element (C3D4)
with an isotropic tangent, whose element stiffness collapses to
Ke[(a,i),(b,j)] = vol (lam dNa_i dNb_j + mu dNa_j dNb_i + delta_ij mu
dNa.dNb).  Nothing is written between the coordinates (4.4 MB in f64 at
the 1M-element box) and the 262 MB of DIA values: the two-stage path
writes and reads back 1.2 GB of (6, 144, cells) planes.

The kernel is the gather form of P2 with the planes computed on the fly:
a block owns 32 consecutive nodes, stages the gradients of the cells they
touch in shared memory one orientation at a time, and sums each output
entry's combos in the plain version's order, with no atomics (see the
source).  The TPU plan's 128-lane DMA windows, ``_PF2`` cover, 32-row
sublane pad, VMEM budget and f32 gate have no counterpart: the kernel
reads the (n_nodes, 3) coordinates as they are, in f32 or f64, at any box
size.

``fused_assemble`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors, and only for them, it runs the plain version
(``structured.fused_assemble_plain``).  ``fused_assemble.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.structured import (
    StructuredPlan,
    fused_assemble_plain,
    isotropic_lame,
)

_ENTRY = {
    torch.float32: "femcy_fused_assemble_f32",
    torch.float64: "femcy_fused_assemble_f64",
}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


class FusedTable:
    """The combo list of a StructuredPlan, regrouped for P3.

    rows (6, 4, 4, 3, 3): rows[o, a, b, i, j] = i * K + k, the output
    column of entry ((a, i), (b, j)) of the orientation-o element
    stiffness; shift (6, 4, 3): the {0,1}^3 corner of node a of
    orientation o in its cell (femcy_tpu's ``rows``/``ashift``).

    The kernel's form: a CSR table over (orientation, column) pairs,
    col_start (6 * 3K + 1,) int32, pair o * 3K + c owning
    entries[col_start[..]:col_start[.. + 1]], in plan order; entries
    (864, 4) int32: (3a + i, 3b + j, 2 dx + dy, dz), (dx, dy, dz) the
    corner shift of node a; and corner_off (6, 4) int32, the flat node
    offset of each corner.  The device copies are made once per device.
    """

    def __init__(self, plan: StructuredPlan):
        self.plan = plan
        K = plan.n_offsets
        n_cols = 3 * K
        self.rows = np.full((6, 4, 4, 3, 3), -1, dtype=np.int64)
        self.shift = np.full((6, 4, 3), -1, dtype=np.int64)
        pairs = [[] for _ in range(6 * n_cols)]
        for (i, k), combos in plan.groups.items():
            for o, p, q, (dx, dy, dz) in combos:
                a, b, j = p // 3, q // 3, q % 3
                self.rows[o, a, b, i, j] = i * K + k
                self.shift[o, a] = (dx, dy, dz)
                pairs[o * n_cols + i * K + k].append((p, q, 2 * dx + dy, dz))
        if (self.rows < 0).any() or (self.shift < 0).any():
            raise ValueError("the plan does not cover every element entry")
        self.col_start = np.zeros(6 * n_cols + 1, dtype=np.int32)
        self.col_start[1:] = np.cumsum([len(c) for c in pairs])
        self.entries = np.asarray(
            [e for c in pairs for e in c], dtype=np.int32
        ).reshape(-1, 4)
        sy = plan.nz + 1
        sx = (plan.ny + 1) * sy
        self.corner_off = (self.shift @ np.array([sx, sy, 1])).astype(np.int32)
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


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    mesh: FEMesh
    table: FusedTable
    lam: float
    mu: float
    #: (4, 3) shape gradients at the one Gauss point, and its weight
    dN0: np.ndarray
    w0: float

    @property
    def plan(self) -> StructuredPlan:
        return self.table.plan


def build_fused_plan(mesh: FEMesh, plan: StructuredPlan, C_host):
    """P3's plan, or None when unsupported (anisotropic or missing
    ``C_host``, more than one Gauss point)."""
    lame = isotropic_lame(C_host) if C_host is not None else None
    dN = np.asarray(mesh.element.dshape_at_gp, dtype=np.float64)
    if lame is None or dN.shape != (1, 4, 3):
        return None
    return FusedPlan(
        mesh=mesh, table=plan.fused_table, lam=lame[0], mu=lame[1],
        dN0=dN[0], w0=float(np.asarray(mesh.element.gauss_weights)[0]),
    )


def fused_assemble(coords, fp: FusedPlan):
    """(n_nodes, 3) node coordinates -> DIA values (n_dof, K)."""
    plan = fp.plan
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
    if coords.shape != (n_nodes, 3):
        raise ValueError(
            f"coords shape {tuple(coords.shape)} != ({n_nodes}, 3)"
        )
    if coords.dtype not in _ENTRY:
        raise TypeError(f"coords must be float32 or float64, got {coords.dtype}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    if coords.device.type == "cpu":
        return fused_assemble_plain(coords, fp.mesh, fp.lam, fp.mu, plan)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")

    col_start, entries = fp.table.on(coords.device)
    # host arrays, read by the launch function before it returns
    consts = np.ascontiguousarray(
        np.concatenate([[fp.lam, fp.mu, fp.w0], fp.dN0.ravel()]),
        dtype=np.float64,
    )
    corner = np.ascontiguousarray(fp.table.corner_off, dtype=np.int32)
    out = coords.new_empty((3 * n_nodes, K))
    fn = _build.entry(_ENTRY[coords.dtype], _ARGTYPES)
    _build.launch(fn, coords.device, "structured_fused kernel launch",
                  coords.data_ptr(), out.data_ptr(), col_start.data_ptr(),
                  entries.data_ptr(), consts.ctypes.data, corner.ctypes.data,
                  nx, ny, nz, fp.table.n_cols)
    fused_assemble.launches += 1
    return out


fused_assemble.launches = 0
