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
a block owns a 4 x 4 x 4 brick of nodes, stages the gradients of every
tet of the cells it touches once in shared memory, and each thread keeps
one dof row's 45 sums in registers across the six orientations, summed in
the plain version's order with no atomics (see the source).  The Kuhn
subdivision of ``meshgen.box_tets`` (``KUHN``) is compiled into the
kernel; ``FusedTable`` pre-decodes the plan into the DIA column of each
(row i, neighbour slot, dof j).  The TPU plan's 128-lane DMA windows,
``_PF2`` cover, 32-row sublane pad, VMEM budget and f32 gate have no
counterpart: the kernel reads the (n_nodes, 3) coordinates as they are, in
f32 or f64, at any box size.

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
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

#: the Kuhn subdivision compiled into the kernel (meshgen.box_tets): the
#: cube corners of tet o, corner c at (c & 1, c >> 1 & 1, c >> 2 & 1).
#: The kernel's kuhn() and slot_of() are held to KUHN and SLOTS27 by
#: tests/test_torch_fused.py, which reads them from the source.
KUHN = ((0, 1, 3, 7), (0, 1, 7, 5), (0, 5, 7, 4), (0, 4, 7, 6), (0, 6, 7, 2),
        (0, 2, 7, 3))


def corner_delta(c: int) -> np.ndarray:
    """The {0,1}^3 offset of cube corner c in the kernel's numbering."""
    return np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])


def _code27(v) -> int:
    """Node offset v in {-1,0,1}^3 as (vx + 1) 9 + (vy + 1) 3 + vz + 1."""
    return int((v[0] + 1) * 9 + (v[1] + 1) * 3 + v[2] + 1)


#: the kernel's 15 neighbour slots: the node offsets between two corners
#: of a Kuhn tet, as ``_code27``, in ascending order
SLOTS27 = tuple(sorted({
    _code27(corner_delta(cb) - corner_delta(ca))
    for t in KUHN for ca in t for cb in t
}))


def slot_of(d_a, d_b) -> int:
    """The kernel's neighbour slot of node offset d_b - d_a."""
    return SLOTS27.index(_code27(np.asarray(d_b) - np.asarray(d_a)))


class FusedTable:
    """The combo list of a StructuredPlan, pre-decoded for P3.

    rows (6, 4, 4, 3, 3): rows[o, a, b, i, j] = i * K + k, the output
    column of entry ((a, i), (b, j)) of the orientation-o element
    stiffness; shift (6, 4, 3): the {0,1}^3 corner of node a of
    orientation o in its cell (femcy_tpu's ``rows``/``ashift``).

    The kernel's form: colk (3, 45) int32, colk[i, 3 s + j] = k, the DIA
    column of row i's entry for neighbour slot s (``slot_of``) and dof j;
    each row's other K - 45 columns get no entry.  Raises ValueError if
    the plan's box is not subdivided as ``KUHN`` or if two entries of a
    row would share a column.
    """

    def __init__(self, plan: StructuredPlan):
        self.plan = plan
        K = plan.n_offsets
        self.rows = np.full((6, 4, 4, 3, 3), -1, dtype=np.int64)
        self.shift = np.full((6, 4, 3), -1, dtype=np.int64)
        for (i, k), combos in plan.groups.items():
            for o, p, q, (dx, dy, dz) in combos:
                a, b, j = p // 3, q // 3, q % 3
                self.rows[o, a, b, i, j] = i * K + k
                self.shift[o, a] = (dx, dy, dz)
        if (self.rows < 0).any() or (self.shift < 0).any():
            raise ValueError("the plan does not cover every element entry")
        kuhn = np.array([[corner_delta(c) for c in t] for t in KUHN])
        if not np.array_equal(self.shift, kuhn):
            raise ValueError("the fused kernel is compiled for the Kuhn "
                             "subdivision of meshgen.box_tets")
        colk = np.full((3, 3 * len(SLOTS27)), -1, dtype=np.int64)
        for o in range(6):
            for a in range(4):
                for b in range(4):
                    s = slot_of(kuhn[o, a], kuhn[o, b])
                    for i in range(3):
                        for j in range(3):
                            k = self.rows[o, a, b, i, j] - i * K
                            if colk[i, 3 * s + j] not in (-1, k):
                                raise ValueError("slot columns disagree")
                            colk[i, 3 * s + j] = k
        if (colk < 0).any() or any(len(set(r)) != r.size for r in colk):
            raise ValueError("two entries of a row share a DIA column")
        self.colk = colk.astype(np.int32)

    @property
    def n_cols(self) -> int:
        return 3 * self.plan.n_offsets


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

    # host arrays, read by the launch function before it returns
    consts = np.ascontiguousarray(
        np.concatenate([[fp.lam, fp.mu, fp.w0], fp.dN0.ravel()]),
        dtype=np.float64,
    )
    colk = np.ascontiguousarray(fp.table.colk)
    out = coords.new_empty((3 * n_nodes, K))
    fn = _build.entry(_ENTRY[coords.dtype], _ARGTYPES)
    _build.launch(fn, coords.device, "structured_fused kernel launch",
                  coords.data_ptr(), out.data_ptr(), consts.ctypes.data,
                  colk.ctypes.data, nx, ny, nz, fp.table.n_cols)
    fused_assemble.launches += 1
    return out


fused_assemble.launches = 0
