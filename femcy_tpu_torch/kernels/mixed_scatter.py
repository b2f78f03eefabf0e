"""Deterministic mixed beam + continuum stiffness scatter on Hopper: the
wrapper of csrc/mixed_scatter.cu (M6).

Replaces the two indexed adds of femcy_tpu's mixed assembly
(``femcy_tpu/mixed.py``, ``MixedSystem._assemble_impl``, :231-263):
every continuum block's element stiffnesses (E_b, 3 npe_b, 3 npe_b) and
every beam block's global-frame stiffnesses (E_b, 12, 12), in femcy_tpu's
block order, summed into the ELL values (6 N, W) of the 6-dof union
pattern (``mixed.build_union_pattern_6dof``), one running sum per slot.

``build_mixed_plan`` inverts the blocks' element-node maps once per
pattern on the host (a stable argsort of the pairs' nodes over all blocks:
each node's element-node pairs in block order, then element order),
stores each pair's run starts in the node's translation row (and, for a
beam pair, in its rotation row) and gives each block its kind (C3D4, B31
or generic), which the kernel fixes at compile time.  The kernel walks
one node's rows per warp over those pairs (see the source), summing the
translation rows in shared memory and the rotation rows in the output; a
plan whose three translation rows of a node pass ``SHARED_ROW_BYTES``
(W > 1024) is wide, and the kernel sums every row in the output, so every
width is accepted.
``scatter`` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors, and only for them, it runs the plain version
(``scatter_plain``: one indexed add per block over its expanded targets,
into one accumulator).  ``scatter.launches`` counts kernel launches and
``scatter.wide_launches`` those of them on a wide plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build

_ENTRY = {torch.float32: "femcy_mixed_scatter_f32",
          torch.float64: "femcy_mixed_scatter_f64"}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_ATTRIBUTES_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: the longest three translation rows of a node (3 * W values, reckoned at
#: 8 bytes) that the kernel sums in shared memory (kRowBytes in
#: csrc/mixed_scatter.cu); a wider pattern takes the wide route
SHARED_ROW_BYTES = 24 * 1024
#: block kinds, fixed at compile time in the kernel (kind 0, kTet and
#: kBeam in csrc/mixed_scatter.cu): any continuum element, C3D4, B31
KIND_GENERIC, KIND_TET, KIND_BEAM = 0, 1, 2
#: a generic block's band (9 npe values) takes at most 8 rounds of 32
_MAX_GENERIC_NPE = 28


def block_kind(npe: int, dm: int) -> int:
    """The kernel's kind of a block of ``npe``-node elements with ``dm``
    dofs a node."""
    if dm == 6:
        if npe != 2:
            raise ValueError(f"beam blocks are B31 (2 nodes), got {npe}")
        return KIND_BEAM
    if dm != 3:
        raise ValueError(f"mixed models need dm 3 or 6, got {dm}")
    if npe == 4:
        return KIND_TET
    if npe > _MAX_GENERIC_NPE:
        raise ValueError(f"elements of {npe} nodes are not supported")
    return KIND_GENERIC


@dataclasses.dataclass(frozen=True)
class MixedScatterPlan:
    n_nodes: int
    #: dof-level ELL width W of the union pattern
    width: int
    #: per block, in femcy_tpu's order (continuum blocks, then beam
    #: blocks): (n_elements, npe, dm), dm 3 (continuum) or 6 (beam)
    blocks: Tuple[Tuple[int, int, int], ...]
    #: per block: its kind (KIND_TET, KIND_BEAM or KIND_GENERIC)
    kinds: Tuple[int, ...]
    #: per block: the global id of its first element-node pair
    pair_offsets: Tuple[int, ...]
    #: run starts stored per pair: max(npe of the continuum blocks, 4),
    #: rounded up to a multiple of 4 (the kernel loads a pair's first four
    #: in one 8- or 16-byte load)
    stride: int
    #: (n_nodes + 1,) int64: node n's pairs are pairs[node_ptr[n]:node_ptr[n+1]]
    node_ptr: torch.Tensor
    #: (P,) int32: the global pair ids p = pair_offsets[b] + e * npe_b + a
    #: with elements_b[e, a] == n, grouped by node n, ascending within each;
    #: stored as ~p (negative) where element e names one node twice
    pairs: torch.Tensor
    #: (P * stride,) int16 (int32 if wide): at t * stride + k, pair t's
    #: run start of local node k in its node's translation row; for a beam
    #: pair, at k = 2 + b the rotation-row start of local node b
    positions: torch.Tensor
    #: a node's three translation rows pass SHARED_ROW_BYTES: the kernel
    #: sums in the output itself, over int32 run starts
    wide: bool = False

    @property
    def n_dof(self) -> int:
        return 6 * self.n_nodes

    @property
    def out_shape(self) -> Tuple[int, int]:
        return (6 * self.n_nodes, self.width)


def build_mixed_plan(n_nodes: int, width: int,
                     block_elements: Sequence[np.ndarray],
                     block_dms: Sequence[int],
                     block_positions: Sequence[np.ndarray],
                     device) -> MixedScatterPlan:
    """The kernel's operands on ``device`` from the union pattern's
    per-block run starts (``block_positions[b]``: (E_b, npe_b, S_b), the
    starts of ``mixed.build_union_pattern_6dof``).  Any width is taken:
    past ``SHARED_ROW_BYTES`` the plan is wide."""
    els = [np.asarray(el, dtype=np.int64) for el in block_elements]
    if not els:
        raise ValueError("need at least one block")
    kinds = tuple(block_kind(el.shape[1], int(dm))
                  for el, dm in zip(els, block_dms))
    sizes = [el.shape[0] * el.shape[1] for el in els]
    if sum(sizes) >= 2**31:
        raise ValueError("more than 2^31 element-node pairs")
    stride = -(-max(max(pos.shape[2] for pos in block_positions), 4) // 4) * 4
    wide = 3 * width * 8 > SHARED_ROW_BYTES
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    nodes = np.concatenate([el.reshape(-1) for el in els])
    order = np.argsort(nodes, kind="stable").astype(np.int32)
    node_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(nodes, minlength=n_nodes), out=node_ptr[1:])
    pos_all = np.zeros((nodes.shape[0], stride), dtype=np.int64)
    flagged = np.zeros(nodes.shape[0], dtype=bool)
    for el, pos, off in zip(els, block_positions, offsets):
        E, npe = el.shape
        p = pos.reshape(E * npe, -1)
        pos_all[off:off + E * npe, :p.shape[1]] = p
        # an element that names a node twice: two of its translation
        # starts coincide
        srt = np.sort(p[:, :npe], axis=1)
        flagged[off:off + E * npe] = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    pairs = np.where(flagged[order], ~order, order).astype(np.int32)
    return MixedScatterPlan(
        n_nodes=n_nodes,
        width=width,
        blocks=tuple((el.shape[0], el.shape[1], int(dm))
                     for el, dm in zip(els, block_dms)),
        kinds=kinds,
        pair_offsets=tuple(int(o) for o in offsets),
        stride=int(stride),
        node_ptr=torch.as_tensor(node_ptr, device=device),
        pairs=torch.as_tensor(pairs, device=device),
        positions=torch.as_tensor(
            pos_all[order].reshape(-1).astype(np.int32 if wide else np.int16),
            device=device),
        wide=wide,
    )


def contribution_targets(plan: MixedScatterPlan) -> List[torch.Tensor]:
    """Per block, the flat int64 output slot of every entry of its element
    matrices, in their layout order, recovered from the plan: value
    (e, a, di, b, dj) goes to row 6 n + di (n = elements[e, a]), slot
    start + dj, start being b's translation run start for di < 3 and its
    rotation run start for di >= 3."""
    counts = plan.node_ptr.diff()
    node = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts,
        output_size=plan.pairs.shape[0])
    p = plan.pairs.long()
    p = torch.where(p < 0, ~p, p)
    pos = plan.positions.view(-1, plan.stride).long()
    targets = []
    for (E, npe, dm), off in zip(plan.blocks, plan.pair_offsets):
        sel = (p >= off) & (p < off + E * npe)
        q = p[sel] - off
        node_b = torch.empty(E * npe, dtype=torch.long, device=p.device)
        node_b[q] = node[sel]
        pos_b = torch.empty((E * npe, plan.stride), dtype=torch.long,
                            device=p.device)
        pos_b[q] = pos[sel]
        edof = npe * dm
        k = torch.arange(edof * edof, device=p.device)
        a = k // (dm * edof)
        di = (k // edof) % dm
        b = (k % edof) // dm
        dj = k % dm
        run = torch.where(di >= 3, 2 + b, b)
        pair = torch.arange(E, device=p.device)[:, None] * npe + a[None, :]
        t = ((6 * node_b[pair] + di) * plan.width
             + pos_b[pair, run[None, :]] + dj)
        targets.append(t.reshape(-1))
    return targets


def _check(kes, plan: MixedScatterPlan):
    if len(kes) != len(plan.blocks):
        raise ValueError(f"{len(kes)} blocks of element matrices for a plan "
                         f"of {len(plan.blocks)}")
    for ke, (E, npe, dm) in zip(kes, plan.blocks):
        edof = npe * dm
        if tuple(ke.shape) != (E, edof, edof):
            raise ValueError(
                f"element matrices of shape {tuple(ke.shape)} != "
                f"({E}, {edof}, {edof})")
        if ke.dtype != kes[0].dtype or ke.dtype not in _ENTRY:
            raise TypeError("element matrices must share float32 or float64, "
                            f"got {[k.dtype for k in kes]}")
        if ke.device != plan.node_ptr.device:
            raise ValueError(
                f"element matrices and the plan must share a device, got "
                f"{ke.device} and {plan.node_ptr.device}")
        if not ke.is_contiguous():
            raise ValueError("element matrices must be contiguous")


def scatter_plain(kes: Sequence[torch.Tensor], plan: MixedScatterPlan):
    """The plain version: one indexed add per block over its contribution
    targets, block after block, into one accumulator -- femcy_tpu's
    running ``flat.at[targets].add``."""
    flat = kes[0].new_zeros(plan.n_dof * plan.width)
    for ke, targets in zip(kes, contribution_targets(plan)):
        flat.index_add_(0, targets, ke.reshape(-1))
    return flat.reshape(plan.out_shape)


def scatter(kes: Sequence[torch.Tensor], plan: MixedScatterPlan):
    """Every block's element matrices, in block order -> values of
    ``plan.out_shape``."""
    kes = list(kes)
    _check(kes, plan)
    device = kes[0].device
    if device.type == "cpu":
        return scatter_plain(kes, plan)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")

    fn = _build.entry(_ENTRY[kes[0].dtype], _ARGTYPES)
    # the kernel reads each band in 16-byte loads: a block that starts off
    # that boundary is copied to one that does not
    kes = [ke if ke.data_ptr() % 16 == 0 else ke.clone() for ke in kes]
    # the block table goes up from pinned memory, so the host does not
    # wait for the card's queue
    table = torch.tensor(
        [[ke.data_ptr(), off, npe, kind] for ke, (_, npe, _), kind, off
         in zip(kes, plan.blocks, plan.kinds, plan.pair_offsets)],
        dtype=torch.int64, pin_memory=True).to(device, non_blocking=True)
    # every value is written by the kernel, padding included
    out = torch.empty(plan.out_shape, dtype=kes[0].dtype, device=device)
    _build.launch(fn, device, "mixed_scatter kernel launch", table.data_ptr(),
                  len(kes), KIND_GENERIC in plan.kinds,
                  plan.node_ptr.data_ptr(), plan.pairs.data_ptr(),
                  plan.positions.data_ptr(), plan.stride, plan.wide,
                  out.data_ptr(), plan.n_nodes, plan.width)
    scatter.launches += 1
    scatter.wide_launches += plan.wide
    return out


scatter.launches = 0
scatter.wide_launches = 0


def kernel_attributes(dtype: torch.dtype, plan: MixedScatterPlan) -> dict:
    """What the kernel instance that ``scatter`` launches for ``plan`` in
    ``dtype`` takes on the current card: registers and local (spilled)
    bytes a thread, warps a block, blocks resident on an SM (the
    occupancy) and dynamic shared bytes a block."""
    fn = _build.entry("femcy_mixed_scatter_attributes", _ATTRIBUTES_ARGTYPES)
    out = (ctypes.c_int * 5)()
    code = fn(int(dtype == torch.float64), int(plan.wide),
              int(KIND_GENERIC in plan.kinds), plan.width,
              ctypes.addressof(out))
    if code != 0:
        msg = _build.load_library().femcy_cuda_error_string(code).decode()
        raise RuntimeError(f"mixed_scatter attributes: CUDA error {code} "
                           f"({msg})")
    keys = ("registers", "local_bytes", "warps_per_block", "blocks_per_sm",
            "shared_bytes")
    return dict(zip(keys, out))
