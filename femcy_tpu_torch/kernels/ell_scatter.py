"""Deterministic stiffness scatter on Hopper: the wrapper of
csrc/ell_scatter.cu (M1).

Replaces the segment-sum scatters of the JAX package's general path --
``femcy_tpu/assembly.py`` ``scatter_stiffness_blocks`` (:167-176, ELL
layout) and ``femcy_tpu/solvers/dia.py`` ``dia_scatter`` (:155-160,
general-DIA layout), called from ``system._scatter`` (:583-596) -- with
one gather-form kernel and no atomics: element stiffnesses (E, edof, edof)
-> values (n_dof, W) on the ELL layout or (n_dof, K) on the DIA layout.

``build_scatter_plan`` inverts the element-node map once per pattern on
the host (a stable argsort of the pairs' nodes: each node's element-node
pairs in element order), stores each pair's node-ELL positions, the
nodes sorted by their first pair (for the internal-force kernel, M4) and,
on the DIA layout, the DIA column of every ELL slot, and uploads them.  The
kernel walks one node row per warp over those pairs (see the source),
summing in shared memory; a plan with a longer row than that holds, or
with more than 2^15 DIA columns, is wide, and the kernel sums in the
output instead, so every pattern is accepted.
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
from femcy_tpu_torch.solvers.dia import DIAPattern, ell_to_dia_columns
from femcy_tpu_torch.topology import ELLPattern

_ENTRY = {torch.float32: "femcy_ell_scatter_f32",
          torch.float64: "femcy_ell_scatter_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
#: a lane of the kernel takes at most this many values of a band (32 lanes
#: each): dm * dm * npe <= 256
_MAX_ROUNDS = 8
#: the longest node row (dm * W values, reckoned at 8 bytes) that the kernel
#: sums in shared memory (kRowBytes in csrc/ell_scatter.cu); a plan with a
#: longer row, or with more than 2^15 DIA columns, is wide
SHARED_ROW_BYTES = 48 * 1024


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
    #: (n_nodes + 1,) int64: node n's pairs are pairs[node_ptr[n]:node_ptr[n+1]]
    node_ptr: torch.Tensor
    #: (E * npe,) int32: the element-node pairs p = e * npe + a with
    #: elements[e, a] == n, grouped by node n, ascending within each;
    #: stored as ~p (negative) where element e names one node twice
    pairs: torch.Tensor
    #: (n_nodes,) int32: the nodes sorted by their first (smallest) pair,
    #: nodes with no pair last; the internal-force kernel (M4) sums node
    #: node_order[t] in lane group t, so neighbouring groups read
    #: neighbouring elements.  M1 does not read it
    node_order: torch.Tensor
    #: (E * npe * npe,) int16 (int32 if wide): at t * npe + b, the position
    #: of elements[e, b] in the node-ELL row of pair t's node
    positions: torch.Tensor
    #: (n_dof * W,) int16 (int32 if wide): the DIA column k in [0, K) of
    #: each flat ELL slot, -1 on padding; None on the ELL layout
    dia_columns: Optional[torch.Tensor] = None
    #: a node row longer than SHARED_ROW_BYTES or more than 2^15 DIA
    #: columns: the kernel sums in the output itself, over int32 indices
    wide: bool = False


def node_pairs(block_targets: np.ndarray, node_width: int, npe: int,
               n_nodes: int):
    """The inverse of the element-node map from the node-block map.

    Returns (node_ptr, pairs, positions, flagged): per node, its pairs
    p = e * npe + a in ascending p (the stable argsort of the pairs' nodes,
    CSR form), each pair's (npe,) node-ELL positions in pair order, and
    whether the pair's element names one node twice (two b with one
    position)."""
    bt = block_targets.reshape(-1, npe)
    node = bt[:, 0] // node_width
    pairs = np.argsort(node, kind="stable").astype(np.int32)
    node_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(node, minlength=n_nodes), out=node_ptr[1:])
    positions = (bt % node_width)[pairs]
    srt = np.sort(positions, axis=1)
    flagged = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    return node_ptr, pairs, positions, flagged


def first_pair_order(node_ptr: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """The nodes sorted by their first pair, (n_nodes,) int32: node n's
    key is its smallest pair p (``pairs[node_ptr[n]]``, decoded where it
    is stored as ~p), a node with no pair gets a key past every pair, and
    the sort is stable."""
    key = np.full(node_ptr.shape[0] - 1, pairs.shape[0], dtype=np.int64)
    has = np.diff(node_ptr) > 0
    first = pairs[node_ptr[:-1][has]].astype(np.int64)
    key[has] = np.where(first < 0, ~first, first)
    return np.argsort(key, kind="stable").astype(np.int32)


def with_orphan_node(plan: ScatterPlan, k: int) -> ScatterPlan:
    """The plan for the same mesh with one more node, numbered k, that no
    element names (the mesh's nodes k and up move up by one): node k gets
    an empty pair list, so it comes last in ``node_order`` and its forces
    are 0.  The pattern builders refuse such a mesh (a dof without a
    diagonal entry), so the checks of M4 on one make its plan this way."""
    ptr = plan.node_ptr.cpu().numpy()
    ptr = np.concatenate([ptr[:k + 1], ptr[k:]])
    order = first_pair_order(ptr, plan.pairs.cpu().numpy())
    device = plan.node_ptr.device
    return dataclasses.replace(
        plan, n_dof=plan.n_dof + plan.dm,
        out_shape=(plan.n_dof + plan.dm, plan.out_shape[1]),
        node_ptr=torch.as_tensor(ptr, device=device),
        node_order=torch.as_tensor(order, device=device))


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
    if E * npe >= 2**31:
        raise ValueError("more than 2^31 element-node pairs")
    if npe > 32 or dm * dm * npe > 32 * _MAX_ROUNDS:
        raise ValueError(f"elements of {npe} nodes are not supported")
    node_ptr, pairs, positions, flagged = node_pairs(
        bt, pattern.node_width, npe, pattern.n_dof // dm)
    pairs[flagged] = ~pairs[flagged]
    # a short row has at most 6144 / dm^2 node slots: int16 holds its
    # positions
    wide = (dm * pattern.width * 8 > SHARED_ROW_BYTES
            or (dia is not None and dia.n_offsets > 2**15))
    index = np.int32 if wide else np.int16
    dia_columns = None
    out_shape = (pattern.n_dof, pattern.width)
    if dia is not None:
        dia_columns = torch.as_tensor(
            ell_to_dia_columns(pattern, dia.offsets, index), device=device)
        out_shape = (pattern.n_dof, dia.n_offsets)
    return ScatterPlan(
        n_dof=pattern.n_dof,
        width=pattern.width,
        node_width=pattern.node_width,
        dm=dm,
        npe=npe,
        n_elements=E,
        out_shape=out_shape,
        node_ptr=torch.as_tensor(node_ptr, device=device),
        pairs=torch.as_tensor(pairs, device=device),
        node_order=torch.as_tensor(first_pair_order(node_ptr, pairs),
                                   device=device),
        positions=torch.as_tensor(positions.reshape(-1).astype(index),
                                  device=device),
        dia_columns=dia_columns,
        wide=wide,
    )


def _listed_pairs(plan: ScatterPlan):
    """(node, p), int64, for each entry t of the plan's pair list: the node
    it is listed under and its pair p = e * npe + a, decoded."""
    counts = plan.node_ptr.diff()
    node = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts,
        output_size=plan.pairs.shape[0])
    p = plan.pairs.long()
    return node, torch.where(p < 0, ~p, p)


def pair_nodes(plan: ScatterPlan):
    """The node of every element-node pair p = e * npe + a, (E * npe,)
    int64, recovered from the plan: ``elements.reshape(-1)``."""
    node, p = _listed_pairs(plan)
    out = torch.empty_like(node)
    out[p] = node
    return out


def block_targets(plan: ScatterPlan):
    """The node-block map (E * npe * npe,) int64, recovered from the plan:
    entry (p, b) of pair p = e * npe + a, which the plan lists under node
    n at t, is n * node_width + positions[t * npe + b]."""
    node, p = _listed_pairs(plan)
    bt = torch.empty((p.shape[0], plan.npe), dtype=torch.long,
                     device=p.device)
    bt[p] = (node[:, None] * plan.node_width
             + plan.positions.view(-1, plan.npe).long())
    return bt.reshape(-1)


def contribution_targets(plan: ScatterPlan):
    """The flat int64 output slot of every Ke entry, in Ke layout order:
    the expanded dof-level targets, remapped to the DIA slots on the DIA
    layout."""
    targets = expand_block_targets(block_targets(plan), plan.node_width,
                                   plan.dm, plan.width, plan.npe)
    if plan.dia_columns is not None:
        targets = ((targets // plan.width) * plan.out_shape[1]
                   + plan.dia_columns[targets].long())
    return targets


def scatter_plain(Ke, plan: ScatterPlan):
    """The plain version: an indexed add of Ke over its contribution
    targets, in contribution order -- femcy_tpu's segment-sum."""
    return scatter_stiffness(Ke, contribution_targets(plan), *plan.out_shape)


def scatter(Ke, plan: ScatterPlan):
    """Element stiffnesses (E, edof, edof) -> values of ``plan.out_shape``."""
    edof = plan.npe * plan.dm
    if Ke.shape != (plan.n_elements, edof, edof):
        raise ValueError(
            f"Ke shape {tuple(Ke.shape)} != ({plan.n_elements}, {edof}, {edof})"
        )
    if Ke.dtype not in _ENTRY:
        raise TypeError(f"Ke must be float32 or float64, got {Ke.dtype}")
    if Ke.device != plan.node_ptr.device:
        raise ValueError(
            f"Ke and the plan must share a device, got {Ke.device} and "
            f"{plan.node_ptr.device}"
        )
    if not Ke.is_contiguous():
        raise ValueError("Ke must be contiguous")
    if Ke.device.type == "cpu":
        return scatter_plain(Ke, plan)
    if Ke.device.type != "cuda":
        raise ValueError(f"unsupported device {Ke.device}")

    fn = _build.entry(_ENTRY[Ke.dtype], _ARGTYPES)
    # every value is written by the kernel, padding and unmapped DIA
    # columns included
    out = torch.empty(plan.out_shape, dtype=Ke.dtype, device=Ke.device)
    cols = plan.dia_columns
    _build.launch(fn, Ke.device, "ell_scatter kernel launch", Ke.data_ptr(),
                  plan.node_ptr.data_ptr(), plan.pairs.data_ptr(),
                  plan.positions.data_ptr(),
                  None if cols is None else cols.data_ptr(), int(plan.wide),
                  out.data_ptr(), plan.node_ptr.shape[0] - 1, plan.width,
                  plan.out_shape[1], plan.npe, plan.dm)
    scatter.launches += 1
    return out


scatter.launches = 0
