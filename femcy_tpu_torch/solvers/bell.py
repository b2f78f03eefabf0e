"""Block-ELL sparse format: the general-mesh SpMV of the algebraic
multigrid.

Torch counterpart of ``femcy_tpu.solvers.bell``.  Grouping the dm x dm dof
couplings of each node pair into one dense block turns the dof-level ELL
operator into (n_nodes, node_width) block rows whose SpMV gathers
(dm,)-vector rows of x; the AMG's prolongators and restrictions are
rectangular block-ELL operators of the same kind (dm x 6 and 6 x dm in
3-D).

* :func:`build_bell_plan` (host): maps a dof-ELL pattern
  (topology.build_pattern) to the block layout -- a pure slot
  permutation, verified rather than assumed;
* :func:`plan_node_graph` (host): the node adjacency of a plan, with
  fully fixed nodes isolated;
* :func:`bell_from_ell`: dof-ELL values -> block values, pads zeroed;
* :func:`bell_spmv`: the plain torch version of the rectangular-block
  SpMV.  The solves run the hand-written kernel instead
  (kernels/bell_spmv.py, M3), which runs this function for CPU tensors;
* :func:`csr_to_bell` (host): scipy CSR -> block-ELL arrays.

The host functions are copies of femcy_tpu's (numpy and scipy).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BellPlan:
    """Host-built conversion plan from a dof-ELL pattern to block-ELL.

    The dof-ELL layout of a FEM pattern is blockwise by construction
    (pattern builders emit, for dof row ``n*dm+i``, sorted columns
    ``ncol[n,k]*dm+j`` at position ``k*dm+j``), so the ELL -> block-ELL
    conversion is a pure reshape+transpose; ``build_bell_plan`` verifies
    the layout."""

    n_nodes: int
    dm: int
    width: int  # node-row width == pattern.width // dm
    ncol: np.ndarray  # (n_nodes, width) int32 node column ids (pad: 0)
    valid: np.ndarray  # (n_nodes, width) bool


def build_bell_plan(pattern, dm: int) -> BellPlan:
    """dof-ELL pattern -> block plan (host, numpy; one verification pass).

    Requires the blockwise dof-ELL layout every FEM pattern builder emits
    (topology.build_pattern, native/pattern.cpp): every dm x dm coupling
    of a node pair present, dof row ``n*dm+i`` holding sorted columns
    ``ncol[n,k]*dm+j`` at position ``k*dm+j``, zero-padded past
    ``row_counts``.  The layout is VERIFIED here (one vectorized pass)
    rather than assumed, because everything downstream (bell_from_ell's
    reshape, the direct BSR export) silently produces garbage if it does
    not hold."""
    n_dof = pattern.n_dof
    n_nodes = n_dof // dm
    W = pattern.width
    if W % dm != 0:
        raise ValueError(
            f"dof-ELL width {W} is not a multiple of dm={dm}: "
            "not a blockwise FEM pattern"
        )
    width = W // dm
    colidx = pattern.colidx
    row_counts = pattern.row_counts

    node_counts = row_counts[0::dm]
    if (node_counts % dm).any():
        # femcy_tpu leaves this to the expansion check below
        raise ValueError(
            f"dof-ELL row counts are not whole {dm}-column node blocks"
        )
    ncol = (colidx[0::dm, 0::dm] // dm).astype(np.int32)
    valid = (
        np.arange(width, dtype=np.int32)[None, :]
        < (node_counts // dm)[:, None]
    )
    ncol = np.where(valid, ncol, 0).astype(np.int32)

    # verify: every dof row of a node must expand ncol blockwise, and all
    # dm rows of a node must agree on the count
    if not (row_counts.reshape(n_nodes, dm) == node_counts[:, None]).all():
        raise ValueError("dof rows of a node disagree on entry count")
    expect = (
        ncol[:, None, :, None] * dm
        + np.arange(dm, dtype=np.int32)[None, None, None, :]
    ).reshape(n_nodes, 1, W)
    got = colidx.reshape(n_nodes, dm, W)
    mask = (
        np.arange(W, dtype=np.int32)[None, None, :]
        < node_counts[:, None, None]
    )
    if not (np.where(mask, got == expect, True)).all():
        raise ValueError(
            "dof-ELL columns are not the blockwise expansion of the node "
            "pattern; block-ELL conversion would be wrong"
        )
    return BellPlan(
        n_nodes=n_nodes, dm=dm, width=width, ncol=ncol, valid=valid
    )


def plan_node_graph(plan: BellPlan, fixed: np.ndarray):
    """Node adjacency CSR from a BellPlan: no self loops; nodes with ALL dm
    dofs Dirichlet-fixed are isolated both ways -- exactly the graph the
    AMG extracts from the BC-eliminated operator at theta=0, without
    touching the (much larger) dof-entry arrays."""
    import scipy.sparse as sp

    n_nodes, dm = plan.n_nodes, plan.dm
    node_fixed = np.asarray(fixed, bool).reshape(n_nodes, dm).all(axis=1)
    counts = plan.valid.sum(axis=1)
    rows = np.repeat(np.arange(n_nodes, dtype=np.int64), counts)
    cols = plan.ncol[plan.valid].astype(np.int64)
    keep = (rows != cols) & ~node_fixed[rows] & ~node_fixed[cols]
    return sp.csr_matrix(
        (np.ones(int(keep.sum()), dtype=np.int8), (rows[keep], cols[keep])),
        shape=(n_nodes, n_nodes),
    )


def bell_from_ell(values, plan: BellPlan):
    """dof-ELL values (n_dof, width_dof) -> block values
    (n_nodes, width, dm, dm): a reshape+transpose (the dof layout is
    blockwise, verified by build_bell_plan) and one copy.  Pad blocks are
    zeroed."""
    b = values.reshape(plan.n_nodes, plan.dm, plan.width, plan.dm).transpose(1, 2)
    valid = torch.as_tensor(plan.valid, dtype=values.dtype, device=values.device)
    return b * valid[:, :, None, None]


def bell_spmv(bvalues, ncol, x):
    """y = A @ x on rectangular block-ELL, the plain version of M3.

    bvalues: (N, K, br, bc); ncol: (N, K) integer block-column ids (pads
    hold col 0 with zero blocks); x: (N_cols * bc,).  Returns (N * br,) in
    x's dtype: the blocks are cast to it first (bf16 blocks against an f64
    vector compute in f64, as JAX promotes them)."""
    bc = bvalues.shape[-1]
    g = x.reshape(-1, bc)[ncol.long()]  # (N, K, bc) -- the ROW gather
    return torch.einsum("nkij,nkj->ni", bvalues.to(x.dtype), g).reshape(-1)


def csr_to_bell(
    A, br: int, bc: int, n_block_cols: int | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """scipy CSR -> (bvalues (N, K, br, bc), ncol (N, K) int32), host.

    Groups entries by (row // br, col // bc); K is the max block-row
    degree.  Works for rectangular operators (AMG P: br=dm, bc=6).  The
    block-key dedup runs through scipy's C COO->CSR conversion."""
    import scipy.sparse as sp

    A = A.tocoo()
    nbr_rows = -(-A.shape[0] // br)
    ncols_of = n_block_cols or (-(-A.shape[1] // bc))
    brow = (A.row // br).astype(np.int64)
    bcol = (A.col // bc).astype(np.int64)
    # dedup (brow, bcol) pairs; duplicates per block <= br*bc fits int8
    Bpat = sp.csr_matrix(
        (np.ones(brow.shape[0], dtype=np.int8), (brow, bcol)),
        shape=(nbr_rows, ncols_of),
    )
    Bpat.sum_duplicates()
    Bpat.sort_indices()
    cnt = np.diff(Bpat.indptr)
    K = max(int(cnt.max()), 1) if cnt.size else 1
    u_row = np.repeat(np.arange(nbr_rows, dtype=np.int64), cnt)
    pos = np.arange(Bpat.nnz, dtype=np.int64) - Bpat.indptr[u_row]
    ncol = np.zeros((nbr_rows, K), dtype=np.int32)
    ncol[u_row, pos] = Bpat.indices.astype(np.int32)
    # entry -> block slot: Bpat's CSR entries are globally sorted by
    # brow*ncols+bcol, so one searchsorted resolves every entry
    bkeys = u_row * np.int64(ncols_of) + Bpat.indices
    loc = np.searchsorted(bkeys, brow * np.int64(ncols_of) + bcol)
    slot = (u_row * K + pos)[loc]
    flat = (slot * br + A.row % br) * bc + A.col % bc
    bvalues = np.bincount(
        flat, weights=A.data, minlength=nbr_rows * K * br * bc
    ).astype(A.data.dtype).reshape(nbr_rows, K, br, bc)
    return bvalues, ncol
