"""Smoothed-aggregation algebraic multigrid for UNSTRUCTURED meshes.

Torch counterpart of ``femcy_tpu.solvers.amg``.  The geometric V-cycle
(solvers/multigrid.py) needs a dyadically coarsenable box grid; every
real .inp mesh misses it.  This is the general-mesh preconditioner:
classical smoothed aggregation (Vanek/Mandel/Brezina) built on the host
from the assembled operator, applied on the device as a V-cycle of
block-ELL SpMVs.

* **Host setup, device cycle.**  Aggregation, QR of the rigid-body modes,
  prolongator smoothing and the Galerkin triple products are irregular
  sparse-matrix work for numpy and scipy; the host functions below are
  copies of femcy_tpu's, so the port builds the same hierarchy arrays
  from the same operator.  What runs per CG iteration on the device is
  block-ELL SpMVs (kernels/bell_spmv.py, M3, on CUDA), Chebyshev
  smoothing and one small dense matrix-vector product.
* **Node-block aggregation + rigid-body near-nullspace** (6 modes in 3-D,
  3 in 2-D), the standard requirement for AMG on elasticity.
* **Chebyshev smoothing** (the structured multigrid's recurrence): a fixed
  polynomial in D^-1 A, so the cycle is a constant symmetric operator,
  valid inside plain PCG; lambda_max per level from a host power
  iteration.
* **bf16 storage.**  As in femcy_tpu, every float array of the hierarchy
  -- level values, inverse diagonals, P and R -- is stored in bfloat16;
  the V-cycle computes in the vector's dtype on those rounded entries
  (bf16 blocks widened exactly in the kernel, bf16 diagonals promoted by
  torch).  The coarsest level is a dense inverse computed in f64 on the
  host and kept in ``dtype``.

femcy_tpu's ``operands()`` (the level arrays as jit arguments) has no
counterpart: the V-cycle reads the level tensors directly.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from typing import List, Optional, Tuple

import numpy as np
import torch

from femcy_tpu_torch.kernels import bell_spmv as k_bell
from femcy_tpu_torch.solvers.dia import pcg
from femcy_tpu_torch.utils.device import resolve_device
from femcy_tpu_torch.utils.timing import span

logger = logging.getLogger("femcy_tpu_torch")


def _aggregate(G) -> Tuple[np.ndarray, int]:
    """Greedy node aggregation (the standard two-pass VMB scheme).

    Pass 0 DROPS isolated nodes (agg = -2): in a BC-eliminated operator a
    fully-Dirichlet-fixed node has no off-diagonal coupling at all, and
    giving it a coarse representation poisons every level below -- measured
    on a clamped box: 289 fixed-face nodes became 289 singleton aggregates
    whose zero candidate rows turned into 289 zombie identity blocks on
    EVERY coarse level, capping the coarsening ratio at ~2x and forcing a
    5.9k-dof dense coarsest inverse.  Their residuals are identically zero,
    so the V-cycle loses nothing by never transferring them.

    Pass 1 seeds an aggregate from every node whose whole neighbourhood is
    untouched; pass 2 attaches leftovers to an adjacent aggregate;
    connected leftovers with no aggregated neighbour become singletons.
    """
    n = G.shape[0]
    indptr, indices = G.indptr, G.indices
    agg = np.full(n, -1, dtype=np.int64)
    agg[np.diff(indptr) == 0] = -2  # dropped: no coarse representation
    cnt = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = cnt
            agg[nbrs] = cnt
            cnt += 1
    for i in np.nonzero(agg == -1)[0]:
        nbrs = indices[indptr[i] : indptr[i + 1]]
        cand = agg[nbrs]
        cand = cand[cand >= 0]
        if cand.size:
            agg[i] = cand[0]
        else:
            agg[i] = cnt
            cnt += 1
    return agg, cnt


def _node_graph_bsr(A, theta: float = 0.0):
    """BSR (blk, blk) operator -> node adjacency CSR (no self loops).

    Same semantics as :func:`_node_graph` but reads the block structure
    directly: the block Frobenius weights are one einsum over the stored
    blocks instead of a COO pass over every scalar entry -- the single-core
    host this runs on cannot parallelize its way out of that pass.
    Zero-weight blocks (tobsr padding / eliminated couplings) are dropped,
    matching eliminate_zeros + _node_graph on the scalar operator."""
    import scipy.sparse as sp

    bs = A.blocksize[0]
    N = A.shape[0] // bs
    w = np.einsum(
        "kij,kij->k", A.data, A.data, dtype=np.float64, casting="same_kind"
    )
    rows = np.repeat(
        np.arange(N, dtype=np.int64), np.diff(A.indptr)
    )
    cols = A.indices.astype(np.int64)
    off = rows != cols
    if theta > 0.0:
        fro = np.sqrt(w)
        dfro = np.zeros(N)
        dmask = ~off
        dfro[rows[dmask]] = fro[dmask]
        dfro = np.where(dfro > 0.0, dfro, 1.0)
        keep = off & (fro > theta * np.sqrt(dfro[rows] * dfro[cols]))
    else:
        keep = off & (w > 0.0)
    return sp.csr_matrix(
        (np.ones(int(keep.sum()), dtype=np.int8), (rows[keep], cols[keep])),
        shape=(N, N),
    )


def _tentative_prolongator_bsr(agg, n_agg, B, dm: int, host_dtype):
    """Aggregates + near-nullspace -> (P0 as BSR (dm, nb), coarse B_c).

    Identical math to :func:`_tentative_prolongator` (zero-padded batched
    QR per aggregate, rank guard on the R diagonal) but the prolongator is
    assembled directly in BSR block form -- every node row holds exactly
    one (dm, nb) block, its aggregate's Q rows -- skipping the scalar COO
    construction and its sort entirely."""
    import scipy.sparse as sp

    n_dof, nb = B.shape
    n_nodes = n_dof // dm
    kept = np.nonzero(agg >= 0)[0]
    order = kept[np.argsort(agg[kept], kind="stable")]
    counts = np.bincount(agg[kept], minlength=n_agg)
    max_sz = int(counts.max())
    pad = np.full((n_agg, max_sz), -1, dtype=np.int64)
    pos = np.arange(kept.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    pad[agg[order], pos] = order
    rowsel = (pad[:, :, None] * dm + np.arange(dm)).reshape(n_agg, max_sz * dm)
    valid = rowsel >= 0
    Bblk = np.where(valid[:, :, None], B[np.maximum(rowsel, 0)], 0.0)
    Q, R = np.linalg.qr(Bblk)  # f64: the rank guard needs exact zeros
    scale = np.abs(R[:, np.arange(nb), np.arange(nb)])
    keep = scale > 1e-10 * max(scale.max(), 1e-300)
    Q = Q * keep[:, None, :]
    Bc = R * keep[:, :, None]

    has = agg >= 0
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(has, out=indptr[1:])
    node_ids = np.nonzero(has)[0]
    indices = agg[node_ids].astype(np.int32)
    pos_of = np.empty(n_nodes, dtype=np.int64)
    pos_of[order] = pos
    p = pos_of[node_ids]
    ridx = p[:, None] * dm + np.arange(dm)  # (len, dm) rows within Q[agg]
    data = Q[
        agg[node_ids][:, None, None],
        ridx[:, :, None],
        np.arange(nb)[None, None, :],
    ].astype(host_dtype)
    P0 = sp.bsr_matrix(
        (data, indices, indptr),
        shape=(n_dof, n_agg * nb),
        blocksize=(dm, nb),
    )
    return P0, Bc.reshape(n_agg * nb, nb)


def _bsr_to_bell(A) -> Tuple[np.ndarray, np.ndarray]:
    """BSR -> (bvalues (N, K, br, bc), ncol (N, K) int32): a pad, not a
    sort -- the BSR block rows ARE the block-ELL rows."""
    br, bc = A.blocksize
    N = A.shape[0] // br
    cnt = np.diff(A.indptr)
    K = max(int(cnt.max()), 1) if cnt.size else 1
    rows = np.repeat(np.arange(N, dtype=np.int64), cnt)
    pos = np.arange(A.indices.shape[0], dtype=np.int64) - A.indptr[:-1][rows]
    ncol = np.zeros((N, K), dtype=np.int32)
    ncol[rows, pos] = A.indices.astype(np.int32)
    bval = np.zeros((N, K, br, bc), dtype=A.data.dtype)
    bval[rows, pos] = A.data
    return bval, ncol


def _regularize_bsr(A):
    """Unit diagonal on zero-diagonal dofs (rank-deficient aggregates), in
    place on the BSR data; the BSR twin of :func:`_regularize`."""
    d = A.diagonal()
    zero = np.nonzero(d == 0.0)[0]
    if zero.size == 0:
        return A
    bs = A.blocksize[0]
    N = A.shape[0] // bs
    rows = np.repeat(np.arange(N, dtype=np.int64), np.diff(A.indptr))
    dmask = rows == A.indices
    diag_k = np.full(N, -1, dtype=np.int64)
    diag_k[rows[dmask]] = np.nonzero(dmask)[0]
    zrow, zi = zero // bs, zero % bs
    k = diag_k[zrow]
    if (k < 0).any():
        # a zero-diag block row with no structural diagonal block: rare
        # enough to pay the scalar path
        return _regularize(A.tocsr()).tobsr(A.blocksize)
    A.data[k, zi, zi] = 1.0
    return A


def _rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """(n_nodes, dm) coords -> (n_dof, nb) rigid-body modes.

    3D: 3 translations + 3 rotations (nb=6); 2D: 2 translations + the
    in-plane rotation (nb=3).  Coordinates are centered so the rotation
    columns stay well scaled.
    """
    c = coords - coords.mean(axis=0, keepdims=True)
    n, dm = c.shape
    if dm == 3:
        B = np.zeros((n, 3, 6))
        B[:, 0, 0] = B[:, 1, 1] = B[:, 2, 2] = 1.0
        x, y, z = c[:, 0], c[:, 1], c[:, 2]
        B[:, 0, 3], B[:, 1, 3] = -y, x  # rotation about z
        B[:, 1, 4], B[:, 2, 4] = -z, y  # rotation about x
        B[:, 2, 5], B[:, 0, 5] = -x, z  # rotation about y
        return B.reshape(n * 3, 6)
    if dm == 2:
        B = np.zeros((n, 2, 3))
        B[:, 0, 0] = B[:, 1, 1] = 1.0
        B[:, 0, 2], B[:, 1, 2] = -c[:, 1], c[:, 0]
        return B.reshape(n * 2, 3)
    raise ValueError(f"unsupported spatial dimension {dm}")


def _tentative_prolongator(agg, n_agg, B, dm: int):
    """Aggregates + near-nullspace -> (P0 CSR, coarse candidate B_c).

    Per aggregate a zero-padded batched QR of the candidate rows: columns
    whose R diagonal is (near) zero -- rank-deficient aggregates, e.g. a
    fully Dirichlet-fixed cluster -- are zeroed in both Q and B_c; the
    resulting zero coarse rows get a unit diagonal in the Galerkin product
    (see ``_regularize``), which pins their (identically zero) corrections.
    """
    import scipy.sparse as sp

    n_dof, nb = B.shape
    n_nodes = n_dof // dm
    kept = np.nonzero(agg >= 0)[0]  # dropped (-2) nodes get zero P rows
    order = kept[np.argsort(agg[kept], kind="stable")]
    counts = np.bincount(agg[kept], minlength=n_agg)
    max_sz = int(counts.max())
    # (n_agg, max_sz) node ids, padded with -1
    pad = np.full((n_agg, max_sz), -1, dtype=np.int64)
    pos = np.arange(kept.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    pad[agg[order], pos] = order
    # candidate rows per aggregate, zero rows for padding
    rowsel = (pad[:, :, None] * dm + np.arange(dm)).reshape(n_agg, max_sz * dm)
    valid = rowsel >= 0
    Bblk = np.where(valid[:, :, None], B[np.maximum(rowsel, 0)], 0.0)
    Q, R = np.linalg.qr(Bblk)  # (n_agg, max_sz*dm, nb), (n_agg, nb, nb)
    # rank guard: drop columns with a vanishing R diagonal
    scale = np.abs(R[:, np.arange(nb), np.arange(nb)])
    keep = scale > 1e-10 * max(scale.max(), 1e-300)
    Q = Q * keep[:, None, :]
    Bc = R * keep[:, :, None]

    rows = np.broadcast_to(rowsel[:, :, None], Q.shape)
    cols = np.broadcast_to(
        (np.arange(n_agg)[:, None] * nb + np.arange(nb))[:, None, :], Q.shape
    )
    m = np.broadcast_to(valid[:, :, None], Q.shape) & (Q != 0.0)
    P0 = sp.csr_matrix(
        (Q[m], (rows[m], cols[m])), shape=(n_dof, n_agg * nb)
    )
    return P0, Bc.reshape(n_agg * nb, nb)


def _lambda_max_dinv(A, iters: int = 20, seed: int = 1) -> float:
    """lambda_max(D^-1 A) by host power iteration (+5% safety).

    The Gershgorin row-sum bound overestimates by ~1.7x on tet-mesh
    elasticity operators; feeding that into the prolongator smoothing and
    the Chebyshev interval costs mesh-independence (measured: PCG counts
    20/34/45 at nx=6/12/20 with Gershgorin vs 19/24/26 with this)."""
    d = A.diagonal()
    d = np.where(d > 0.0, d, 1.0)
    inv_d = (1.0 / d).astype(A.dtype)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0]).astype(A.dtype)
    lam = 1.0
    for _ in range(iters):
        y = inv_d * (A @ x)  # D^-1 A without forming it (works on CSR/BSR)
        ny = np.linalg.norm(y)
        if ny == 0.0:
            return 1.0
        lam = ny / np.linalg.norm(x)
        x = y / ny
    return float(lam) * 1.05


def _regularize(A):
    """Unit diagonal on empty rows (rank-deficient aggregates) so the
    coarse solve stays nonsingular; their residuals are identically zero."""
    d = A.diagonal()
    zero = np.nonzero(d == 0.0)[0]
    if zero.size:
        import scipy.sparse as sp

        A = A + sp.csr_matrix(
            (np.ones(zero.size, dtype=A.dtype), (zero, zero)), shape=A.shape
        )
    return A



_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class _AMGLevel:
    n_dof: int
    bs: int  # block size of this level (dm on level 0, nb below)
    #: (n_dof,) bf16 inverse diagonal
    inv_diag: torch.Tensor
    lmax: float
    #: the level's operator (coarse levels only; level 0 is the caller's)
    A: Optional[k_bell.BellOperand] = None
    #: block-ELL transfers DOWN from this level (absent on the coarsest):
    #: P maps coarse -> this level (blocks bs x bs_next), R the transpose
    P: Optional[k_bell.BellOperand] = None
    R: Optional[k_bell.BellOperand] = None

    # femcy_tpu's (N, K, br, bc) values and (N, K) ids, as views
    values = property(lambda self: _blocks(self.A))
    colidx = property(lambda self: _ids(self.A))
    P_values = property(lambda self: _blocks(self.P))
    P_colidx = property(lambda self: _ids(self.P))
    R_values = property(lambda self: _blocks(self.R))
    R_colidx = property(lambda self: _ids(self.R))


def _blocks(op):
    return None if op is None else op.bvalues


def _ids(op):
    return None if op is None else op.ncol


def _device_levels(staged, device) -> List[_AMGLevel]:
    """Staged host levels -> device levels: every float array as bf16.

    ``staged``: per level a dict of n_dof, bs, lmax, inv_diag and the
    (bvalues, ncol) pairs "A" (coarse levels), "P" and "R" (all but the
    coarsest), numpy."""

    def bf16(a):
        return torch.as_tensor(np.asarray(a)).to(torch.bfloat16).to(device)

    def op(pair, n_cols):
        if pair is None:
            return None
        v, c = pair
        return k_bell.operand(bf16(v), torch.as_tensor(np.asarray(c), device=device),
                              n_cols)

    levels = []
    for li, s in enumerate(staged):
        n_cols = s["n_dof"] // s["bs"]
        n_next = (staged[li + 1]["n_dof"] // staged[li + 1]["bs"]
                  if li + 1 < len(staged) else 0)
        levels.append(_AMGLevel(
            n_dof=s["n_dof"], bs=s["bs"], inv_diag=bf16(s["inv_diag"]),
            lmax=s["lmax"], A=op(s.get("A"), n_cols),
            P=op(s.get("P"), n_next), R=op(s.get("R"), n_cols),
        ))
    return levels


class AlgebraicMultigrid:
    """Smoothed-aggregation V-cycle preconditioner for a fixed operator.

    Parameters
    ----------
    A:
        BC-eliminated operator as scipy CSR/COO/BSR (host) -- e.g.
        ``pattern.to_scipy(values.cpu().numpy())`` after
        ``apply_dirichlet_linear``.
    dm:
        dofs per node (dofs of one mesh node are aggregated together).
    coords:
        (n_nodes, dm) node coordinates for the rigid-body candidate basis.
    fixed:
        boolean Dirichlet mask per dof; candidate rows there are zeroed so
        the coarse space never tries to move pinned dofs.
    dtype, device:
        the vectors' dtype (the coarsest inverse is kept in it) and the
        device of every level tensor (the card unless "cpu" is given).
    """

    def __init__(
        self,
        A,
        dm: int,
        coords: np.ndarray,
        fixed: np.ndarray,
        smooth_steps: int = 2,
        cheby_alpha: float = 4.0,
        coarse_max_dof: int = 2400,
        max_levels: int = 12,
        omega: float = 4.0 / 3.0,
        strength_theta: float = 0.06,
        fine_strength_theta: float = 0.0,
        dtype: torch.dtype = torch.float64,
        fine_graph=None,
        device="cuda",
    ):
        import scipy.sparse as sp

        self.device = resolve_device(device)
        self.dtype = dtype
        self.smooth_steps = int(smooth_steps)
        self.cheby_alpha = float(cheby_alpha)
        np_dtype = _NP_DTYPE[dtype]
        # The hierarchy math runs in the OPERATOR's dtype (f32 when the
        # caller hands the operator pulled back through bf16); the
        # rank-sensitive pieces (rigid-body QR, coarsest dense inverse)
        # stay f64 below.
        _t_prep = _time.perf_counter()
        A = sp.csr_matrix(A)
        if A.dtype not in (np.float32, np.float64):
            A = A.astype(np.float64)
        else:
            # own the arrays: eliminate_zeros() below mutates indices and
            # indptr in place, and sp.csr_matrix(csr) is a SHALLOW wrap
            A = A.copy()
        # ELL->CSR conversions keep explicit zeros (padding + BC-eliminated
        # entries); drop them so fully-fixed nodes are structurally isolated
        # -- the pass-0 drop in _aggregate depends on that
        A.eliminate_zeros()
        host_dtype = A.dtype
        B = _rigid_body_modes(np.asarray(coords, dtype=np.float64))
        B[np.asarray(fixed, dtype=bool)] = 0.0

        staged = []
        self._fine_nnz = float(A.nnz)
        #: host-setup wall-clock breakdown (seconds per phase)
        _t_total = _t_prep
        self.setup_seconds = {
            "prep": _time.perf_counter() - _t_prep,
            "lmax": 0.0, "bell": 0.0, "aggregate": 0.0, "qr": 0.0,
            "rap": 0.0, "coarse_inv": 0.0, "tobsr": 0.0, "upload": 0.0,
            "other": 0.0, "total": 0.0,
        }
        # the whole hierarchy build runs on BSR (block-sparse) matrices:
        # block-level Galerkin products chase dm^2 fewer indices than the
        # scalar CSR ones, the node graph is one einsum over the stored
        # blocks, and the block-ELL arrays are pads of the BSR data
        _t = _time.perf_counter()
        A = A.tobsr((dm, dm))
        self.setup_seconds["tobsr"] += _time.perf_counter() - _t
        li = 0
        while True:
            _t = _time.perf_counter()
            lmax = _lambda_max_dinv(A)
            self.setup_seconds["lmax"] += _time.perf_counter() - _t
            d = A.diagonal()
            inv_diag = np.where(d != 0.0, 1.0 / np.where(d != 0.0, d, 1.0), 0.0)
            blk = dm if li == 0 else B.shape[1]
            # every device array is staged as numpy here and uploaded
            # once at the end
            lv = {"n_dof": A.shape[0], "bs": blk, "lmax": lmax,
                  "inv_diag": inv_diag.astype(np_dtype)}
            if li > 0:
                _t = _time.perf_counter()
                ev, ec = _bsr_to_bell(A)
                self.setup_seconds["bell"] += _time.perf_counter() - _t
                lv["A"] = (ev.astype(np_dtype), ec)
            staged.append(lv)
            if A.shape[0] <= coarse_max_dof or li + 1 >= max_levels:
                break

            # --- coarsen: aggregate -> tentative -> smooth -> Galerkin -----
            # The fine level is unfiltered by default (theta=0; the
            # fine_graph shortcut then skips a pass over the fine entries);
            # fine_strength_theta > 0 filters it too, for graded meshes.
            # Coarse Galerkin graphs densify, so they get the strength
            # filter, halved until the coarsening ratio is >= 3x.
            t0 = _time.perf_counter()
            theta = strength_theta if li > 0 else float(fine_strength_theta)
            with span("femcy.setup.amg.aggregate"):
                agg = n_agg = None
                while True:
                    if li == 0 and fine_graph is not None and theta == 0.0:
                        G = fine_graph
                    else:
                        G = _node_graph_bsr(A, theta=theta)
                    agg, n_agg = _aggregate(G)
                    # an EXPLICIT fine filter accepts any non-degenerate
                    # coarsening; the adaptive halving otherwise keeps the
                    # ratio >= 3x to bound setup cost and operator complexity
                    accept = (0.6 if li == 0 and fine_strength_theta > 0.0
                              else 1 / 3.0)
                    if (n_agg * B.shape[1] <= accept * A.shape[0]
                            or theta == 0.0):
                        break
                    theta = theta / 2.0 if theta > 0.004 else 0.0
            self.setup_seconds["aggregate"] += _time.perf_counter() - t0
            if n_agg * B.shape[1] >= 0.6 * A.shape[0]:
                break  # coarsening ratio too poor to pay for another level
            logger.debug(
                "amg level %d: %d -> %d dofs (theta=%.3g, %.1fs aggregate)",
                li, A.shape[0], n_agg * B.shape[1], theta,
                _time.perf_counter() - t0,
            )
            _t = _time.perf_counter()
            # QR/rank guard in f64; the block data lands in the operator
            # dtype (a mixed-dtype scipy product would upcast everything)
            P0, Bc = _tentative_prolongator_bsr(agg, n_agg, B, blk, host_dtype)
            self.setup_seconds["qr"] += _time.perf_counter() - _t
            # one damped-Jacobi smoothing pass on the tentative basis:
            # P = P0 - (omega/lmax) D^-1 (A @ P0), the diagonal scaling
            # applied in place on the BSR block rows
            _t = _time.perf_counter()
            with span("femcy.setup.amg.smooth"):
                Z = A @ P0
                zrows = np.repeat(
                    np.arange(Z.shape[0] // blk, dtype=np.int64),
                    np.diff(Z.indptr),
                )
                scale = inv_diag.astype(host_dtype).reshape(-1, blk)[zrows]
                Z.data *= host_dtype.type(omega / lmax) * scale[:, :, None]
                P = P0 - Z
            self.setup_seconds["rap"] += _time.perf_counter() - _t
            _t = _time.perf_counter()
            pv, pc = _bsr_to_bell(P)
            R = P.transpose().tobsr(blocksize=(B.shape[1], blk))
            rv, rc = _bsr_to_bell(R)
            self.setup_seconds["bell"] += _time.perf_counter() - _t
            lv["P"] = (pv.astype(np_dtype), pc)
            lv["R"] = (rv.astype(np_dtype), rc)
            _t = _time.perf_counter()
            with span("femcy.setup.amg.galerkin"):
                A = _regularize_bsr(R @ (A @ P))
            self.setup_seconds["rap"] += _time.perf_counter() - _t
            B = Bc
            li += 1

        # coarsest: dense inverse, host LAPACK once.  The poor-coarsening
        # break above can exit BEFORE the coarse_max_dof check, so beyond
        # 4x coarse_max_dof the bottom of the V-cycle falls back to
        # Chebyshev smoothing only (still SPD, weaker but bounded cost)
        # instead of the inverse.
        self._coarse_smooth_only = A.shape[0] > 4 * coarse_max_dof
        if self._coarse_smooth_only:
            logger.warning(
                "amg: coarsest level stalled at %d dofs (> 4x "
                "coarse_max_dof=%d); using a smoother-only coarse solve "
                "instead of the dense inverse -- expect higher CG "
                "iteration counts",
                A.shape[0], coarse_max_dof,
            )
            coarse_inv = np.zeros((0, 0), dtype=np_dtype)
        else:
            _t = _time.perf_counter()
            # the inverse itself in f64 regardless of the hierarchy dtype
            A_dense = A.toarray().astype(np.float64)
            coarse_inv = np.linalg.inv(A_dense).astype(np_dtype)
            self.setup_seconds["coarse_inv"] += _time.perf_counter() - _t
        # a single-level hierarchy degenerates to "dense-solve the fine
        # operator": legal (coarse_max_dof guards the size)
        self._single = len(staged) == 1

        _t = _time.perf_counter()
        with span("femcy.setup.amg.upload"):
            self.levels: List[_AMGLevel] = _device_levels(staged, self.device)
            self._coarse_inv = torch.as_tensor(coarse_inv, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.setup_seconds["upload"] = _time.perf_counter() - _t
        self.setup_seconds["total"] = _time.perf_counter() - _t_total
        self.setup_seconds["other"] = self.setup_seconds["total"] - sum(
            v for k, v in self.setup_seconds.items()
            if k not in ("total", "other")
        )

    # ------------------------------------------------------------------ #
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def complexity(self) -> float:
        """Operator complexity: total stored level entries / fine entries
        (the fine nonzero count is recorded at build time)."""
        coarse = sum(
            float(lv.A.bvalues.numel()) if lv.A is not None else 0.0
            for lv in self.levels
        )
        return 1.0 + coarse / max(self._fine_nnz, 1.0)

    # ------------------------------------------------------------------ #
    def _apply(self, li: int, x, apply0):
        if li == 0:
            return apply0(x)
        return k_bell.spmv(self.levels[li].A, x)[: self.levels[li].n_dof]

    def _smooth_cheby(self, li: int, x, b, degree: int, apply0):
        """Chebyshev polynomial in D^-1 A on [lmax/alpha, lmax] (same
        recurrence as StructuredMultigrid._smooth_cheby).  The first step
        applies the operator to x even when x is the zero initial guess,
        as femcy_tpu does."""
        lmax = self.levels[li].lmax * 1.05
        lmin = lmax / self.cheby_alpha
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        minv = self.levels[li].inv_diag
        r = b - self._apply(li, x, apply0)
        d = (minv * r) / theta
        x = x + d
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = b - self._apply(li, x, apply0)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * (minv * r)
            x = x + d
            rho_old = rho
        return x

    def _vcycle(self, li: int, b, apply0=None):
        if li == len(self.levels) - 1:
            if self._coarse_smooth_only:
                # oversized coarsest: polynomial smoothing instead of the
                # dense inverse, degree 4x the per-level smoothing
                return self._smooth_cheby(
                    li, torch.zeros_like(b), b, 4 * self.smooth_steps, apply0,
                )
            return self._coarse_inv @ b
        lv = self.levels[li]
        x = self._smooth_cheby(
            li, torch.zeros_like(b), b, self.smooth_steps, apply0
        )
        r = b - self._apply(li, x, apply0)
        rc = k_bell.spmv(lv.R, r)[: self.levels[li + 1].n_dof]
        ec = self._vcycle(li + 1, rc)
        e = k_bell.spmv(lv.P, ec)
        x = x + e[: lv.n_dof]
        return self._smooth_cheby(li, x, b, self.smooth_steps, apply0)

    def precondition(self, r, apply0=None):
        """One V-cycle M^-1 r.  ``apply0`` applies the FINE operator (the
        caller's exact current operator); required unless the hierarchy is
        a single level with a dense inverse."""
        if self._single:
            if self._coarse_smooth_only:
                if apply0 is None:
                    raise ValueError(
                        "AMG precondition needs the fine-operator apply"
                    )
                return self._smooth_cheby(
                    0, torch.zeros_like(r), r, 4 * self.smooth_steps, apply0,
                )
            return self._coarse_inv @ r
        if apply0 is None:
            raise ValueError("AMG precondition needs the fine-operator apply")
        return self._vcycle(0, r, apply0)

    # ------------------------------------------------------------------ #
    def pcg_solve(self, b, apply0, eps: float = 1.0e-3, max_iters: int = 400):
        """PCG with the V-cycle preconditioner; ``apply0`` is the exact fine
        operator application.  femcy_tpu's convergence rule: iterate while
        ``k < max_iters`` and ||r||_inf >= eps ||r0||_inf, not at all when
        b = 0, with d0 = M^-1 r0.  Returns (x, iterations, max|r|)."""
        return pcg(apply0, lambda r: self.precondition(r, apply0), b, eps,
                   max_iters)
