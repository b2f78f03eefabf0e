"""Fixed-topology sparse pattern (padded ELL) + scatter maps, built once on
the host.

Host copy of ``femcy_tpu.topology`` (numpy; the dof-level scatter map is
``assembly.expand_block_targets`` on CPU tensors).  The reference stores the
stiffness matrix in a padded row-major format and, on every scatter,
linearly searches the row's column list for the target slot with atomics
(stiffnessMtrx.py:79-94, 161-216, 414-420).  Here the (element, a, b) ->
ELL slot map is precomputed once, so the device assembly is one
deterministic scatter with no search (kernels/ell_scatter.py on CUDA); this
also subsumes the ``check_sparseIJ`` duplicate validation the reference
never calls (stiffnessMtrx.py:423-433).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from femcy_tpu_torch.assembly import expand_block_targets
from femcy_tpu_torch.mesh import FEMesh


@dataclasses.dataclass(frozen=True)
class ELLPattern:
    """Static sparsity of the global stiffness matrix.

    values array shape: ``(n_dof, width)`` with ``colidx`` giving the global
    column of each slot; padding slots point at column 0 and always hold 0.
    """

    n_dof: int
    width: int
    #: (n_dof, width) int32 column index per slot (padded with 0)
    colidx: np.ndarray
    #: (n_dof,) number of valid slots per row
    row_counts: np.ndarray
    #: (n_dof, width) bool validity mask
    valid: np.ndarray
    #: (n_dof,) flat index (into n_dof*width) of each row's diagonal slot
    diag_slot: np.ndarray
    #: (E*edof,) global dof of each force contribution, in element layout
    force_targets: np.ndarray
    #: (E, edof) global dof of each element dof (rows of the element matrix)
    element_dofs: np.ndarray
    # CSR mirror for the host direct solver (ref: scipy path,
    # stiffnessMtrx.py:98-107, 219-251)
    csr_indptr: np.ndarray
    csr_indices: np.ndarray
    #: flat ELL slots, in CSR order, to gather CSR data from the values array
    csr_slots: np.ndarray
    #: node-level ELL width (width == node_width * dm); 0 on custom
    #: patterns that carry no block map
    node_width: int = 0
    #: (E*npe*npe,) flat NODE-ELL slot (node*node_width + pos) of each
    #: node-pair contribution, element order -- the compact scatter map
    #: (dm^2 x smaller than the dof one)
    block_targets: "np.ndarray | None" = None
    #: (E*edof*edof,) flat dof-ELL slot of each element-stiffness
    #: contribution, Ke layout order; None until requested on the native
    #: route (607 MB at the 1M-element scale).  Use
    #: :meth:`ensure_scatter_targets`.
    scatter_targets: "np.ndarray | None" = None
    #: contribution indices in (row, col)-sorted order; None until requested
    sorted_perm: "np.ndarray | None" = None
    #: contributions per unique (row, col) entry, CSR order
    csr_counts: "np.ndarray | None" = None

    def ensure_scatter_targets(self) -> np.ndarray:
        """The dof-level scatter map, expanding ``block_targets`` on first
        use (consumers: the plain scatters of the tests, the host
        operator)."""
        if self.scatter_targets is None:
            if self.block_targets is None:
                raise ValueError(
                    "pattern has neither scatter_targets nor block_targets"
                )
            # infer dm and npe from the stored shapes
            dm = self.width // self.node_width
            npe2 = self.block_targets.shape[0] // self.element_dofs.shape[0]
            full = expand_block_targets(
                torch.from_numpy(self.block_targets), self.node_width, dm,
                self.width, int(round(npe2 ** 0.5))).numpy()
            dtype = np.int32 if self.n_dof * self.width < 2**31 else np.int64
            object.__setattr__(self, "scatter_targets", full.astype(dtype))
        return self.scatter_targets

    def ensure_sorted_scatter(self):
        """(sorted_perm, csr_counts), computing them on the numpy path."""
        if self.sorted_perm is None:
            perm = np.argsort(
                np.asarray(self.ensure_scatter_targets()), kind="stable"
            ).astype(np.int32)
            sorted_targets = np.asarray(self.scatter_targets)[perm]
            # counts per unique slot, CSR order (slots sorted = CSR order
            # within the flat padded space restricted to valid slots)
            _, counts = np.unique(sorted_targets, return_counts=True)
            order = np.argsort(self.csr_slots, kind="stable")
            csr_counts = np.zeros(self.nnz, dtype=np.int32)
            csr_counts[order] = counts.astype(np.int32)
            object.__setattr__(self, "sorted_perm", perm)
            object.__setattr__(self, "csr_counts", csr_counts)
        return self.sorted_perm, self.csr_counts

    @property
    def nnz(self) -> int:
        return int(self.csr_indices.shape[0])

    def to_scipy(self, values: np.ndarray):
        """ELL values (n_dof, width) -> scipy CSR.

        ``copy=True`` matters: the (data, indices, indptr) constructor is
        zero-copy, and scipy mutators (eliminate_zeros, sum_duplicates, ...)
        on the returned matrix would otherwise rewrite the PATTERN's own
        index arrays in place, corrupting every later conversion."""
        import scipy.sparse as sp

        data = np.asarray(values).reshape(-1)[self.csr_slots]
        return sp.csr_matrix(
            (data, self.csr_indices, self.csr_indptr),
            shape=(self.n_dof, self.n_dof),
            copy=True,
        )

    def validate(self) -> None:
        """Debug check: no duplicate columns within any row, diagonals
        present (the reference's never-called ``check_sparseIJ``,
        stiffnessMtrx.py:423-433); duplicates are impossible by
        construction, so this guards against bugs in the pattern code."""
        for r in range(self.n_dof):
            cols = self.colidx[r, : self.row_counts[r]]
            if np.unique(cols).shape[0] != cols.shape[0]:
                raise AssertionError(f"duplicate columns in row {r}")
            if r not in cols:
                raise AssertionError(f"row {r} is missing its diagonal")
        if not (self.colidx.reshape(-1)[self.diag_slot] == np.arange(self.n_dof)).all():
            raise AssertionError("diag_slot does not point at diagonals")

    def to_dense(self, values: np.ndarray) -> np.ndarray:
        dense = np.zeros((self.n_dof, self.n_dof))
        rows = np.repeat(np.arange(self.n_dof), np.diff(self.csr_indptr))
        dense[rows, self.csr_indices] = np.asarray(values).reshape(-1)[self.csr_slots]
        return dense


def colidx_valid_mask(colidx: np.ndarray, row_counts: np.ndarray) -> np.ndarray:
    return np.arange(colidx.shape[1])[None, :] < row_counts[:, None]


def build_pattern(mesh: FEMesh) -> ELLPattern:
    """Build the ELL pattern + scatter maps for a mesh.

    Uses the native C++ code (native/pattern.cpp) -- counting sort by
    row, O(contributions) -- unless FEMCY_TPU_NATIVE=0 or the mesh exceeds
    its int32 index space; otherwise the vectorised-numpy global-sort path.
    """
    dm = mesh.dm
    elements = mesh.elements.astype(np.int64)  # (E, n)
    n_ele, n_nodes_per = elements.shape
    edof = n_nodes_per * dm
    n_dof = mesh.n_dof

    # global dof of each element dof: (E, edof)
    element_dofs = (elements[:, :, None] * dm + np.arange(dm)).reshape(n_ele, edof)

    from femcy_tpu_torch.native.loader import build_pattern_native

    native = build_pattern_native(mesh.elements, dm, n_dof)
    if native is not None:
        (
            block_targets,
            node_width,
            colidx,
            row_counts,
            diag_slot,
            csr_indices,
            csr_slots,
            csr_indptr,
            width,
        ) = native
        return ELLPattern(
            n_dof=n_dof,
            width=width,
            colidx=colidx,
            row_counts=row_counts,
            valid=colidx_valid_mask(colidx, row_counts),
            diag_slot=diag_slot,
            node_width=node_width,
            block_targets=block_targets,
            force_targets=element_dofs.reshape(-1).astype(np.int32),
            element_dofs=element_dofs.astype(np.int32),
            csr_indptr=csr_indptr,
            csr_indices=csr_indices,
            csr_slots=csr_slots,
        )

    # every (row, col) pair an element stiffness touches: (E, edof, edof)
    rows = np.broadcast_to(element_dofs[:, :, None], (n_ele, edof, edof))
    cols = np.broadcast_to(element_dofs[:, None, :], (n_ele, edof, edof))
    keys = (rows * np.int64(n_dof) + cols).reshape(-1)

    uniq, inv = np.unique(keys, return_inverse=True)
    row_of = (uniq // n_dof).astype(np.int64)
    col_of = (uniq % n_dof).astype(np.int64)

    row_counts = np.bincount(row_of, minlength=n_dof)
    width = int(row_counts.max())
    row_start = np.zeros(n_dof + 1, dtype=np.int64)
    np.cumsum(row_counts, out=row_start[1:])
    # position of each unique entry within its row (uniq is (row, col) sorted)
    pos_in_row = np.arange(uniq.shape[0], dtype=np.int64) - row_start[row_of]

    colidx = np.zeros((n_dof, width), dtype=np.int32)
    valid = np.zeros((n_dof, width), dtype=bool)
    colidx[row_of, pos_in_row] = col_of
    valid[row_of, pos_in_row] = True

    slot_of_uniq = row_of * width + pos_in_row  # flat slot of each unique entry

    # diagonal slots
    diag_keys = np.arange(n_dof, dtype=np.int64) * n_dof + np.arange(n_dof)
    diag_idx = np.searchsorted(uniq, diag_keys)
    if not np.array_equal(uniq[diag_idx], diag_keys):
        raise RuntimeError("mesh has dofs without a diagonal entry")
    diag_slot = slot_of_uniq[diag_idx].astype(np.int64)

    # stiffness scatter map: contribution (in Ke layout order) -> flat slot
    targets = slot_of_uniq[inv]
    idx_dtype = np.int32 if targets.size and targets.max() < 2**31 else np.int64
    # node-block map derived from the (di=0, dj=0) subsample: dof slot
    # r*width + pos*dm + dj with r = n*dm + di -> node slot n*nwidth + pos
    node_width = width // dm
    t00 = targets.reshape(n_ele, edof, edof)[:, ::dm, ::dm]
    block_targets = (
        (t00 // np.int64(width) // dm) * node_width
        + (t00 % np.int64(width)) // dm
    ).reshape(-1)
    blk_dtype = (
        np.int32
        if (n_dof // dm) * node_width < np.iinfo(np.int32).max
        else np.int64
    )
    return ELLPattern(
        n_dof=n_dof,
        width=width,
        colidx=colidx,
        row_counts=row_counts.astype(np.int32),
        valid=valid,
        diag_slot=diag_slot,
        node_width=node_width,
        block_targets=block_targets.astype(blk_dtype),
        scatter_targets=targets.astype(idx_dtype),
        force_targets=element_dofs.reshape(-1).astype(np.int32),
        element_dofs=element_dofs.astype(np.int32),
        csr_indptr=row_start,
        csr_indices=col_of.astype(np.int32),
        csr_slots=slot_of_uniq,
    )
