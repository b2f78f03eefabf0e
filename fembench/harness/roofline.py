"""The yardstick of the roofline shares: the card's peaks, and the bytes
and operations that a layer's work needs, counted from the
configuration's shapes whatever implements it.  Each input byte is
counted read once and each output byte written once."""

from __future__ import annotations

#: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense rates at the
#: full 700 W: HBM bandwidth; float64 on the tensor cores (the fastest
#: float64 path the card has, so a least time from it is a true bound;
#: 34 TFLOP/s outside them); float32 outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "flops_per_s": {8: 67e12, 4: 67e12}},
}

#: flops of one C3D4 element (one integration point) in a Newton
#: evaluation, each dense product counted as 2 flops a multiply-add:
#: kinematics (H from 4 nodal vectors, current gradients: edge matrix,
#: its inverse and determinant), the stress (F^T F, the isotropic law,
#: F S F^T / det F), the nodal force (vol sigma grad N, 4 nodes), the
#: material tangent B^T C B vol (C B: 6x6x12, B^T (C B): 12x6x12) and the
#: geometric tangent (grad N_a . sigma grad N_b for 16 node pairs, put
#: on the 3x3 diagonal of each block)
C3D4_EVAL_FLOPS = (
    2 * 4 * 9  # H = sum_a u_a (x) grad N_a
    + 9 + 2 * 27 + 9 + 2 * 4 * 9  # edges, inverse, det, current gradients
    + 2 * 27 + 9 + 2 * 6 * 6 + 2 * 2 * 27 + 10  # F^T F, E, S, F S F^T / J
    + 2 * 4 * 9 + 4 * 3  # the nodal force
    + 2 * 6 * 6 * 12 + 2 * 12 * 6 * 12 + 144  # B^T C B vol
    + 2 * 4 * 9 + 2 * 16 * 3 + 16 * 4  # grad N . sigma grad N, on 3 diagonals
)


def node_pairs(elements, n_nodes: int, torch, device) -> int:
    """Distinct (row node, column node) pairs that share an element, the
    diagonal included: the node blocks of the assembled operator."""
    e = torch.as_tensor(elements, dtype=torch.int64, device=device)
    npe = e.shape[1]
    a = e[:, :, None].expand(-1, npe, npe).reshape(-1)
    b = e[:, None, :].expand(-1, npe, npe).reshape(-1)
    return int(torch.unique(a * n_nodes + b).numel())


def spmv_bytes(n_rows: int, nnz: int, itemsize: int) -> int:
    """One sparse matrix-vector product: each nonzero's value and its 4-byte
    column index, a 4-byte count and x read and y written per row."""
    return nnz * (itemsize + 4) + n_rows * (4 + 2 * itemsize)


def newton_eval_work(n_nodes: int, n_elements: int, npe: int, nnz: int,
                     itemsize: int):
    """(bytes, flops) of one Newton evaluation of a C3D4 model: read the
    nodes, the 4-byte connectivity and the displacement once; write the
    tangent's nonzeros and the residual once; ``C3D4_EVAL_FLOPS`` an
    element."""
    n_dof = 3 * n_nodes
    read = n_nodes * 3 * itemsize + n_elements * npe * 4 + n_dof * itemsize
    write = nnz * itemsize + n_dof * itemsize
    return read + write, n_elements * C3D4_EVAL_FLOPS


def least_seconds(kind: str, itemsize: int, nbytes: float, flops: float):
    """The least time the card ``kind`` needs to move ``nbytes`` and do
    ``flops``, or None for a card the table lacks."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(nbytes / peak["bytes_per_s"],
               flops / peak["flops_per_s"][itemsize])

