"""The yardstick of one linear assembly of any solid element: the bytes
and operations of building the operator from the mesh and the rhs, counted
from the configuration's shapes whatever implements it.  General in the
element's node count n and its Gauss points G; ``roofline`` holds the
card's peaks and the C3D4 Newton evaluation's count."""

from __future__ import annotations

from fembench.harness.roofline import least_seconds, node_pairs


def element_flops(n: int, G: int) -> int:
    """Dense flops of one element's stiffness, 2 a multiply-add, at each of
    its G points: the Jacobian J = sum_a X_a (x) grad_xi N_a (3x3 from n
    nodal vectors), its inverse and determinant, the physical gradients
    grad_xi N J^-1 (n rows), C B (6x6 by 6x3n), B^T (C B) (3n x 6 by
    6x3n) and the scaling of the (3n)^2 entries by the point's volume."""
    m = 3 * n
    per_point = (
        2 * 9 * n  # J
        + 2 * 27 + 9  # inverse and determinant
        + 2 * 9 * n  # grad N = grad_xi N J^-1
        + 2 * 6 * 6 * m  # C B
        + 2 * m * 6 * m  # B^T (C B)
        + m * m  # times vol
    )
    return G * per_point


def assembly_work(n_nodes: int, elements, G: int, nnz: int, itemsize: int):
    """(bytes, flops) of one assembly: read the nodes, the 4-byte
    connectivity and the rhs once; write the operator's true nonzeros and
    the rhs once; ``element_flops`` an element.  ``elements`` is (E, n)."""
    E, n = elements.shape
    n_dof = 3 * n_nodes
    read = n_nodes * 3 * itemsize + E * n * 4 + n_dof * itemsize
    write = nnz * itemsize + n_dof * itemsize
    return read + write, E * element_flops(n, G)


#: Gauss points of the elements the configurations use, by node count
GAUSS_POINTS = {4: 1, 20: 27}


def assembly_least_seconds(run):
    """The least time the card of ``run`` (a ``bench.Record``) needs for
    one assembly of its mesh, or None for a card or element the tables
    lack."""
    nodes, elements = run.mesh.nodes, run.mesh.elements
    G = GAUSS_POINTS.get(elements.shape[1])
    if G is None:
        return None
    pairs = node_pairs(elements, nodes.shape[0], run.torch, run.device)
    nbytes, flops = assembly_work(nodes.shape[0], elements, G, 9 * pairs,
                                  run.itemsize)
    return least_seconds(run.device_kind, run.itemsize, nbytes, flops)
