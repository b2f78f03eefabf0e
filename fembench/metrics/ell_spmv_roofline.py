"""M2's share of its roofline: the least time of one ELL product of the
fine operator (``roofline.spmv_bytes`` of the mesh's node pairs, 9
nonzeros each, at the card's bandwidth) over M2's mean device time in the
traced stretch, by its kernel name (layer: kernels)."""

from fembench.harness import roofline

UNIT, LAYER = "%", "kernels"
KERNEL = "ell_spmv_kernel"


def read(run):
    got = run.trace.kernel(KERNEL) if run.trace is not None else None
    if got is None:
        return None
    seconds, launches = got
    nodes, elements = run.mesh.nodes, run.mesh.elements
    pairs = roofline.node_pairs(elements, nodes.shape[0], run.torch,
                                run.device)
    nbytes = roofline.spmv_bytes(3 * nodes.shape[0], 9 * pairs, run.itemsize)
    least = roofline.least_seconds(run.device_kind, run.itemsize, nbytes, 0.0)
    if least is None:
        return None
    return 100.0 * least / (seconds / launches)
