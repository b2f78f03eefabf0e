"""The Newton evaluation's share of its roofline: the least time the card
needs for one evaluation's work (``roofline.newton_eval_work``, counted
from the mesh's shapes: the nodes, connectivity and displacement read
once, the tangent's nonzeros and the residual written once, the element
flops), over the device's busy time in one "newton_eval" Timer section
of the traced stretch: the union of the card's operation intervals
inside those sections over their count (layer: Newton evaluation)."""

from fembench.harness import roofline

UNIT, LAYER = "%", "Newton evaluation"


def read(run):
    got = run.trace.sections.get("newton_eval") if run.trace else None
    if not got or got[1] <= 0:
        return None
    count, busy_s = got
    nodes, elements = run.mesh.nodes, run.mesh.elements
    pairs = roofline.node_pairs(elements, nodes.shape[0], run.torch,
                                run.device)
    nbytes, flops = roofline.newton_eval_work(
        nodes.shape[0], elements.shape[0], elements.shape[1], 9 * pairs,
        run.itemsize)
    least = roofline.least_seconds(run.device_kind, run.itemsize, nbytes, flops)
    if least is None:
        return None
    return 100.0 * least / (busy_s / count)
