"""The linear assembly's share of its roofline: the least time the card
needs for one assembly (``element_work.assembly_least_seconds``, counted
from the mesh's shapes: the nodes, connectivity and rhs read once, the
operator's nonzeros and the rhs written once, the dense element flops at
every Gauss point) over the device's busy time in one "assemble+bc" Timer
section of the traced stretch: the union of the card's operation
intervals inside those sections over their count (layer: assembly +
Dirichlet)."""

from fembench.harness import element_work

UNIT, LAYER = "%", "assembly + Dirichlet"


def read(run):
    got = run.trace.sections.get("assemble+bc") if run.trace else None
    if not got or got[1] <= 0:
        return None
    count, busy_s = got
    least = element_work.assembly_least_seconds(run)
    if least is None:
        return None
    return 100.0 * least / (busy_s / count)
