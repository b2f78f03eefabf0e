"""Device time of the Dirichlet elimination an analysis: the device
seconds of the operations launched inside the program's span
"femcy.dirichlet" in the traced stretch over the stretch's analyses
(layer: assembly + Dirichlet)."""

from fembench.harness import spans

UNIT, LAYER = "ms", "assembly + Dirichlet"


def read(run):
    got = spans.of(run, "femcy.dirichlet")
    return 1e3 * got.device_s / run.trace.analyses if got else None
