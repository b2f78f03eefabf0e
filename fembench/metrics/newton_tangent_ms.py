"""Device time of one Newton evaluation's element tangent (Ke, + Kg): the
device seconds of the operations launched inside the program's span
"femcy.newton.tangent" in the traced stretch over that span's count
(layer: Newton evaluation)."""

from fembench.harness import spans

UNIT, LAYER = "ms", "Newton evaluation"


def read(run):
    got = spans.of(run, "femcy.newton.tangent")
    return 1e3 * got.device_s / got.count if got else None
