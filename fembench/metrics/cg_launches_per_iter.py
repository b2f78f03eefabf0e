"""Device operations one PCG iteration launches: the operations launched
inside the program's span "femcy.pcg.iter" (the iteration with its
preconditioner and its stopping test) in the traced stretch over that
span's count (layer: linear solve)."""

from fembench.harness import spans

UNIT, LAYER = "count", "linear solve"


def read(run):
    got = spans.of(run, "femcy.pcg.iter")
    return got.ops / got.count if got else None
