"""Mean wall of one linear solve (a PCG to cg_eps): the program's
synchronised "linear_solve" Timer section over the window (layer: linear
solve)."""

UNIT, LAYER = "ms", "linear solve"


def read(run):
    s = [x for a in run.analyses for x in a.spans.get("linear_solve", [])]
    return 1e3 * sum(s) / len(s) if s else None
