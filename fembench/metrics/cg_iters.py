"""Mean PCG iterations a linear solve: the program's count of every CG
solve (``FEMSystem._cg_iters_log``) over the window (layer: linear
solve)."""

UNIT, LAYER = "count", "linear solve"


def read(run):
    s = [x for a in run.analyses for x in a.cg_iters]
    return sum(s) / len(s) if s else None
