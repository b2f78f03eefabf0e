"""The 95th percentile of the walls of all the window's analyses, in a
cell whose tail swings too much from run to run to carry a bound
(layer: analysis loop)."""

from fembench.harness import stats

UNIT, LAYER = "s", "analysis loop"


def read(run):
    walls = [a.wall_s for a in run.analyses]
    return stats.percentile(walls, 95) if walls else None
