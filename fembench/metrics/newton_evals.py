"""Newton evaluations an analysis: the "newton_eval" Timer sections of the
window's analyses over their count (layer: analysis loop)."""

UNIT, LAYER = "count", "analysis loop"


def read(run):
    counts = [len(a.spans.get("newton_eval", [])) for a in run.analyses]
    if not any(counts):
        return None
    return sum(counts) / len(counts)
