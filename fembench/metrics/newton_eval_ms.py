"""Mean wall of one Newton evaluation: the program's synchronised
"newton_eval" Timer section over the window (layer: Newton evaluation)."""

UNIT, LAYER = "ms", "Newton evaluation"


def read(run):
    s = [x for a in run.analyses for x in a.spans.get("newton_eval", [])]
    return 1e3 * sum(s) / len(s) if s else None
