"""Mean wall of the linear path's assembly and Dirichlet elimination: the
program's synchronised "assemble+bc" Timer section over the window
(layer: assembly + Dirichlet)."""

UNIT, LAYER = "ms", "assembly + Dirichlet"


def read(run):
    s = [x for a in run.analyses for x in a.spans.get("assemble+bc", [])]
    return 1e3 * sum(s) / len(s) if s else None
