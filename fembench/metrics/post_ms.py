"""Mean wall of the stress recovery (strain, stress and Mises of every
element): the benchmark's own synchronised span around
``compute_strain_stress`` over the window (layer: post-processing)."""

UNIT, LAYER = "ms", "post-processing"


def read(run):
    s = [a.post_s for a in run.analyses]
    return 1e3 * sum(s) / len(s) if s else None
