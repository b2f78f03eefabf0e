"""The device's idle share in the traced stretch: 100 minus the union of
its operations' intervals over the stretch's wall (layer: device)."""

UNIT, LAYER = "%", "device"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
