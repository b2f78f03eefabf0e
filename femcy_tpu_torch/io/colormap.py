"""The reference's seven selectable color ramps (colorBar.py:11-101).

The reference's ``getColor(x, mod)`` maps a normalized scalar to RGB through
one of 7 piecewise-linear ramps (its published result images use mod=4, the
4-interval rainbow).  Every ramp is linear interpolation between a small set
of anchor colors, so the whole zoo reduces to one anchor table + np.interp —
vectorized for whole fields instead of the reference's per-pixel calls.

``femcy_colormap(mod)`` wraps a ramp as a matplotlib colormap; the names
``femcy1`` .. ``femcy7`` are accepted anywhere a colormap name is
(``--cmap femcy4`` on the CLI, ``export_png(..., cmap=...)``), making the
exact published ramps reproducible alongside matplotlib's own maps.

Host copy of ``femcy_tpu.io.colormap`` (pure numpy; matplotlib is
imported only by ``femcy_colormap``).
"""

from __future__ import annotations

import warnings

import numpy as np

#: mod -> (anchor positions, anchor RGB rows).  Semantics match
#: the reference's colorBar.py:22-97 case1..case7 exactly (each case is
#: channel-wise linear between these anchors; tests/test_torch_cli.py holds
#: them to femcy_tpu's table).
_RAMPS = {
    # red <- green <- blue
    1: ([0.0, 0.5, 1.0], [(0, 0, 1), (0, 1, 0), (1, 0, 0)]),
    # red <- bright green <- blue (smoother)
    2: ([0.0, 0.5, 1.0], [(0, 0, 1), (0.5, 1, 0.5), (1, 0, 0)]),
    # red <- white <- blue
    3: ([0.0, 0.5, 1.0], [(0, 0, 1), (1, 1, 1), (1, 0, 0)]),
    # 4-interval rainbow: red ~ yellow ~ green ~ cyan ~ blue (the default)
    4: (
        [0.0, 0.25, 0.5, 0.75, 1.0],
        [(0, 0, 1), (0, 1, 1), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
    ),
    # red <- purple <- blue (fully smooth)
    5: ([0.0, 1.0], [(0, 0, 1), (1, 0, 0)]),
    # red <- black <- blue
    6: ([0.0, 0.5, 1.0], [(0, 0, 1), (0, 0, 0), (1, 0, 0)]),
    # red <- grey <- blue
    7: ([0.0, 0.5, 1.0], [(0, 0, 1), (0.5, 0.5, 0.5), (1, 0, 0)]),
}

#: out-of-range colors and tolerance (colorBar.py:12-21)
_DELTA = 1.0e-3
_OVER = (0.5, 0.5, 0.5)
_UNDER = (0.2, 0.2, 0.2)


def ramp(x, mod: int = 4) -> np.ndarray:
    """Vectorized ramp evaluation: x (any shape, in [0, 1]) -> RGB (..., 3).

    In-range values only — use :func:`get_color` for the reference's
    out-of-range clamp-and-warn behavior.
    """
    if mod not in _RAMPS:
        raise ValueError(f"unknown color ramp mod={mod} (valid: 1..7)")
    pos, colors = _RAMPS[mod]
    x = np.asarray(x, dtype=float)
    rgb = np.stack(
        [np.interp(x, pos, [c[ch] for c in colors]) for ch in range(3)],
        axis=-1,
    )
    return rgb


def get_color(x: float, mod: int = 4):
    """Scalar API with the reference's exact out-of-range semantics
    (colorBar.py:12-21): >1+1e-3 -> mid-grey + warning, <-1e-3 -> dark grey
    + warning, else the ramp."""
    if x > 1.0 + _DELTA:
        warnings.warn("colorBar x > 1.")
        return _OVER
    if x < 0.0 - _DELTA:
        warnings.warn("colorBar x < 0.")
        return _UNDER
    r, g, b = ramp(np.clip(x, 0.0, 1.0), mod)
    return float(r), float(g), float(b)


def femcy_colormap(mod: int = 4, n: int = 256):
    """The ramp as a matplotlib ``Colormap`` (name ``femcy<mod>``)."""
    from matplotlib.colors import ListedColormap

    xs = np.linspace(0.0, 1.0, n)
    return ListedColormap(ramp(xs, mod), name=f"femcy{mod}")


def resolve_cmap(name):
    """Colormap-name resolution accepting both matplotlib names and the
    reference ramps ``femcy1`` .. ``femcy7``.  Non-string inputs (already a
    Colormap) pass through."""
    if isinstance(name, str) and name.startswith("femcy"):
        suffix = name[len("femcy"):]
        if suffix.isdigit():
            return femcy_colormap(int(suffix))
    return name
