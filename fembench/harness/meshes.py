"""The configurations' meshes.  A configuration's ``mesh`` entry names a
generator, ``fembench/generators/<generator>.py``, whose ``build`` takes
the entry's other keys.  The benchmark builds the arrays once and hands
the same arrays to the program and to the reference."""

from __future__ import annotations

import pathlib
from typing import NamedTuple, Optional

import numpy as np

from fembench.harness import named


class Mesh(NamedTuple):
    nodes: np.ndarray  # (N, 3) float64
    elements: np.ndarray  # (E, npe) int32, the element's node order
    #: the structured-grid metadata the program's box path reads, or None
    structure: Optional[dict]


def build(spec: dict, root: pathlib.Path = named.ROOT) -> Mesh:
    """The mesh a configuration's ``mesh`` entry names."""
    kwargs = {k: v for k, v in spec.items() if k != "generator"}
    return named.module("generators", spec["generator"], root).build(**kwargs)


def faces(nodes: np.ndarray, tol: float = 1e-9):
    """(bottom, top): node ids on the z=0 and z=1 faces of the unit box."""
    z = nodes[:, 2]
    return np.nonzero(z < tol)[0], np.nonzero(z > 1.0 - tol)[0]
