"""``unstructured_box_tets(nx, seed, jitter)``: the ``box_tets(nx, nx, nx)``
topology with its nodes renumbered at random and its interior nodes moved
by up to ``jitter`` of a cell, from ``seed``; no structure metadata, so
the program takes its general path.  A frozen copy of the port's
``meshgen.unstructured_box_tets`` (a CPU test holds it equal).  numpy
only."""

from __future__ import annotations

import numpy as np

from fembench.harness import named
from fembench.harness.meshes import Mesh


def build(nx: int, seed: int = 0, jitter: float = 0.2) -> Mesh:
    m0 = named.module("generators", "box_tets").build(nx, nx, nx)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m0.nodes.shape[0])
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(m0.nodes.shape[0])
    nodes = m0.nodes[perm].copy()
    h = np.array([1.0 / nx] * 3)
    interior = (nodes > 1e-9) & (nodes < 1.0 - 1e-9)
    nodes += interior * (rng.uniform(-jitter, jitter, nodes.shape) * h)
    return Mesh(nodes, iperm[m0.elements].astype(np.int32), None)
