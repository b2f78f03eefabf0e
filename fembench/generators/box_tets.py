"""``box_tets(nx, ny, nz)``: C3D4 tets of the unit box, nx * ny * nz hex
cells of 6 Kuhn tets each, with the structured-grid metadata that the
program's box path reads.  A frozen copy of the port's ``meshgen.box_tets``
(a CPU test holds it equal), so a change to the program cannot move the
yardstick.  numpy only."""

from __future__ import annotations

import numpy as np

from fembench.harness.meshes import Mesh

#: Kuhn subdivision of a hex cell along its diagonal c0-c7: 6 conforming
#: tets, in the corner numbering of ``CORNER_DELTA``
KUHN = [(0, 1, 3, 7), (0, 1, 7, 5), (0, 5, 7, 4), (0, 4, 7, 6),
        (0, 6, 7, 2), (0, 2, 7, 3)]
CORNER_DELTA = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]


def build(nx: int, ny: int, nz: int) -> Mesh:
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    zs = np.linspace(0.0, 1.0, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    c = [nid(i + di, j + dj, k + dk) for di, dj, dk in CORNER_DELTA]
    tets = np.stack(
        [np.stack([c[a], c[b], c[d], c[e]], axis=-1) for a, b, d, e in KUHN],
        axis=-2,
    ).reshape(-1, 4)
    structure = {"kind": "box_tets", "nx": nx, "ny": ny, "nz": nz,
                 "corner_delta": list(CORNER_DELTA), "kuhn": list(KUHN)}
    return Mesh(np.ascontiguousarray(nodes, dtype=np.float64),
                tets.astype(np.int32), structure)
