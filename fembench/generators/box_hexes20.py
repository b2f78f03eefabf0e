"""``box_hexes20(nx, ny, nz)``: C3D20 quadratic bricks of the unit box,
nx * ny * nz cells, the corner grid followed by one node on the middle of
each cell edge (the x-, y- and z-edges in turn), each brick in Abaqus
C3D20 node order: corners 1-8, then the midpoints of edges 1-2, 2-3, 3-4,
4-1, 5-6, 6-7, 7-8, 8-5, 1-5, 2-6, 3-7, 4-8.  No structure metadata, so
the program takes its general path.  A frozen copy of the port's
``meshgen.box_hexes20`` (a CPU test holds it equal).  numpy only."""

from __future__ import annotations

import numpy as np

from fembench.harness.meshes import Mesh


def build(nx: int, ny: int, nz: int) -> Mesh:
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    zs = np.linspace(0.0, 1.0, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    corners = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    n_c = corners.shape[0]

    xm = (xs[:-1] + xs[1:]) / 2.0
    ym = (ys[:-1] + ys[1:]) / 2.0
    zm = (zs[:-1] + zs[1:]) / 2.0
    ex = np.stack(np.meshgrid(xm, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    ey = np.stack(np.meshgrid(xs, ym, zs, indexing="ij"), -1).reshape(-1, 3)
    ez = np.stack(np.meshgrid(xs, ys, zm, indexing="ij"), -1).reshape(-1, 3)
    nodes = np.concatenate([corners, ex, ey, ez])
    n_ex, n_ey = ex.shape[0], ey.shape[0]

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    def xid(i, j, k):  # the midpoint of the x-edge starting at (i, j, k)
        return n_c + (i * (ny + 1) + j) * (nz + 1) + k

    def yid(i, j, k):
        return n_c + n_ex + (i * ny + j) * (nz + 1) + k

    def zid(i, j, k):
        return n_c + n_ex + n_ey + (i * (ny + 1) + j) * nz + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    bricks = np.stack([
        nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k), nid(i, j + 1, k),
        nid(i, j, k + 1), nid(i + 1, j, k + 1),
        nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
        xid(i, j, k), yid(i + 1, j, k), xid(i, j + 1, k), yid(i, j, k),
        xid(i, j, k + 1), yid(i + 1, j, k + 1),
        xid(i, j + 1, k + 1), yid(i, j, k + 1),
        zid(i, j, k), zid(i + 1, j, k), zid(i + 1, j + 1, k), zid(i, j + 1, k),
    ], axis=-1).reshape(-1, 20)
    return Mesh(nodes, bricks.astype(np.int32), None)
