"""Structured mesh generators (host, numpy) for benchmarks and tests.

The reference has no mesh generator -- every model comes from an ``.inp``
file.  Benchmarks at the 1M-element scale need synthetic meshes, so these
build structured triangle/quad/tet grids with the element node orderings of
elements/library.py.

Host copy of ``femcy_tpu.meshgen`` (pure numpy): the port owns it so that
importing it never imports JAX.  tests/test_torch_host.py diffs its
output against the reference module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from femcy_tpu_torch.elements import HEX8, HEX20, QUAD4, TET4, TRI3, WEDGE6
from femcy_tpu_torch.mesh import FEMesh


def rect_quads(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0) -> FEMesh:
    """Structured quad4 mesh of [0,lx] x [0,ly]."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    nodes = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    a = j * (nx + 1) + i
    quads = np.stack([a, a + 1, a + nx + 2, a + nx + 1], axis=-1).reshape(-1, 4)
    return FEMesh(nodes, quads.astype(np.int32), QUAD4)


def rect_tris(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0) -> FEMesh:
    """Structured tri3 mesh of [0,lx] x [0,ly] (2 triangles per cell)."""
    quad_mesh = rect_quads(nx, ny, lx, ly)
    q = quad_mesh.elements
    tris = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], axis=0)
    return FEMesh(quad_mesh.nodes, tris.astype(np.int32), TRI3)


def box_tets(
    nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
) -> FEMesh:
    """Structured tet4 mesh of a box: 6 tets per hex cell (Kuhn subdivision,
    conforming across cells)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    c = [
        nid(i, j, k),
        nid(i + 1, j, k),
        nid(i, j + 1, k),
        nid(i + 1, j + 1, k),
        nid(i, j, k + 1),
        nid(i + 1, j, k + 1),
        nid(i, j + 1, k + 1),
        nid(i + 1, j + 1, k + 1),
    ]
    # Kuhn triangulation along the main diagonal c0-c7: 6 conforming tets
    kuhn = [
        (0, 1, 3, 7),
        (0, 1, 7, 5),
        (0, 5, 7, 4),
        (0, 4, 7, 6),
        (0, 6, 7, 2),
        (0, 2, 7, 3),
    ]
    tets = np.stack(
        [np.stack([c[a], c[b], c[d], c[e]], axis=-1) for a, b, d, e in kuhn],
        axis=-2,
    ).reshape(-1, 4)
    return FEMesh(
        nodes,
        tets.astype(np.int32),
        TET4,
        structure={
            "kind": "box_tets",
            "nx": nx,
            "ny": ny,
            "nz": nz,
            "corner_delta": [
                [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                 (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)][idx]
                for idx in range(8)
            ],
            "kuhn": kuhn,
        },
    )


def box_hexes(
    nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
) -> FEMesh:
    """Structured hex8 mesh of a box (Abaqus C3D8 node order per cell)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    hexes = np.stack(
        [
            nid(i, j, k),
            nid(i + 1, j, k),
            nid(i + 1, j + 1, k),
            nid(i, j + 1, k),
            nid(i, j, k + 1),
            nid(i + 1, j, k + 1),
            nid(i + 1, j + 1, k + 1),
            nid(i, j + 1, k + 1),
        ],
        axis=-1,
    ).reshape(-1, 8)
    return FEMesh(nodes, hexes.astype(np.int32), HEX8)


def box_hexes20(
    nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
) -> FEMesh:
    """Structured hex20 (C3D20) mesh of a box: corner grid plus unique
    mid-edge nodes, Abaqus C3D20 node order per cell."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
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

    def xid(i, j, k):  # midpoint of the x-edge starting at (i, j, k)
        return n_c + (i * (ny + 1) + j) * (nz + 1) + k

    def yid(i, j, k):
        return n_c + n_ex + (i * ny + j) * (nz + 1) + k

    def zid(i, j, k):
        return n_c + n_ex + n_ey + (i * (ny + 1) + j) * nz + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    hexes = np.stack(
        [
            nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k), nid(i, j + 1, k),
            nid(i, j, k + 1), nid(i + 1, j, k + 1),
            nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
            xid(i, j, k), yid(i + 1, j, k), xid(i, j + 1, k), yid(i, j, k),
            xid(i, j, k + 1), yid(i + 1, j, k + 1),
            xid(i, j + 1, k + 1), yid(i, j, k + 1),
            zid(i, j, k), zid(i + 1, j, k), zid(i + 1, j + 1, k), zid(i, j + 1, k),
        ],
        axis=-1,
    ).reshape(-1, 20)
    return FEMesh(nodes, hexes.astype(np.int32), HEX20)


def box_wedges(
    nx: int, ny: int, nz: int, lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
) -> FEMesh:
    """Structured wedge6 (C3D6) mesh of a box: each cell split into two
    z-axis prisms along the xy diagonal (Abaqus C3D6 node order)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    # bottom triangles (r axis = z): (i,j) (i+1,j) (i,j+1) and the mirror
    w1 = np.stack(
        [
            nid(i, j, k), nid(i + 1, j, k), nid(i, j + 1, k),
            nid(i, j, k + 1), nid(i + 1, j, k + 1), nid(i, j + 1, k + 1),
        ],
        axis=-1,
    ).reshape(-1, 6)
    w2 = np.stack(
        [
            nid(i + 1, j + 1, k), nid(i, j + 1, k), nid(i + 1, j, k),
            nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1), nid(i + 1, j, k + 1),
        ],
        axis=-1,
    ).reshape(-1, 6)
    wedges = np.concatenate([w1, w2], axis=0)
    return FEMesh(nodes, wedges.astype(np.int32), WEDGE6)


def unstructured_box_tets(
    nx: int,
    ny: int = 0,
    nz: int = 0,
    seed: int = 0,
    jitter: float = 0.2,
) -> FEMesh:
    """A genuinely UNSTRUCTURED tet4 box: box_tets topology with randomized
    node numbering and jittered interior coordinates.

    No ``structure`` metadata is attached, so FEMSystem routes it through
    the general ELL path -- the same code every real .inp mesh exercises
    (irregular numbering defeats the DIA offset detection; the jitter makes
    element geometry non-uniform).  Used by the large-unstructured bench
    metric and the AMG tests; ``jitter`` is the interior displacement as a
    fraction of the cell size (< 0.5 keeps all tets positive-volume).
    """
    ny = ny or nx
    nz = nz or nx
    m0 = box_tets(nx, ny, nz)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m0.n_nodes)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(m0.n_nodes)
    nodes = m0.nodes[perm].copy()
    h = np.array([1.0 / nx, 1.0 / ny, 1.0 / nz])
    interior = (nodes > 1e-9) & (nodes < 1.0 - 1e-9)
    nodes += interior * (rng.uniform(-jitter, jitter, nodes.shape) * h)
    return FEMesh(nodes, iperm[m0.elements], m0.element)


def graded_box_tets(
    nx: int,
    ratio: float = 12.0,
    ny: int = 0,
    nz: int = 0,
    seed: int = 0,
    jitter: float = 0.2,
) -> FEMesh:
    """A genuinely GRADED unstructured tet4 box: geometric element-size
    gradation of ``ratio`` : 1 along every axis (smallest cells at the
    origin corner, largest at the far corner), plus the
    ``unstructured_box_tets`` randomization (shuffled node numbering +
    interior jitter scaled by the LOCAL cell size).

    This is the SA-AMG stress case the uniform jittered box cannot produce:
    aggregation quality and the strength-of-connection filter
    (solvers/amg.py) are exercised by strongly varying row scales, not by
    uniform stencils.  Per axis with n cells the map
    x -> (g**x - 1)/(g - 1) with g = ratio**(n/(n-1)) yields an exact
    largest/smallest cell ratio of ``ratio``; the diagonal size gradation
    across the domain is therefore ``ratio`` as well.  Jitter displaces
    interior nodes by < jitter * (local spacing), preserving positive
    volumes for jitter < 0.5 exactly as in the uniform generator.
    """
    ny = ny or nx
    nz = nz or nx
    m0 = box_tets(nx, ny, nz)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m0.n_nodes)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(m0.n_nodes)
    nodes = m0.nodes[perm].copy()
    interior = (nodes > 1e-9) & (nodes < 1.0 - 1e-9)
    h_local = np.empty_like(nodes)
    for ax, n in ((0, nx), (1, ny), (2, nz)):
        g = float(ratio) ** (n / (n - 1.0)) if n > 1 else 1.0 + 1e-12
        x = nodes[:, ax]
        nodes[:, ax] = (g**x - 1.0) / (g - 1.0)
        # local spacing of the mapped grid at this node: d(x')/dx / n,
        # expressed in mapped coordinates (g**x = x'(g-1) + 1)
        h_local[:, ax] = (
            np.log(g) * (nodes[:, ax] * (g - 1.0) + 1.0) / ((g - 1.0) * n)
        )
    nodes += interior * (rng.uniform(-jitter, jitter, nodes.shape) * h_local)
    return FEMesh(nodes, iperm[m0.elements], m0.element)


def cantilever_tets(
    n_long: int, n_thick: int, length: float = 10.0, thickness: float = 1.0
) -> Tuple[FEMesh, np.ndarray, np.ndarray]:
    """A cantilever-beam tet mesh plus (fixed-end node ids, loaded-end node ids).

    Canonical benchmark body: fixed at x=0, loaded at x=length.
    """
    mesh = box_tets(n_long, n_thick, n_thick, length, thickness, thickness)
    fixed = np.nonzero(mesh.nodes[:, 0] < 1e-12)[0]
    loaded = np.nonzero(mesh.nodes[:, 0] > length - 1e-12)[0]
    return mesh, fixed, loaded
