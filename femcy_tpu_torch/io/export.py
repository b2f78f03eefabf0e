"""Result export: deformed-mesh PNG (matplotlib) and legacy VTK.

The reference renders interactively with the Taichi GUI (body.py:49-162,
colorBar.py); on an accelerator host there is no display, so the
equivalents are file exporters reusing the same surface triangulation and
GP->node extrapolation.

Host copy of ``femcy_tpu.io.export``: every function takes numpy arrays
(the CLI brings the solution to the host once, after the solve), and
matplotlib is imported only inside the PNG functions, so the VTK route runs
on a machine without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from femcy_tpu_torch.mesh import FEMesh

#: VTK legacy cell type ids
_VTK_CELL = {
    "tri3": 5,
    "quad4": 9,
    "tet4": 10,
    "tri6": 22,
    "quad8": 23,
    "tet10": 24,
    "hex8": 12,
    "wedge6": 13,
    "hex20": 25,
}


def _patch_vertex_values(mesh: FEMesh, nodal_vals: np.ndarray):
    """(tri (T,3) node ids, per-corner values from the owner element's patch).

    Mirrors the reference's per-vertex coloring (body.py:256-262): each
    surface triangle reads its values from the patch (element) that owns it,
    so discontinuities between patches stay visible.
    """
    tris, owners = mesh.surface_triangles
    # local index of each triangle corner inside its owner element's
    # connectivity, fully vectorized (a per-triangle Python loop takes
    # minutes at the 1M-element scale on a weak host)
    conn = mesh.elements[owners]  # (T, npe)
    local = np.argmax(conn[:, :, None] == tris[:, None, :], axis=1)  # (T, 3)
    vals = np.asarray(nodal_vals)[owners[:, None], local]
    return tris, vals


def export_png(
    mesh: FEMesh,
    dof: np.ndarray,
    nodal_vals: np.ndarray,
    path: str,
    title: str = "",
    deform_scale: float = 1.0,
    cmap: str = "turbo",
):
    """Render the (deformed) surface mesh colored by a nodal field to PNG.

    nodal_vals: (E, n_nodes) patch-extrapolated values (see
    FEMSystem.extrapolate).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from femcy_tpu_torch.io.colormap import resolve_cmap

    cmap = resolve_cmap(cmap)
    dof = np.asarray(dof)
    coords = mesh.nodes + deform_scale * dof.reshape(-1, mesh.dm)
    tris, vals = _patch_vertex_values(mesh, np.asarray(nodal_vals))
    face_vals = vals.mean(axis=1)

    if mesh.dm == 2:
        fig, ax = plt.subplots(figsize=(7, 6))
        pc = ax.tripcolor(
            coords[:, 0],
            coords[:, 1],
            tris,
            facecolors=face_vals,
            cmap=cmap,
            edgecolors="none",
        )
        edges = mesh.surface_edges
        for a, b in edges:
            ax.plot(coords[[a, b], 0], coords[[a, b], 1], "k-", lw=0.2, alpha=0.4)
        ax.set_aspect("equal")
        fig.colorbar(pc, ax=ax)
    else:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        fig = plt.figure(figsize=(8, 7))
        ax = fig.add_subplot(projection="3d")
        polys = coords[tris]
        norm = plt.Normalize(face_vals.min(), face_vals.max() + 1e-30)
        colors = plt.get_cmap(cmap)(norm(face_vals))
        coll = Poly3DCollection(polys, facecolors=colors, edgecolors="k", linewidths=0.1)
        ax.add_collection3d(coll)
        lo, hi = coords.min(axis=0), coords.max(axis=0)
        c, r = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-30
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(c[2] - r, c[2] + r)
        fig.colorbar(plt.cm.ScalarMappable(norm=norm, cmap=cmap), ax=ax, shrink=0.6)
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def export_vtk(
    mesh: FEMesh,
    path: str,
    dof: Optional[np.ndarray] = None,
    point_data: Optional[dict] = None,
    cell_data: Optional[dict] = None,
):
    """Write a legacy-ASCII VTK unstructured grid (readable by ParaView).

    point_data: name -> (N,) or (N, k) arrays; cell_data: name -> (E,) arrays.
    """
    n, e = mesh.n_nodes, mesh.n_elements
    npe = mesh.element.n_nodes
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nfemcy_tpu export\nASCII\n")
        fh.write("DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {n} double\n")
        coords = np.zeros((n, 3))
        coords[:, : mesh.dm] = mesh.nodes
        for p in coords:
            fh.write(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        fh.write(f"CELLS {e} {e * (npe + 1)}\n")
        for conn in mesh.elements:
            fh.write(str(npe) + " " + " ".join(str(int(c)) for c in conn) + "\n")
        fh.write(f"CELL_TYPES {e}\n")
        ct = _VTK_CELL[mesh.element.name]
        fh.write("\n".join([str(ct)] * e) + "\n")

        pd = dict(point_data or {})
        if dof is not None:
            disp = np.zeros((n, 3))
            disp[:, : mesh.dm] = np.asarray(dof).reshape(-1, mesh.dm)
            pd["displacement"] = disp
        if pd:
            fh.write(f"POINT_DATA {n}\n")
            for name, arr in pd.items():
                arr = np.asarray(arr)
                if arr.ndim == 1:
                    fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    fh.write("\n".join(f"{v:.9g}" for v in arr) + "\n")
                else:
                    fh.write(f"VECTORS {name} double\n")
                    for v in arr:
                        fh.write(f"{v[0]:.9g} {v[1]:.9g} {v[2] if len(v) > 2 else 0.0:.9g}\n")
        if cell_data:
            fh.write(f"CELL_DATA {e}\n")
            for name, arr in cell_data.items():
                fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                fh.write("\n".join(f"{float(v):.9g}" for v in np.asarray(arr)) + "\n")
    return path


def export_vtk_blocks(
    nodes: np.ndarray,
    blocks,  # iterable of (elements (E_b, npe_b), element-type-name) pairs
    path: str,
    dof: Optional[np.ndarray] = None,
    point_data: Optional[dict] = None,
    cell_data: Optional[dict] = None,
):
    """Legacy-ASCII VTK for heterogeneous models: one unstructured grid
    with mixed CELL_TYPES (the multi-block twin of export_vtk; legacy VTK
    natively supports per-cell types).  cell_data arrays are ordered by
    block then element, matching ``np.concatenate`` over blocks.
    """
    nodes = np.asarray(nodes)
    n = nodes.shape[0]
    dm = nodes.shape[1]
    blocks = [(np.asarray(conn), name) for conn, name in blocks]
    e = sum(conn.shape[0] for conn, _ in blocks)
    size = sum(conn.shape[0] * (conn.shape[1] + 1) for conn, _ in blocks)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nfemcy_tpu export\nASCII\n")
        fh.write("DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {n} double\n")
        coords = np.zeros((n, 3))
        coords[:, :dm] = nodes
        for p in coords:
            fh.write(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        fh.write(f"CELLS {e} {size}\n")
        for conn, _ in blocks:
            npe = conn.shape[1]
            for row in conn:
                fh.write(str(npe) + " " + " ".join(str(int(c)) for c in row) + "\n")
        fh.write(f"CELL_TYPES {e}\n")
        for conn, name in blocks:
            ct = _VTK_CELL[name]
            fh.write("\n".join([str(ct)] * conn.shape[0]) + "\n")

        pd = dict(point_data or {})
        if dof is not None:
            disp = np.zeros((n, 3))
            disp[:, :dm] = np.asarray(dof).reshape(-1, dm)
            pd["displacement"] = disp
        if pd:
            fh.write(f"POINT_DATA {n}\n")
            for name, arr in pd.items():
                arr = np.asarray(arr)
                if arr.ndim == 1:
                    fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    fh.write("\n".join(f"{v:.9g}" for v in arr) + "\n")
                else:
                    fh.write(f"VECTORS {name} double\n")
                    for v in arr:
                        fh.write(
                            f"{v[0]:.9g} {v[1]:.9g} "
                            f"{v[2] if len(v) > 2 else 0.0:.9g}\n"
                        )
        if cell_data:
            fh.write(f"CELL_DATA {e}\n")
            for name, arr in cell_data.items():
                fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                fh.write("\n".join(f"{float(v):.9g}" for v in np.asarray(arr)) + "\n")
    return path


def export_png_blocks(
    meshes,  # list of FEMesh sharing one node table
    dof: np.ndarray,
    nodal_vals_per_mesh,  # list of (E_b, n_nodes_b) patch values
    path: str,
    title: str = "",
    deform_scale: float = 1.0,
    cmap: str = "turbo",
):
    """Render several blocks' surfaces in ONE figure with a SHARED color
    scale (the multi-block twin of export_png)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from femcy_tpu_torch.io.colormap import resolve_cmap

    cmap = resolve_cmap(cmap)
    dof = np.asarray(dof)
    dm = meshes[0].dm
    coords = meshes[0].nodes + deform_scale * dof.reshape(-1, dm)

    per_block = [
        _patch_vertex_values(m, np.asarray(v))
        for m, v in zip(meshes, nodal_vals_per_mesh)
    ]
    face_vals_all = [vals.mean(axis=1) for _, vals in per_block]
    vmin = min(float(fv.min()) for fv in face_vals_all)
    vmax = max(float(fv.max()) for fv in face_vals_all) + 1e-30
    norm = None

    if dm == 2:
        fig, ax = plt.subplots(figsize=(7, 6))
        for (tris, _), face_vals in zip(per_block, face_vals_all):
            pc = ax.tripcolor(
                coords[:, 0],
                coords[:, 1],
                tris,
                facecolors=face_vals,
                cmap=cmap,
                vmin=vmin,
                vmax=vmax,
                edgecolors="none",
            )
        for m in meshes:
            for a, b in m.surface_edges:
                ax.plot(
                    coords[[a, b], 0], coords[[a, b], 1],
                    "k-", lw=0.2, alpha=0.4,
                )
        ax.set_aspect("equal")
        fig.colorbar(pc, ax=ax)
    else:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        fig = plt.figure(figsize=(8, 7))
        ax = fig.add_subplot(projection="3d")
        norm = plt.Normalize(vmin, vmax)
        for (tris, _), face_vals in zip(per_block, face_vals_all):
            polys = coords[tris]
            colors = plt.get_cmap(cmap)(norm(face_vals))
            ax.add_collection3d(
                Poly3DCollection(
                    polys, facecolors=colors, edgecolors="k", linewidths=0.1
                )
            )
        lo, hi = coords.min(axis=0), coords.max(axis=0)
        c, r = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-30
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(c[2] - r, c[2] + r)
        fig.colorbar(plt.cm.ScalarMappable(norm=norm, cmap=cmap), ax=ax, shrink=0.6)
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def average_nodal_field(mesh: FEMesh, patch_vals: np.ndarray) -> np.ndarray:
    """Patch values (E, n_nodes) -> volume-agnostic averaged per-node field (N,)."""
    out = np.zeros(mesh.n_nodes)
    count = np.zeros(mesh.n_nodes)
    np.add.at(out, mesh.elements.reshape(-1), np.asarray(patch_vals).reshape(-1))
    np.add.at(count, mesh.elements.reshape(-1), 1.0)
    return out / np.maximum(count, 1.0)


def average_nodal_field_blocks(
    n_nodes: int, meshes, patch_vals_per_mesh
) -> np.ndarray:
    """Multi-block average_nodal_field: patches from EVERY block contribute
    to the shared node table (interface nodes average across blocks)."""
    out = np.zeros(n_nodes)
    count = np.zeros(n_nodes)
    for m, pv in zip(meshes, patch_vals_per_mesh):
        np.add.at(out, m.elements.reshape(-1), np.asarray(pv).reshape(-1))
        np.add.at(count, m.elements.reshape(-1), 1.0)
    return out / np.maximum(count, 1.0)
