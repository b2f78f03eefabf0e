"""Scatter-free assembly for structured box_tets meshes.

Torch counterpart of the structured-box parts of ``femcy_tpu.structured``.
On a Kuhn-subdivided box (meshgen.box_tets) elements of one orientation
form a dense cell grid, and every (orientation, local-row-dof p,
local-col-dof q) pair writes to ONE diagonal offset of the DIA matrix with
ONE {0,1}^3 corner shift (``build_structured_plan``).
``structured_assemble_coords`` takes node coordinates to DIA values by one
of three routes:

- "fused" (P3, kernels/structured_fused.py): one CUDA kernel from the
  coordinates to the DIA values, for one-Gauss-point elements with an
  isotropic tangent; ``fused_assemble_plain`` is its plain version;
- "pallas", the two-stage path: the prep (``stiffness_planes``, plain
  torch: per orientation, B^T C B for every cell, laid out as planes
  (6, 144, nx*ny*nz) in plain cell order, with the cheap 3-term form for
  an isotropic tangent) and the accumulate kernel (P2,
  kernels/structured_accumulate.py), which sums the 864 corner-shifted
  planes of each (i, k) group; ``accumulate_planes`` is its plain version;
- "xla", the plain torch path: the generic prep and ``accumulate_planes``.

On CUDA the default is "fused" where it applies and "pallas" otherwise;
on the CPU it is the plain path.

The Newton path also assembles from element matrices:
``structured_dia_scatter`` (Ke + Kg, or the consistent tangent, as P2's
planes); its secant tangent alone takes ``structured_assemble_coords``
from the current coordinates.  ``structured_force_scatter`` sums element
forces into nodal forces by the same corner shifts (the plain version of
M5, kernels/structured_force.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from femcy_tpu_torch import assembly
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.solvers.dia import DIAPattern


@dataclasses.dataclass(frozen=True)
class StructuredPlan:
    nx: int
    ny: int
    nz: int
    n_offsets: int
    #: (i, k) -> list of (orientation, 3a+i, 3b+j, (dx, dy, dz)) combos
    groups: Dict[Tuple[int, int], List[Tuple[int, int, int, Tuple[int, int, int]]]]

    # The kernels' combo tables, built at first use and kept with the plan
    # (with their device copies), so an assembly uploads nothing.
    @functools.cached_property
    def accumulate_table(self):
        """The combo list as P2's CSR table (kernels.structured_accumulate)."""
        from femcy_tpu_torch.kernels.structured_accumulate import AccumulateTable

        return AccumulateTable(self)

    @functools.cached_property
    def fused_table(self):
        """The combo list as P3's table (kernels.structured_fused)."""
        from femcy_tpu_torch.kernels.structured_fused import FusedTable

        return FusedTable(self)

    @functools.cached_property
    def force_shifts(self) -> np.ndarray:
        """The (24, 3) int32 corner shift of local node a of Kuhn
        orientation o, at row o * 4 + a: M5's table
        (kernels.structured_force), read off the combos, where (o, p, q)
        carries the shift of p's node a = p // 3."""
        shifts = np.zeros((24, 3), dtype=np.int32)
        for combos in self.groups.values():
            for o, p, _, shift in combos:
                shifts[o * 4 + p // 3] = shift
        return shifts

    @functools.cached_property
    def force_tile(self) -> Dict[str, Tuple[int, int, int]]:
        """M5's tile by dtype name: (ty, tz, lx), a block's ty x tz grid
        nodes in (y, z) marching over lx node planes in x, sized for the
        current card's SMs (kernels.structured_force.force_tile)."""
        from femcy_tpu_torch.kernels.structured_force import card_sms, force_tile

        sms = card_sms()
        return {name: force_tile(self.nx, self.ny, self.nz, name, sms)
                for name in ("float32", "float64")}


def _box_info(mesh: FEMesh) -> dict:
    info = mesh.structure
    if info is None or info.get("kind") != "box_tets":
        raise ValueError("the structured path needs a meshgen.box_tets mesh")
    return info


def build_structured_plan(mesh: FEMesh, dia: DIAPattern) -> StructuredPlan:
    """Map every element-stiffness entry class to its DIA slot, host-side."""
    info = _box_info(mesh)
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    kuhn = info["kuhn"]
    delta = np.asarray(info["corner_delta"])  # (8, 3) cube corner offsets
    stride = np.array([(ny + 1) * (nz + 1), nz + 1, 1])
    offsets = np.asarray(dia.offsets)
    groups: Dict[Tuple[int, int], List] = {}
    for o, corners in enumerate(kuhn):
        d = delta[list(corners)]  # (4, 3) corner offset of each tet node
        for a in range(4):
            for b in range(4):
                node_off = int((d[b] - d[a]) @ stride)
                for i in range(3):
                    for j in range(3):
                        off = 3 * node_off + (j - i)
                        k = int(np.searchsorted(offsets, off))
                        if offsets[k] != off:
                            raise ValueError(f"offset {off} missing from DIA")
                        groups.setdefault((i, k), []).append(
                            (o, 3 * a + i, 3 * b + j, tuple(int(x) for x in d[a]))
                        )
    return StructuredPlan(
        nx=nx, ny=ny, nz=nz, n_offsets=dia.n_offsets, groups=groups
    )


def structured_element_nodes(node_vals, mesh: FEMesh):
    """Per-element nodal values without the ``vals[elements]`` gather.

    node_vals : (n_nodes, dm) -> (E, 4, dm) in box_tets element order: the
    8 cell-corner grids are slices of the node grid and each element's 4
    nodes are fixed picks of its cell's corners.
    """
    info = _box_info(mesh)
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    dm = node_vals.shape[-1]
    grid = node_vals.reshape(nx + 1, ny + 1, nz + 1, dm)
    corners = torch.stack(
        [
            grid[dx : dx + nx, dy : dy + ny, dz : dz + nz]
            for dx, dy, dz in info["corner_delta"]
        ],
        dim=3,
    )  # (nx, ny, nz, 8, dm)
    cells = corners.reshape(nx * ny * nz, 8, dm)
    per_orient = torch.stack(
        [cells[:, list(c)] for c in info["kuhn"]], dim=1
    )  # (nc, 6, 4, dm)
    return per_orient.reshape(-1, 4, dm)


def isotropic_lame(C_host, rtol: float = 1.0e-6):
    """(lam, mu) if the 6x6 Voigt tangent is isotropic, else None (host
    numpy, the JAX package's kernels.structured_fused.isotropic_lame)."""
    C = np.asarray(C_host, dtype=np.float64)
    if C.shape != (6, 6):
        return None
    lam = float(C[0, 1])
    mu = float(C[3, 3])
    iso = np.zeros((6, 6))
    iso[:3, :3] = lam
    iso[np.arange(3), np.arange(3)] = lam + 2.0 * mu
    iso[np.arange(3, 6), np.arange(3, 6)] = mu
    scale = np.abs(C).max()
    if scale == 0.0 or np.abs(C - iso).max() > rtol * scale:
        return None
    return lam, mu


def _isotropic_stiffness(dsdx, vol, lam: float, mu: float):
    """(nc, 4, 3) gradients and (nc,) volumes -> (144, nc) element
    stiffness, Ke[(a,i),(b,j)] = vol * (lam dNa_i dNb_j + mu dNa_j dNb_i
    + delta_ij mu dNa.dNb): C = lam (1 x 1) + 2 mu I collapses B^T C B
    to three terms."""
    ds = dsdx.permute(1, 2, 0)  # (4, 3, nc): [a, i]
    ds_ib = ds.transpose(0, 1)  # (3, 4, nc): [i, b]
    G = (ds[:, None] * ds[None]).sum(2)  # (4, 4, nc): dNa . dNb
    eye = torch.eye(3, dtype=ds.dtype, device=ds.device)
    Ke = (
        lam * (ds[:, :, None, None] * ds[None, None])
        + mu * (ds[:, None, None, :] * ds_ib[None, :, :, None])
        + mu * (G[:, None, :, None] * eye[None, :, None, :, None])
    )  # (4, 3, 4, 3, nc): [a, i, b, j]
    return (Ke * vol).reshape(144, -1)


def stiffness_planes(coords, mesh: FEMesh, dN, w, C, lame=None):
    """The plain prep: node coordinates -> (6, 144, nx*ny*nz) planes.

    Plane [o, 12 p + q] is entry (p, q) of the orientation-o element
    stiffness (``assembly.element_stiffness(..., layout="ije")``) of every
    cell, in plain cell order (cx * ny + cy) * nz + cz.  Computed one
    orientation at a time so only one sixth of the element data is live.

    lame: optional (lam, mu) of an isotropic tangent (``isotropic_lame``),
    for one-Gauss-point elements: the 3-term form replaces B^T C B, and C
    is not read.
    """
    info = _box_info(mesh)
    nc = info["nx"] * info["ny"] * info["nz"]
    if lame is not None and dN.shape[0] != 1:
        raise ValueError("the isotropic 3-term prep needs one Gauss point")
    x_e = structured_element_nodes(coords, mesh).reshape(nc, 6, 4, -1)
    planes = coords.new_empty((6, 144, nc))
    for o in range(6):
        dsdx, vol = assembly.gradients_and_volume_x(x_e[:, o], dN, w)
        if lame is not None:
            planes[o] = _isotropic_stiffness(dsdx[:, 0], vol[:, 0], *lame)
        else:
            planes[o] = assembly.element_stiffness(
                dsdx, vol, C, layout="ije"
            ).reshape(144, nc)
    return planes


def fused_assemble_plain(coords, mesh: FEMesh, lam: float, mu: float,
                         plan: StructuredPlan):
    """The plain version of P3: the isotropic planes, then
    ``accumulate_planes``, with the element's own quadrature tables."""
    elem = mesh.element

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=coords.dtype,
                               device=coords.device)

    planes = stiffness_planes(coords, mesh, dev(elem.dshape_at_gp),
                              dev(elem.gauss_weights), None, lame=(lam, mu))
    return accumulate_planes(planes, plan)


_MODES = ("fused", "pallas", "xla")


def auto_accumulate(device, lame, n_gauss: int) -> str:
    """The route ``structured_assemble_coords`` takes by default: on CUDA,
    "fused" for an isotropic tangent and one Gauss point, else "pallas";
    on the CPU, the plain path."""
    if torch.device(device).type != "cuda":
        return "xla"
    return "fused" if lame is not None and n_gauss == 1 else "pallas"


def structured_assemble_coords(coords, mesh: FEMesh, dN, w, C,
                               plan: StructuredPlan,
                               accumulate: Optional[str] = None,
                               C_host=None):
    """Node coordinates -> DIA values (n_dof, K).

    accumulate: None (``auto_accumulate``), "fused" (P3; raises if the
    plan is unsupported: it needs an isotropic ``C_host`` and a
    one-Gauss-point element), "pallas" (the prep, with the 3-term form for
    an isotropic ``C_host``, then P2) or "xla" (the plain torch path; the
    name is femcy_tpu's, kept so its callers work).  The kernel wrappers
    run their plain versions on CPU tensors.

    C_host: optional host numpy copy of the material tangent, read for its
    Lame constants.  dN/w must be the element's own quadrature tables,
    which the fused route reads from ``mesh.element``.
    """
    if accumulate is not None and accumulate not in _MODES:
        raise ValueError(f"accumulate={accumulate!r}: expected None or one of "
                         f"{_MODES}")
    lame = isotropic_lame(C_host) if C_host is not None else None
    n_gauss = np.asarray(mesh.element.dshape_at_gp).shape[0]
    mode = accumulate or auto_accumulate(coords.device, lame, n_gauss)
    if mode == "fused":
        from femcy_tpu_torch.kernels import structured_fused

        fp = structured_fused.build_fused_plan(mesh, plan, C_host)
        if fp is None:
            raise ValueError(
                "accumulate='fused' forced but the fused kernel is "
                "unsupported here (needs an isotropic C_host and a "
                "one-Gauss-point element)"
            )
        return structured_fused.fused_assemble(coords, fp)
    if mode == "pallas":
        from femcy_tpu_torch.kernels.structured_accumulate import accumulate as acc

        planes = stiffness_planes(coords, mesh, dN, w, C,
                                  lame=lame if n_gauss == 1 else None)
        return acc(planes, plan.accumulate_table)
    return accumulate_planes(stiffness_planes(coords, mesh, dN, w, C), plan)


def _accumulate(planes, plan: StructuredPlan):
    """(6, 144, nc) planes -> DIA values: the accumulate kernel (P2) on
    CUDA, its plain version ``accumulate_planes`` on the CPU."""
    from femcy_tpu_torch.kernels.structured_accumulate import accumulate

    return accumulate(planes, plan.accumulate_table)


def structured_dia_scatter(Ke, plan: StructuredPlan):
    """Element stiffnesses (E, 12, 12) -> DIA values (n_dof, K), with no
    scatter: Ke in box_tets cell-major order (E = 6 * nx * ny * nz) is
    transposed to P2's (6, 144, nc) planes, then accumulated.  The
    transpose costs 2x Ke's bytes (femcy_tpu.structured's own note)."""
    nc = plan.nx * plan.ny * plan.nz
    if Ke.shape != (6 * nc, 12, 12):
        raise ValueError(
            f"Ke shape {tuple(Ke.shape)} != ({6 * nc}, 12, 12)"
        )
    planes = Ke.reshape(nc, 6, 144).permute(1, 2, 0).contiguous()
    return _accumulate(planes, plan)


def structured_force_scatter(f_elem, plan: StructuredPlan, mesh: FEMesh):
    """Per-element nodal forces (E, 4, 3) in box_tets cell-major order ->
    global force (n_dof,), with no scatter: 6 orientations x 4 local nodes
    of corner-shifted dense adds, orientation outer, local node inner
    (femcy_tpu.structured.structured_force_scatter).  The plain version of
    the box force kernel (kernels/structured_force.py, M5)."""
    info = _box_info(mesh)
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    delta = np.asarray(info["corner_delta"])
    fg = f_elem.reshape(nx, ny, nz, 6, 4, 3)
    out = f_elem.new_zeros((nx + 1, ny + 1, nz + 1, 3))
    for o, corners in enumerate(info["kuhn"]):
        d = delta[list(corners)]
        for a in range(4):
            dx, dy, dz = (int(v) for v in d[a])
            out[dx : dx + nx, dy : dy + ny, dz : dz + nz] += fg[:, :, :, o, a]
    return out.reshape(-1)


def accumulate_planes(planes, plan: StructuredPlan):
    """The plain accumulate: (6, 144, nc) planes -> DIA values (n_dof, K).

    A port of femcy_tpu.structured._accumulate: per orientation, every
    touched (i, k) column is the sum of corner-shifted cell grids.  It works
    in FLAT node space: padding each (p, q) cell grid with one zero layer
    per axis makes every corner-shifted 3D pad a 1D slice at offset
    dx*sx + dy*sy + dz (the zero layers absorb the axis wrap-around).
    Sums per orientation in plan order, then over orientations.
    """
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    by_orient: Dict[int, Dict[Tuple[int, int], List]] = {o: {} for o in range(6)}
    for (i, k), combos in plan.groups.items():
        for o, p, q, shift in combos:
            by_orient[o].setdefault((i, k), []).append((p, q, shift))

    sx, sy = (ny + 1) * (nz + 1), nz + 1
    Nn = (nx + 1) * sx
    pad_lo = sx + sy + 1  # the largest corner shift
    mat = planes.new_zeros((3 * K, Nn))
    for o in range(6):
        Ko = planes[o].reshape(12, 12, nx, ny, nz)
        Kop = F.pad(Ko, (0, 1, 0, 1, 0, 1)).reshape(12, 12, Nn)
        Kop = F.pad(Kop, (pad_lo, 0))
        for (i, k), combos in by_orient[o].items():
            acc = None
            for p, q, (dx, dy, dz) in combos:
                off = dx * sx + dy * sy + dz
                term = Kop[p, q, pad_lo - off : pad_lo - off + Nn]
                acc = term if acc is None else acc + term
            mat[i * K + k] += acc
    # (3K, Nn) -> (n_dof, K): rows are node*3 + i, columns the offsets
    return mat.reshape(3, K, Nn).permute(2, 0, 1).reshape(-1, K)


def analytic_cell_tensor(
    mesh: FEMesh, C: np.ndarray, dia: DIAPattern
) -> np.ndarray:
    """The per-corner-shift constant row tensor c[sx, sy, sz, i, k] of a
    uniform box_tets grid with a constant material tangent: the whole
    operator, compressed to (2, 2, 2, 3, K) numpy.  Host copy of the JAX
    package's, the f64 oracle of the structured assembly.
    """
    info = _box_info(mesh)
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    kuhn = info["kuhn"]
    delta = np.asarray(info["corner_delta"])
    spacing = np.array(
        [
            mesh.nodes[:, 0].max() / nx,
            mesh.nodes[:, 1].max() / ny,
            mesh.nodes[:, 2].max() / nz,
        ]
    )
    elem = mesh.element
    dN = np.asarray(elem.dshape_at_gp)  # (G, n, 3)
    w = np.asarray(elem.gauss_weights)
    C = np.asarray(C)

    # one cell's per-orientation element stiffness, plain numpy
    corner_x = delta * spacing  # (8, 3) physical corner coords
    Ke = np.zeros((6, 12, 12))
    for o, corners in enumerate(kuhn):
        x = corner_x[list(corners)]  # (4, 3)
        dxdn = np.einsum("nD,gnd->gDd", x, dN)  # (G, 3, 3)
        dsdx = np.einsum("gnd,gdD->gnD", dN, np.linalg.inv(dxdn))
        vol = np.linalg.det(dxdn) * w  # (G,)
        G, n = dsdx.shape[0], dsdx.shape[1]
        B = np.zeros((G, 6, 3 * n))
        Nx, Ny, Nz = dsdx[..., 0], dsdx[..., 1], dsdx[..., 2]
        B[:, 0, 0::3], B[:, 1, 1::3], B[:, 2, 2::3] = Nx, Ny, Nz
        B[:, 3, 0::3], B[:, 3, 1::3] = Ny, Nx
        B[:, 4, 0::3], B[:, 4, 2::3] = Nz, Nx
        B[:, 5, 1::3], B[:, 5, 2::3] = Nz, Ny
        Ke[o] = np.einsum("gai,ab,gbj,g->ij", B, C, B, vol)

    offsets = np.asarray(dia.offsets)
    K = dia.n_offsets
    stride = np.array([(ny + 1) * (nz + 1), nz + 1, 1])
    c = np.zeros((2, 2, 2, 3, K))
    for o, corners in enumerate(kuhn):
        d = delta[list(corners)]
        for a in range(4):
            sx, sy, sz = (int(v) for v in d[a])
            for b in range(4):
                node_off = int((d[b] - d[a]) @ stride)
                for i in range(3):
                    for j in range(3):
                        k = int(np.searchsorted(offsets, 3 * node_off + (j - i)))
                        c[sx, sy, sz, i, k] += Ke[o, 3 * a + i, 3 * b + j]
    return c


def analytic_structured_dia_values(
    mesh: FEMesh, C: np.ndarray, dia: DIAPattern
) -> np.ndarray:
    """DIA values (n_dof, K) of the assembled operator on a uniform
    box_tets grid with a constant material tangent, in O(n_dof * K) numpy
    from ONE cell (see analytic_cell_tensor)."""
    info = _box_info(mesh)
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    c = analytic_cell_tensor(mesh, C, dia)
    K = c.shape[-1]

    # broadcast through separable cell-existence masks: the cell at
    # (p - s) exists iff s <= p <= n-1+s along each axis
    V = np.zeros((nx + 1, ny + 1, nz + 1, 3, K))
    masks = {
        0: [(np.arange(n + 1) <= n - 1).astype(float) for n in (nx, ny, nz)],
        1: [(np.arange(n + 1) >= 1).astype(float) for n in (nx, ny, nz)],
    }
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                m = (
                    masks[sx][0][:, None, None]
                    * masks[sy][1][None, :, None]
                    * masks[sz][2][None, None, :]
                )
                V += m[..., None, None] * c[sx, sy, sz]
    return V.reshape(-1, K)


def cell_gradients(mesh: FEMesh):
    """Per-orientation shape gradients and volumes of ONE uniform-grid
    cell, host numpy: (dsdx (6, G, 4, 3), vol (6, G)).  Every cell of an
    orientation has the same kinematics on a uniform box, so the
    slab-sharded path broadcasts these over its cells (host copy of
    femcy_tpu.structured.cell_gradients)."""
    info = _box_info(mesh)
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    spacing = np.array(
        [
            mesh.nodes[:, 0].max() / nx,
            mesh.nodes[:, 1].max() / ny,
            mesh.nodes[:, 2].max() / nz,
        ]
    )
    delta = np.asarray(info["corner_delta"]) * spacing
    dN = np.asarray(mesh.element.dshape_at_gp)  # (G, 4, 3)
    w = np.asarray(mesh.element.gauss_weights)
    dsdx = np.zeros((6, dN.shape[0], 4, 3))
    vol = np.zeros((6, dN.shape[0]))
    for o, corners in enumerate(info["kuhn"]):
        x = delta[list(corners)]  # (4, 3)
        dxdn = np.einsum("nD,gnd->gDd", x, dN)
        dsdx[o] = np.einsum("gnd,gdD->gnD", dN, np.linalg.inv(dxdn))
        vol[o] = np.linalg.det(dxdn) * w
    return dsdx, vol


def dia_to_dense_device(values, offsets):
    """(n, K) DIA values -> (n, n) dense, on the values' device: the
    small-model dense CG's operator (FEMSystem._dense_cg_core).  Slots whose
    column falls outside the matrix are clipped onto column 0 or n - 1 with
    value 0; the indexed add keeps the true entries they share a target
    with."""
    n, K = values.shape
    rows = torch.arange(n, device=values.device)[:, None]
    cols = rows + torch.as_tensor(list(offsets), device=values.device)[None, :]
    valid = (cols >= 0) & (cols < n)
    contrib = torch.where(valid, values, values.new_zeros(()))
    A = values.new_zeros((n, n))
    return A.index_put_((rows.expand(n, K), cols.clamp(0, n - 1)), contrib,
                        accumulate=True)


def dia_dirichlet_linear_numpy(
    values: np.ndarray, offsets, diag_idx: int, fixed: np.ndarray
) -> np.ndarray:
    """Host twin of solvers.dia.dia_dirichlet_linear for homogeneous
    (sval = 0) elimination."""
    n = fixed.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    fixed_pad = np.pad(np.asarray(fixed, dtype=bool), (pad_lo, pad_hi))
    col_fixed = np.stack(
        [fixed_pad[pad_lo + off : pad_lo + off + n] for off in offsets], axis=1
    )
    out = np.where(col_fixed | fixed[:, None], 0.0, values)
    out[:, diag_idx] = np.where(fixed, 1.0, out[:, diag_idx])
    return out
