"""B31 linear space-beam analysis (2-node Timoshenko beam, 6 dofs/node).

Torch counterpart of ``femcy_tpu.beam``.  A beam node carries 6 dofs (3
translations + 3 rotations), which does not fit ``FEMSystem``'s dm
dofs/node layout, so beams get their own dense system: beam models are
lattices of thousands of dofs, not millions.

- element frames depend only on the geometry: host numpy, f64, once;
- the 12x12 local stiffnesses, their congruence into the global frame and
  the end-force recovery are batched torch einsums, and the element
  matrices go into the dense operator by one ``index_put_`` with
  accumulation (sort-based on CUDA, so two runs give the same bits);
- the dense SPD solve of femcy_tpu (``jax.scipy.linalg.solve(...,
  assume_a="pos")``) is ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``.

The element is the exact-static-stiffness Timoshenko beam (shear
parameter ``phi = 12 E I / (G A_s L^2)``), which reproduces the nodal
displacements of tip-loaded members with one element.  Abaqus dof numbering
(1-3 translations, 4-6 rotations) and ``*Beam Section`` / ``*Beam General
Section`` / ``*Cload`` / ``ENCASTRE`` inputs are read by
:func:`read_beam_inp`.  ``solve_beam`` runs on the card unless
``device="cpu"`` is passed (CUDA without a card raises).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from femcy_tpu_torch.io.inp import (
    _read_material,
    _read_nodes,
    _read_sets,
    _sequence_nodes,
    _split,
)
from femcy_tpu_torch.system import default_dtype
from femcy_tpu_torch.utils.device import resolve_device

__all__ = [
    "BeamSection",
    "BeamModel",
    "BeamResult",
    "read_beam_inp",
    "solve_beam",
]


# ---------------------------------------------------------------------------
# Section properties
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BeamSection:
    """Cross-section constants in the Abaqus beam-section convention.

    Local axis 1 is the user's ``n1`` direction, axis 2 completes the
    right-handed triad ``(t, n1, n2)``.  ``I11 = integral(x2^2 dA)`` resists
    bending about the 1-axis (deflection along 2); ``I22`` the converse.
    """

    A: float
    I11: float
    I22: float
    J: float
    #: shear correction factors (A_s = kappa * A); Timoshenko theory
    kappa1: float = 1.0  # shear along axis 1
    kappa2: float = 1.0  # shear along axis 2
    #: first beam-section axis (Abaqus default for space beams: (0, 0, -1))
    n1: Tuple[float, float, float] = (0.0, 0.0, -1.0)

    @staticmethod
    def rect(a: float, b: float, n1=(0.0, 0.0, -1.0)) -> "BeamSection":
        """Abaqus ``section=RECT`` with dimensions ``a`` (along axis 1) and
        ``b`` (along axis 2); torsion constant from the standard Saint-Venant
        series truncation, shear factor 5/6."""
        big, small = (a, b) if a >= b else (b, a)
        J = big * small**3 * (
            1.0 / 3.0 - 0.21 * (small / big) * (1.0 - small**4 / (12.0 * big**4))
        )
        return BeamSection(
            A=a * b,
            I11=a * b**3 / 12.0,
            I22=b * a**3 / 12.0,
            J=J,
            kappa1=5.0 / 6.0,
            kappa2=5.0 / 6.0,
            n1=tuple(n1),
        )

    @staticmethod
    def circ(r: float, n1=(0.0, 0.0, -1.0)) -> "BeamSection":
        """Abaqus ``section=CIRC`` (solid circle, radius r); shear factor
        6/7 (the Timoshenko value for a solid circular section)."""
        I = np.pi * r**4 / 4.0
        return BeamSection(
            A=np.pi * r**2,
            I11=I,
            I22=I,
            J=2.0 * I,
            kappa1=6.0 / 7.0,
            kappa2=6.0 / 7.0,
            n1=tuple(n1),
        )


@dataclasses.dataclass
class BeamModel:
    """A B31 model ready to solve (geometry + section + loads + supports)."""

    nodes: np.ndarray  # (N, 3) f64
    elements: np.ndarray  # (E, 2) int32, 0-based
    section: BeamSection
    E: float
    nu: float
    #: (node, dof 0..5, value) -- prescribed dof (Abaqus *Boundary)
    dirichlet: List[Tuple[int, int, float]] = dataclasses.field(default_factory=list)
    #: (node, dof 0..5, value) -- concentrated load/moment (Abaqus *Cload)
    loads: List[Tuple[int, int, float]] = dataclasses.field(default_factory=list)

    @property
    def n_dof(self) -> int:
        return 6 * self.nodes.shape[0]


@dataclasses.dataclass
class BeamResult:
    u: np.ndarray  # (N, 6) displacements + rotations
    reactions: np.ndarray  # (N, 6) reaction forces/moments at supported dofs
    #: (E, 12) element end forces in the LOCAL frame, node-wise
    #: [Fx, Fy, Fz, Mx, My, Mz] x 2; axial force N = end_forces[:, 6],
    #: torque T = end_forces[:, 9]
    end_forces: np.ndarray
    #: walls (seconds, synchronised on CUDA) of "assemble", "factor"
    #: (the Dirichlet elimination and the Cholesky factor), "solve" and
    #: "recover"
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Host prep: element frames (static geometry -> numpy f64 once)
# ---------------------------------------------------------------------------


def _element_frames(
    nodes: np.ndarray, elements: np.ndarray, n1: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-element length L (E,) and rotation R (E, 3, 3); R rows are the
    local axes (t, e1, e2) in global coordinates (global -> local map)."""
    x1 = nodes[elements[:, 0]]
    x2 = nodes[elements[:, 1]]
    dx = x2 - x1
    L = np.linalg.norm(dx, axis=1)
    if np.any(L <= 0.0):
        raise ValueError("zero-length B31 element")
    t = dx / L[:, None]
    n1v = np.broadcast_to(np.asarray(n1, dtype=np.float64), t.shape)
    e1 = n1v - (n1v * t).sum(axis=1, keepdims=True) * t
    nrm = np.linalg.norm(e1, axis=1)
    # axis (anti)parallel to n1: Abaqus errors out; fall back to a global
    # axis that is guaranteed non-parallel for those elements
    bad = nrm < 1e-8
    if bad.any():
        alt = np.where(
            np.abs(t[bad, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]]
        )
        e1b = alt - (alt * t[bad]).sum(axis=1, keepdims=True) * t[bad]
        e1[bad] = e1b
        nrm[bad] = np.linalg.norm(e1b, axis=1)
    e1 = e1 / nrm[:, None]
    e2 = np.cross(t, e1)
    R = np.stack([t, e1, e2], axis=1)  # (E, 3, 3)
    return L, R


def _local_stiffness(L, E, G, sec: BeamSection):
    """Exact-static Timoshenko 12x12 in the local frame, batched over L.

    Local dof order per node: (ux, u1, u2, rx, r1, r2) with x the beam axis
    and 1/2 the section axes.  Deflection along axis 1 bends about axis 2
    (stiffness ~ I22); deflection along axis 2 bends about axis 1 (~ I11).
    """
    K = L.new_zeros((L.shape[0], 12, 12))
    ax = E * sec.A / L
    tor = G * sec.J / L
    # axial (u1x, u2x) = dofs 0, 6
    for (i, j, s) in ((0, 0, 1.0), (0, 6, -1.0), (6, 0, -1.0), (6, 6, 1.0)):
        K[:, i, j] += s * ax
    # torsion (r1x, r2x) = dofs 3, 9
    for (i, j, s) in ((3, 3, 1.0), (3, 9, -1.0), (9, 3, -1.0), (9, 9, 1.0)):
        K[:, i, j] += s * tor

    def bend(I, kappa, dv, dr, dv2, dr2, sgn):
        """4x4 bending block; sgn=+1 for the (v=axis-1, r=axis-2) plane,
        -1 for the (v=axis-2, r=axis-1) plane (right-hand-rule sign flip)."""
        phi = 12.0 * E * I * torch.ones_like(L) / (G * kappa * sec.A * L**2)
        c = E * I / ((1.0 + phi) * L**3)
        k11 = 12.0 * c
        k12 = sgn * 6.0 * c * L
        k22 = (4.0 + phi) * c * L**2
        k24 = (2.0 - phi) * c * L**2
        ent = [
            (dv, dv, k11), (dv, dr, k12), (dv, dv2, -k11), (dv, dr2, k12),
            (dr, dv, k12), (dr, dr, k22), (dr, dv2, -k12), (dr, dr2, k24),
            (dv2, dv, -k11), (dv2, dr, -k12), (dv2, dv2, k11), (dv2, dr2, -k12),
            (dr2, dv, k12), (dr2, dr, k24), (dr2, dv2, -k12), (dr2, dr2, k22),
        ]
        for (i, j, v) in ent:
            K[:, i, j] += v

    # deflection along axis 1 (local dof 1), rotation about axis 2 (dof 5):
    # bending stiffness I22 (fibers offset along axis 1)
    bend(sec.I22, sec.kappa1, 1, 5, 7, 11, +1.0)
    # deflection along axis 2 (dof 2), rotation about axis 1 (dof 4): I11;
    # positive r1 rotation moves +2-direction fibers backwards -> sign flip
    bend(sec.I11, sec.kappa2, 2, 4, 8, 10, -1.0)
    return K


def element_matrices(L, R, E: float, nu: float, sec: BeamSection):
    """The beam elements' (k_loc, T, k_glob), each (E, 12, 12), from their
    lengths L (E,) and frames R (E, 3, 3): the local stiffness, the frame
    transform blockdiag(R, R, R, R) and the global-frame stiffness
    T^T k_loc T."""
    G = E / (2.0 * (1.0 + nu))
    k_loc = _local_stiffness(L, E, G, sec)
    T = R.new_zeros((R.shape[0], 12, 12))
    for b in range(4):
        T[:, 3 * b:3 * b + 3, 3 * b:3 * b + 3] = R
    return k_loc, T, torch.einsum("eji,ejk,ekl->eil", T, k_loc, T)


def _assemble(model: BeamModel, device, dtype):
    """Batched local stiffness -> congruence transform -> dense scatter.
    Returns (K (n, n), k_loc (E, 12, 12), T (E, 12, 12), edofs (E, 12))
    on ``device``."""
    L_np, R_np = _element_frames(model.nodes, model.elements, model.section.n1)
    L = torch.as_tensor(L_np, dtype=dtype, device=device)
    R = torch.as_tensor(R_np, dtype=dtype, device=device)
    k_loc, T, k_glob = element_matrices(L, R, model.E, model.nu,
                                        model.section)

    n = model.n_dof
    edofs = torch.as_tensor(
        (6 * np.asarray(model.elements, np.int64)[:, :, None]
         + np.arange(6)).reshape(-1, 12), device=device)
    rows = edofs[:, :, None].expand(-1, 12, 12).reshape(-1)
    cols = edofs[:, None, :].expand(-1, 12, 12).reshape(-1)
    K = k_glob.new_zeros((n, n))
    K.index_put_((rows, cols), k_glob.reshape(-1), accumulate=True)
    return K, k_loc, T, edofs


def solve_beam(model: BeamModel, device="cuda") -> BeamResult:
    """Assemble and solve the linear beam system, dense, in the default
    dtype (float64), on ``device``."""
    device = resolve_device(device)
    dtype = default_dtype()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    seconds = {}
    t = _time.perf_counter()
    K, k_loc, T, edofs = _assemble(model, device, dtype)
    n = model.n_dof

    f = np.zeros(n)
    for (node, dof, val) in model.loads:
        f[6 * node + dof] += val
    fixed = np.zeros(n, dtype=bool)
    u_fix = np.zeros(n)
    for (node, dof, val) in model.dirichlet:
        fixed[6 * node + dof] = True
        u_fix[6 * node + dof] = val
    if not fixed.any():
        raise ValueError("beam model has no supports (singular system)")
    f_d = torch.as_tensor(f, dtype=dtype, device=device)
    u_fix_d = torch.as_tensor(u_fix, dtype=dtype, device=device)
    free = torch.as_tensor(~fixed, device=device)
    fixed_idx = torch.as_tensor(np.flatnonzero(fixed), device=device)
    sync()
    seconds["assemble"] = _time.perf_counter() - t

    t = _time.perf_counter()
    # eliminate: rhs on free dofs minus coupling to prescribed values;
    # fixed rows and columns zeroed, their diagonal 1
    rhs = torch.where(free, f_d - K @ u_fix_d, u_fix_d)
    Kbc = K.clone()
    Kbc[fixed_idx] = 0.0
    Kbc[:, fixed_idx] = 0.0
    Kbc[fixed_idx, fixed_idx] = 1.0
    factor, info = torch.linalg.cholesky_ex(Kbc)
    del Kbc
    if int(info) != 0:
        raise RuntimeError(
            f"beam operator is not positive definite (Cholesky failed at "
            f"column {int(info)}): a mechanism or missing support")
    sync()
    seconds["factor"] = _time.perf_counter() - t

    t = _time.perf_counter()
    u = torch.cholesky_solve(rhs[:, None], factor)[:, 0]
    del factor
    r = K @ u - f_d  # reactions at supports
    reac = torch.where(free, torch.zeros_like(r), r)
    sync()
    seconds["solve"] = _time.perf_counter() - t

    t = _time.perf_counter()
    ue_loc = torch.einsum("eij,ej->ei", T, u[edofs])
    fe = torch.einsum("eij,ej->ei", k_loc, ue_loc)
    N = model.nodes.shape[0]
    result = BeamResult(
        u=u.cpu().numpy().reshape(N, 6),
        reactions=reac.cpu().numpy().reshape(N, 6),
        end_forces=fe.cpu().numpy(),
        seconds=seconds,
    )
    seconds["recover"] = _time.perf_counter() - t
    return result


# ---------------------------------------------------------------------------
# Abaqus .inp front end
# ---------------------------------------------------------------------------

_NAMED_BC = {
    "ENCASTRE": (0, 1, 2, 3, 4, 5),
    "PINNED": (0, 1, 2),
    "XSYMM": (0, 4, 5),
    "YSYMM": (1, 3, 5),
    "ZSYMM": (2, 3, 4),
}


def _resolve_nodes(tok: str, node_sets: Dict[str, np.ndarray], key2id) -> np.ndarray:
    if tok in node_sets:
        return node_sets[tok]
    try:
        return np.asarray([key2id[int(tok)]])
    except (ValueError, KeyError):
        raise KeyError(f"unknown node or node set {tok!r}") from None


def _read_beam_section(lines: Sequence[str]) -> BeamSection:
    """``*Beam Section, section=RECT|CIRC`` (dims line + optional n1 line) or
    ``*Beam General Section`` (A, I11, I12, I22, J + n1 line)."""
    for idx, line in enumerate(lines):
        low = line.lower()
        if not low.startswith("*beam"):
            continue
        data: List[List[float]] = []
        for nxt in lines[idx + 1 :]:
            if nxt.startswith("*"):
                break
            if nxt.strip():
                data.append([float(t) for t in _split(nxt) if t])
        n1 = (0.0, 0.0, -1.0)
        if "general" in low:
            A, I11, _I12, I22, J = data[0][:5]
            if len(data) > 1 and len(data[1]) >= 3:
                n1 = tuple(data[1][:3])
            return BeamSection(A=A, I11=I11, I22=I22, J=J, n1=n1)
        kind = ""
        for tok in _split(line):
            if tok.lower().startswith("section="):
                kind = tok.split("=")[1].strip().upper()
        if len(data) > 1 and len(data[1]) >= 3:
            n1 = tuple(data[1][:3])
        if kind == "RECT":
            return BeamSection.rect(data[0][0], data[0][1], n1=n1)
        if kind == "CIRC":
            return BeamSection.circ(data[0][0], n1=n1)
        raise ValueError(f"unsupported *Beam Section kind {kind!r}")
    raise ValueError("no *Beam Section block found")


def _read_beam_boundary(
    lines: Sequence[str], node_sets, key2id
) -> List[Tuple[int, int, float]]:
    """*Boundary with the full Abaqus semantics beams need: first..last dof
    ranges (the main reader's parity mode keeps first_dof only,
    inp_info.py:230-240) and named types (ENCASTRE, ...)."""
    out: List[Tuple[int, int, float]] = []
    reading = False
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*":
            reading = line.lower().startswith("*boundary")
            continue
        if not (reading and line.strip()):
            continue
        toks = [t for t in _split(line) if t]
        nids = _resolve_nodes(toks[0], node_sets, key2id)
        if len(toks) >= 2 and toks[1].upper() in _NAMED_BC:
            dofs: Sequence[int] = _NAMED_BC[toks[1].upper()]
            val = 0.0
        else:
            first = int(toks[1]) - 1
            last = int(toks[2]) - 1 if len(toks) >= 3 and toks[2] else first
            val = float(toks[3]) if len(toks) >= 4 and toks[3] else 0.0
            dofs = range(first, last + 1)
        for nid in nids:
            for d in dofs:
                out.append((int(nid), int(d), val))
    return out


def _read_cloads(lines, node_sets, key2id) -> List[Tuple[int, int, float]]:
    out: List[Tuple[int, int, float]] = []
    reading = False
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*":
            reading = line.lower().startswith("*cload")
            continue
        if not (reading and line.strip()):
            continue
        toks = [t for t in _split(line) if t]
        for nid in _resolve_nodes(toks[0], node_sets, key2id):
            out.append((int(nid), int(toks[1]) - 1, float(toks[2])))
    return out


def read_beam_inp(file_name: str) -> BeamModel:
    """Read a B31 ``.inp`` (nodes, connectivity, *Beam Section, *Boundary,
    *Cload, *Material/*Elastic) into a :class:`BeamModel`."""
    with open(file_name, "r") as fh:
        lines = fh.read().splitlines()

    nodes_dict = _read_nodes(lines)
    nodes, key2id = _sequence_nodes(nodes_dict)
    if nodes.shape[1] != 3:
        raise ValueError("B31 requires 3-D nodes")

    # connectivity (the main reader's B31 row shape: 3 cols, 2 kept)
    conn: List[int] = []
    current = False
    for line in lines:
        s = line.lstrip()
        if s[:2] == "**":
            continue  # '**' comments are legal INSIDE *Element blocks
        if s[:1] == "*":
            low = s.lower().replace(" ", "")
            current = (
                low.split(",")[0] == "*element" and "type=b31" in low
            )
            continue
        if current and line.strip():
            conn.extend(int(t) for t in _split(line.rstrip().rstrip(",")) if t)
    if not conn:
        raise ValueError("no *Element, type=B31 block found")
    raw = np.asarray(conn, dtype=np.int64).reshape(-1, 3)[:, 1:]
    elements = np.vectorize(key2id.__getitem__, otypes=[np.int64])(raw).astype(
        np.int32
    )

    node_sets, _ = _read_sets(lines, key2id, require_instance=False)
    section = _read_beam_section(lines)
    mat_type, params = _read_material(lines)
    if not mat_type.lower().startswith("elastic"):
        raise ValueError(f"B31 supports *Elastic materials only, got {mat_type!r}")
    E, nu = params[0], params[1]

    return BeamModel(
        nodes=nodes,
        elements=elements,
        section=section,
        E=E,
        nu=nu,
        dirichlet=_read_beam_boundary(lines, node_sets, key2id),
        loads=_read_cloads(lines, node_sets, key2id),
    )
