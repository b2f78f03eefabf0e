"""Abaqus/CalculiX ``.inp`` reader (pure numpy, host-side).

Behavioural parity with the reference reader (reader/inp_info.py:14-368),
including its quirks, so the 47 ``tests/`` fixtures parse identically:

* only the first ``*Node`` block is read (inp_info.py:37-50);
* all ``*Element`` blocks of one supported type are concatenated; exactly one
  element type per model (inp_info.py:125-128);
* ``*Nset``/``*Elset`` are only collected when the keyword line mentions
  ``instance`` (inp_info.py:140), with ``generate`` ranges expanded;
* ``*Surface`` face sets expand to sorted global node tuples through the
  element's Abaqus face-number map (inp_info.py:172-213);
* ``*Boundary``: ``set, dof[, last_dof[, value]]`` -> one Dirichlet record per
  data line; the third column is ignored (first_dof only, inp_info.py:230-240);
  ``*Boundary, user`` marks the user-subroutine path;
* ``*Dsload``: ``set, P, value`` -> pressure with traction = -value;
  a 6-column form gives an explicit direction (inp_info.py:246-272);
* ``*Step ... nlgeom=NO`` -> linear; anything else (including a missing
  nlgeom key) -> geometric nonlinear (inp_info.py:319-330);
* ``*Static``: ini_inc, max_time, min_inc, max_inc with ini clamped to max
  (inp_info.py:333-350).

Host copy of ``femcy_tpu.io.inp`` restricted to the single-block reader
(``read_inp``); the multi-block reader comes with the multi-block slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from femcy_tpu_torch.elements import ElementType, get_element

#: element keyword -> ints per data row in the connectivity block
#: (ref: inp_info.py:85-113; unlike the reference -- which keeps only the 8
#: corner nodes of a C3D20 it can never solve -- all 20 nodes are kept here
#: because the HEX20 element class exists)
_ROW_WIDTHS = {
    "C3D8": (9, 8),
    "C3D20": (21, 20),
    "C3D4": (5, 4),
    "CPE4": (5, 4),
    "CPS4": (5, 4),
    "CPS8": (9, 8),
    "CPE8": (9, 8),
    "C3D10": (11, 10),
    "B31": (3, 2),
    "CPS3": (4, 3),
    "CPE3": (4, 3),
    "C3D6": (7, 6),
    "CPS6": (7, 6),
    "CPE6": (7, 6),
}

_SUPPORTED_TYPES = tuple(_ROW_WIDTHS)


@dataclasses.dataclass
class DirichletBC:
    node_set: np.ndarray  # 0-based node ids
    dof: int  # 0-based dof dimension
    value: float
    user: bool = False


@dataclasses.dataclass
class NeumannBC:
    face_set: List[Tuple[int, ...]]  # sorted global node tuples
    traction: float
    direction: Optional[np.ndarray] = None  # None => pressure along -normal


@dataclasses.dataclass
class InpModel:
    nodes: np.ndarray  # (N, dm) float64
    elements: np.ndarray  # (E, n) int32, 0-based
    element_type: str  # Abaqus keyword, e.g. "CPS3"
    node_sets: Dict[str, np.ndarray]
    ele_sets: Dict[str, np.ndarray]
    face_sets: Dict[str, List[Tuple[int, ...]]]
    dirichlet_bcs: List[DirichletBC]
    neumann_bcs: List[NeumannBC]
    material_type: str  # "Elastic" | "Hyperelastic, neo hooke" | ...
    material_params: List[float]
    geometric_nonlinear: bool
    time_incs: Dict[str, float]

    @property
    def element(self) -> ElementType:
        return get_element(self.element_type)

    @property
    def dm(self) -> int:
        return self.nodes.shape[1]

    @property
    def n_dof(self) -> int:
        return self.nodes.shape[0] * self.nodes.shape[1]


def _split(line: str) -> List[str]:
    return [tok.strip() for tok in line.strip().split(",")]


def read_inp(file_name: str) -> InpModel:
    with open(file_name, "r") as fh:
        lines = fh.read().splitlines()

    nodes_dict = _read_nodes(lines)
    element_type, elements_raw = _read_elements(lines)
    nodes, key2id = _sequence_nodes(nodes_dict)
    elements = np.vectorize(key2id.__getitem__, otypes=[np.int64])(elements_raw)
    elements = elements.astype(np.int32)

    element = get_element(element_type)  # raises for parsed-but-unsupported types

    node_sets, ele_sets = _read_sets(lines, key2id)
    face_sets = _read_face_sets(lines, elements, element, ele_sets)
    dirichlet_bcs = _read_dirichlet(lines, node_sets)
    neumann_bcs = _read_neumann(lines, face_sets)
    material_type, material_params = _read_material(lines)
    geometric_nonlinear = _read_nlgeom(lines)
    time_incs = _read_time_incs(lines)

    return InpModel(
        nodes=nodes,
        elements=elements,
        element_type=element_type,
        node_sets=node_sets,
        ele_sets=ele_sets,
        face_sets=face_sets,
        dirichlet_bcs=dirichlet_bcs,
        neumann_bcs=neumann_bcs,
        material_type=material_type,
        material_params=material_params,
        geometric_nonlinear=geometric_nonlinear,
        time_incs=time_incs,
    )


# --------------------------------------------------------------------------- #
def _read_nodes(lines: Sequence[str]) -> Dict[int, List[float]]:
    nodes: Dict[int, List[float]] = {}
    reading = False
    for line in lines:
        if "*" in line:
            if reading:
                break
            if "*Node" in line or "*NODE" in line or "*node" in line:
                reading = True
            continue
        if reading and line.strip():
            data = [float(tok) for tok in _split(line) if tok]
            nodes[int(data[0])] = data[1:]
    return nodes


def _read_elements(lines: Sequence[str]) -> Tuple[str, np.ndarray]:
    text: Dict[str, List[int]] = {}
    current: Optional[str] = None
    for line in lines:
        if "*" in line:
            current = None
            if ("*ELEMENT" in line or "*Element" in line or "*element" in line) and (
                "TYPE=" in line or "type=" in line
            ):
                for etype in _SUPPORTED_TYPES:
                    if etype in line:
                        text.setdefault(etype, [])
                        current = etype
                        break
            continue
        if current is not None and line.strip():
            toks = [tok for tok in _split(line.rstrip().rstrip(",")) if tok]
            text[current].extend(int(t) for t in toks)

    if not text:
        raise ValueError("no supported *Element block found")
    if len(text) > 1:
        raise ValueError(
            "multiple element types are not supported "
            f"(found {sorted(text)})"  # ref: inp_info.py:125-128
        )
    etype = next(iter(text))
    row, keep = _ROW_WIDTHS[etype]
    arr = np.asarray(text[etype], dtype=np.int64).reshape(-1, row)
    return etype, arr[:, 1 : 1 + keep]


def _sequence_nodes(nodes: Dict[int, List[float]]) -> Tuple[np.ndarray, Dict[int, int]]:
    """Dict (file ids, insertion order) -> contiguous 0-based array
    (ref: inp_info.py:353-368)."""
    key2id = {key: i for i, key in enumerate(nodes)}
    arr = np.asarray(list(nodes.values()), dtype=np.float64)
    return arr, key2id


def _read_sets(
    lines: Sequence[str],
    key2id: Dict[int, int],
    require_instance: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``require_instance=True`` keeps the reference's quirk of only
    collecting sets whose keyword line mentions ``instance``
    (inp_info.py:140); the multi-block reader passes False and accepts the
    plain ``*Nset/*Elset`` layout too."""
    node_sets: Dict[str, set] = {}
    ele_sets: Dict[str, set] = {}
    target: Optional[set] = None
    is_node_set = False
    generate = False
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*":
            toks = _split(line)
            if toks[0] in ("*Nset", "*Elset") and (
                "instance" in line or not require_instance
            ):
                name = toks[1].split("=")[1]
                is_node_set = toks[0] == "*Nset"
                sets = node_sets if is_node_set else ele_sets
                sets[name] = set()
                target = sets[name]
                generate = "generate" in toks[-1]
            else:
                target = None
            continue
        if target is not None and line.strip():
            data = [int(t) for t in _split(line) if t]
            if generate:
                target |= set(range(data[0], data[1] + data[2], data[2]))
            else:
                target |= set(data)

    # file ids -> 0-based (node ids through the node renumbering map; element
    # ids are file order - 1, like the reference's blanket -1 at
    # inp_info.py:164-167)
    out_nodes = {
        name: np.asarray(sorted(key2id.get(i, i - 1) for i in ids), dtype=np.int64)
        for name, ids in node_sets.items()
    }
    out_eles = {
        name: np.asarray(sorted(i - 1 for i in ids), dtype=np.int64)
        for name, ids in ele_sets.items()
    }
    return out_nodes, out_eles


def _read_raw_surfaces(
    lines: Sequence[str],
) -> Dict[str, List[Tuple[str, str]]]:
    """``*Surface`` blocks -> {name: [(elset name, face tag 'S<k>'), ...]}."""
    raw: Dict[str, List[Tuple[str, str]]] = {}
    current: Optional[str] = None
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*":
            toks = _split(line)
            if toks[0] == "*Surface":
                current = toks[2].split("=")[1]
                raw[current] = []
            else:
                current = None
            continue
        if current is not None and line.strip():
            toks = _split(line)
            raw[current].append((toks[0], toks[1]))
    return raw


def _read_face_sets(
    lines: Sequence[str],
    elements: np.ndarray,
    element: ElementType,
    ele_sets: Dict[str, np.ndarray],
) -> Dict[str, List[Tuple[int, ...]]]:
    raw = _read_raw_surfaces(lines)
    face_sets: Dict[str, List[Tuple[int, ...]]] = {}
    for name, entries in raw.items():
        facets = set()
        for ele_set_name, face_tag in entries:
            fnum = int(face_tag.split("S")[1]) - 1
            for iele in ele_sets[ele_set_name]:
                for local_nodes in element.inp_surface_num[fnum]:
                    facets.add(tuple(sorted(int(elements[iele][ln]) for ln in local_nodes)))
        face_sets[name] = sorted(facets)
    return face_sets


def _read_dirichlet(
    lines: Sequence[str], node_sets: Dict[str, np.ndarray]
) -> List[DirichletBC]:
    out: List[DirichletBC] = []
    reading = False
    user = False
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*":
            if line[:9] == "*Boundary":
                reading = True
                user = "user" in line
            else:
                reading = False
            continue
        if reading and line.strip():
            toks = _split(line)
            value = float(toks[3]) if len(toks) >= 4 and toks[3] else 0.0
            out.append(
                DirichletBC(
                    node_set=node_sets[toks[0]],
                    dof=int(toks[1]) - 1,
                    value=value,
                    user=user,
                )
            )
    return out


def _read_neumann(
    lines: Sequence[str], face_sets: Dict[str, List[Tuple[int, ...]]]
) -> List[NeumannBC]:
    out: List[NeumannBC] = []
    reading = False
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*":
            reading = line[:7] == "*Dsload"
            continue
        if reading and line.strip():
            toks = [t for t in _split(line) if t]
            if len(toks) <= 3:
                # pressure: traction along -normal (ref: inp_info.py:256-260)
                out.append(
                    NeumannBC(face_set=face_sets[toks[0]], traction=-float(toks[2]))
                )
            else:
                out.append(
                    NeumannBC(
                        face_set=face_sets[toks[0]],
                        traction=float(toks[2]),
                        direction=np.asarray([float(t) for t in toks[3:6]]),
                    )
                )
    return out


def _read_material(lines: Sequence[str]) -> Tuple[str, List[float]]:
    material_type: Optional[str] = None
    state = None
    params: List[float] = []
    for line in lines:
        if line[:2] == "**":
            continue
        if line[:1] == "*" and line[:9] == "*Material":
            state = "material"
            continue
        if state == "material":
            material_type = line.split("*")[1].strip()
            state = "params"
            continue
        if state == "params":
            if line[:1] != "*" and line.strip():
                params = [float(t) for t in _split(line) if t]
            state = None
    if material_type is None:
        raise ValueError("no *Material block found")
    return material_type, params


def _read_nlgeom(lines: Sequence[str]) -> bool:
    for line in lines:
        if line[:5] == "*Step":
            # parity quirk: a *Step line without nlgeom= reads as nonlinear
            # (ref: inp_info.py:319-330)
            tail = line.split(",")[-1].split("nlgeom=")[-1].strip()
            return tail != "NO"
    return False


def _read_time_incs(lines: Sequence[str]) -> Dict[str, float]:
    time_incs = {"ini_inc": 1.0, "max_time": 1.0, "min_inc": 1.0e-5, "max_inc": 1.0}
    reading = False
    for line in lines:
        if line[:7] == "*Static":
            reading = True
            continue
        if reading:
            if line[:2] == "**":
                continue
            vals = [float(t) for t in _split(line) if t]
            time_incs = {
                "ini_inc": vals[0],
                "max_time": vals[1],
                "min_inc": vals[2],
                "max_inc": vals[3],
            }
            break
    if time_incs["ini_inc"] > time_incs["max_inc"]:
        time_incs["ini_inc"] = time_incs["max_inc"]
    return time_incs
