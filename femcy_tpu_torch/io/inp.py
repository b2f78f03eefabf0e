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

Host copy of ``femcy_tpu.io.inp``: the single-block reader (``read_inp``)
and the multi-block one (``read_inp_multi``, ``InpBlockModel``), which the
CLI uses to route a model.
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


@dataclasses.dataclass
class InpBlockModel:
    """Multi-element-type / multi-material model (read_inp_multi).

    Beyond the reference: its reader crashes on models with more than one
    element type or material (inp_info.py:125-128); here each ``*Element``
    block keeps its own type and is mapped to its material through
    ``*Solid Section, elset=..., material=...``.
    """

    nodes: np.ndarray
    #: (element_type, elset name or "", connectivity) per *Element block
    element_blocks: List[Tuple[str, str, np.ndarray]]
    #: material name -> (material_type, params)
    materials: Dict[str, Tuple[str, List[float]]]
    #: elset name -> material name (from *Solid Section)
    sections: Dict[str, str]
    node_sets: Dict[str, np.ndarray]
    dirichlet_bcs: List[DirichletBC]
    geometric_nonlinear: bool
    time_incs: Dict[str, float]
    #: *Surface name -> sorted global node tuples (expanded per-block, since
    #: each block's element type has its own face numbering)
    face_sets: Dict[str, List[Tuple[int, ...]]] = dataclasses.field(
        default_factory=dict
    )
    neumann_bcs: List[NeumannBC] = dataclasses.field(default_factory=list)
    #: standalone *Elset blocks (0-based file element ids); used to resolve
    #: *Solid Section assignments written in the Abaqus-CAE layout
    ele_sets: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    #: per block, the 0-based file ids of its elements (file id - 1, the
    #: reference's blanket renumbering at inp_info.py:164-167)
    block_element_ids: Optional[List[np.ndarray]] = None

    @property
    def dm(self) -> int:
        return self.nodes.shape[1]

    def material_of_block(self, bi: int) -> Tuple[str, List[float]]:
        """Resolve block bi's material via its elset's *Solid Section;
        blocks without an inline ``elset=`` resolve through any standalone
        ``*Elset`` containing all of the block's elements (the Abaqus-CAE
        layout); models with a single material fall back to it (the
        reference's only mode)."""
        _, elset, _ = self.element_blocks[bi]
        key = elset.lower()
        sections = {k.lower(): v for k, v in self.sections.items()}
        mats = {k.lower(): v for k, v in self.materials.items()}
        if key in sections:
            name = sections[key].lower()
            if name in mats:
                return mats[name]
        if self.block_element_ids is not None and self.ele_sets:
            ids = self.block_element_ids[bi]
            elsets = {k.lower(): v for k, v in self.ele_sets.items()}
            resolved = []
            for sec_elset, mat_name in sections.items():
                members = elsets.get(sec_elset)
                if (
                    members is not None
                    and mat_name.lower() in mats
                    and np.isin(ids, members).all()
                ):
                    resolved.append(mat_name.lower())
            if len(set(resolved)) == 1:
                return mats[resolved[0]]
            if len(set(resolved)) > 1:
                raise ValueError(
                    f"element block {bi} (elset={elset!r}) is covered by "
                    f"*Solid Sections with different materials {resolved}"
                )
        if len(self.materials) == 1:
            return next(iter(self.materials.values()))
        raise ValueError(
            f"cannot resolve the material of element block {bi} "
            f"(elset={elset!r}); add a *Solid Section for it"
        )


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


def read_inp_multi(file_name: str) -> InpBlockModel:
    """Read a (possibly) multi-element-type / multi-material model.

    Parses every ``*Element, type=...`` block separately (with its
    ``elset`` name), all named ``*Material`` blocks, and the
    ``*Solid Section`` elset->material mapping.  Single-type single-material
    files parse identically to read_inp's view of them.
    """
    with open(file_name, "r") as fh:
        lines = fh.read().splitlines()

    nodes_dict = _read_nodes(lines)
    nodes, key2id = _sequence_nodes(nodes_dict)
    raw_blocks = _read_element_blocks(lines)
    blocks = []
    block_ids = []
    for etype, elset, arr, ids in raw_blocks:
        conv = np.vectorize(key2id.__getitem__, otypes=[np.int64])(arr)
        blocks.append((etype, elset, conv.astype(np.int32)))
        block_ids.append(ids)
    # beyond the reference's quirk: the multi-block schema also accepts
    # plain *Nset/*Elset lines (no "instance" mention required)
    node_sets, ele_sets = _read_sets(lines, key2id, require_instance=False)
    sections = _read_sections(lines)
    blocks, block_ids = _split_blocks_by_sections(
        blocks, block_ids, sections, ele_sets
    )
    dirichlet_bcs = _read_dirichlet(lines, node_sets)
    face_sets = _read_face_sets_multi(lines, blocks, ele_sets, block_ids)
    return InpBlockModel(
        nodes=nodes,
        element_blocks=blocks,
        materials=_read_materials_named(lines),
        sections=sections,
        node_sets=node_sets,
        dirichlet_bcs=dirichlet_bcs,
        geometric_nonlinear=_read_nlgeom(lines),
        time_incs=_read_time_incs(lines),
        face_sets=face_sets,
        neumann_bcs=_read_neumann(lines, face_sets),
        ele_sets=ele_sets,
        block_element_ids=block_ids,
    )


def _split_blocks_by_sections(
    blocks: List[Tuple[str, str, np.ndarray]],
    block_ids: List[np.ndarray],
    sections: Dict[str, str],
    ele_sets: Dict[str, np.ndarray],
) -> Tuple[List[Tuple[str, str, np.ndarray]], List[np.ndarray]]:
    """Split ``*Element`` blocks addressed by more than one ``*Solid
    Section`` elset — the Abaqus-CAE layout, where a part is ONE *Element
    block and materials are assigned through standalone *Elset blocks.

    Blocks whose keyword line names an elset with its own section are left
    whole (the inline layout); others are partitioned by the section elsets
    that intersect them, any uncovered remainder staying an anonymous block
    (resolvable only when the model has a single material)."""
    inline = {k.lower() for k in sections}
    elsets_l = {k.lower(): v for k, v in ele_sets.items()}
    out_blocks: List[Tuple[str, str, np.ndarray]] = []
    out_ids: List[np.ndarray] = []
    for (etype, elset, conn), ids in zip(blocks, block_ids):
        if elset and elset.lower() in inline:
            out_blocks.append((etype, elset, conn))
            out_ids.append(ids)
            continue
        hits = []
        for sec_elset in sections:
            members = elsets_l.get(sec_elset.lower())
            if members is None:
                continue
            mask = np.isin(ids, members)
            if mask.any():
                hits.append((sec_elset, mask))
        if len(hits) <= 1:
            out_blocks.append((etype, elset, conn))
            out_ids.append(ids)
            continue
        covered = np.zeros(ids.shape[0], dtype=bool)
        for sec_elset, mask in hits:
            dup = mask & covered
            if dup.any():
                raise ValueError(
                    f"element(s) {ids[dup][:5] + 1} are claimed by more "
                    "than one *Solid Section elset"
                )
            covered |= mask
            out_blocks.append((etype, sec_elset, conn[mask]))
            out_ids.append(ids[mask])
        if not covered.all():
            out_blocks.append((etype, "", conn[~covered]))
            out_ids.append(ids[~covered])
    return out_blocks, out_ids


def _read_element_blocks(
    lines: Sequence[str],
) -> List[Tuple[str, str, np.ndarray, np.ndarray]]:
    """Every supported ``*Element`` block, in file order, with elset name
    and the block's 0-based file element ids (file id - 1)."""
    blocks: List[Tuple[str, str, List[int]]] = []
    current: Optional[List[int]] = None
    for line in lines:
        if "*" in line:
            current = None
            low = line.lower()
            if "*element" in low and "type=" in low:
                etype_found = None
                for etype in _SUPPORTED_TYPES:
                    if etype in line:
                        etype_found = etype
                        break
                if etype_found is None:
                    continue
                elset = ""
                for tok in _split(line):
                    if tok.lower().startswith("elset="):
                        elset = tok.split("=", 1)[1].strip()
                current = []
                blocks.append((etype_found, elset, current))
            continue
        if current is not None and line.strip():
            toks = [tok for tok in _split(line.rstrip().rstrip(",")) if tok]
            current.extend(int(t) for t in toks)
    if not blocks:
        raise ValueError("no supported *Element block found")
    out = []
    for etype, elset, flat in blocks:
        row, keep = _ROW_WIDTHS[etype]
        arr = np.asarray(flat, dtype=np.int64).reshape(-1, row)
        out.append((etype, elset, arr[:, 1 : 1 + keep], arr[:, 0] - 1))
    return out


def _read_materials_named(
    lines: Sequence[str],
) -> Dict[str, Tuple[str, List[float]]]:
    """All ``*Material[, name=N]`` blocks -> {name: (type, params)}."""
    materials: Dict[str, Tuple[str, List[float]]] = {}
    name = None
    state = None
    mtype = None
    for line in lines:
        if line[:2] == "**":
            continue
        # case-insensitive, like the sibling _read_sections /
        # _read_element_blocks parsers (Abaqus keywords are case-free)
        if line[:1] == "*" and line[:9].lower() == "*material":
            name = ""
            for tok in _split(line):
                if tok.lower().startswith("name="):
                    name = tok.split("=", 1)[1].strip()
            state = "material"
            continue
        if state == "material":
            mtype = line.split("*")[1].strip()
            state = "params"
            continue
        if state == "params":
            if line[:1] != "*" and line.strip():
                params = [float(t) for t in _split(line) if t]
                materials[name or f"material-{len(materials)}"] = (
                    mtype, params
                )
            state = None
    if not materials:
        raise ValueError("no *Material block found")
    return materials


def _read_sections(lines: Sequence[str]) -> Dict[str, str]:
    """``*Solid Section, elset=E, material=M`` -> {E: M}."""
    sections: Dict[str, str] = {}
    for line in lines:
        low = line.lower()
        if low.startswith("*solid section"):
            elset = material = None
            for tok in _split(line):
                tl = tok.lower()
                if tl.startswith("elset="):
                    elset = tok.split("=", 1)[1].strip()
                elif tl.startswith("material="):
                    material = tok.split("=", 1)[1].strip()
            if elset and material:
                sections[elset] = material
    return sections


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


def _read_face_sets_multi(
    lines: Sequence[str],
    blocks: List[Tuple[str, str, np.ndarray]],
    ele_sets: Dict[str, np.ndarray],
    block_ids: List[np.ndarray],
) -> Dict[str, List[Tuple[int, ...]]]:
    """``*Surface`` expansion for multi-block models.

    A 0-based file element id (the reference's blanket -1 at
    inp_info.py:164-167) maps to (block, local row) through the blocks'
    own id arrays; each block's OWN element type supplies the Abaqus
    face-number -> facet-node map, so surfaces may span blocks of
    different types.
    """
    raw = _read_raw_surfaces(lines)
    if not raw:
        return {}
    id2loc: Dict[int, Tuple[int, int]] = {}
    for bi, ids in enumerate(block_ids):
        for row, eid in enumerate(ids.tolist()):
            id2loc[eid] = (bi, row)
    ele_cache: Dict[str, ElementType] = {}

    def _ele(etype: str) -> ElementType:
        if etype not in ele_cache:
            ele_cache[etype] = get_element(etype)
        return ele_cache[etype]

    face_sets: Dict[str, List[Tuple[int, ...]]] = {}
    for name, entries in raw.items():
        facets = set()
        for ele_set_name, face_tag in entries:
            fnum = int(face_tag.split("S")[1]) - 1
            for iele in ele_sets[ele_set_name]:
                bi, row = id2loc[int(iele)]
                etype, _, conn = blocks[bi]
                elem = conn[row]
                for local_nodes in _ele(etype).inp_surface_num[fnum]:
                    facets.add(
                        tuple(sorted(int(elem[ln]) for ln in local_nodes))
                    )
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
