"""Mesh container and host-side topology queries.

Replaces the reference's ``Body`` (body.py:12-234) minus the GUI: node/element
arrays, node->element adjacency, boundary facet extraction, and the surface
triangulation used by the exporters.  All pure numpy; built once per mesh.

Host copy of ``femcy_tpu.mesh`` (pure numpy): the port owns it so that
importing it never imports JAX.  tests/test_torch_host.py diffs its
output against the reference module.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, List, Tuple

import numpy as np

from femcy_tpu_torch.elements import ElementType


@dataclasses.dataclass
class FEMesh:
    nodes: np.ndarray  # (N, dm) float64
    elements: np.ndarray  # (E, n) int32
    element: ElementType
    #: optional structured-grid metadata set by meshgen (enables the dense
    #: scatter-free assembly path), e.g. {"kind": "box_tets", "nx":..,...}
    structure: dict = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        self.nodes = np.ascontiguousarray(self.nodes, dtype=np.float64)
        self.elements = np.ascontiguousarray(self.elements, dtype=np.int32)
        if self.elements.shape[1] != self.element.n_nodes:
            raise ValueError(
                f"elements have {self.elements.shape[1]} nodes but element type "
                f"{self.element.name} expects {self.element.n_nodes}"
            )

    # ------------------------------------------------------------------ #
    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elements(self) -> int:
        return self.elements.shape[0]

    @property
    def dm(self) -> int:
        return self.element.dm

    @property
    def n_dof(self) -> int:
        return self.n_nodes * self.dm

    # ------------------------------------------------------------------ #
    @cached_property
    def node_elements(self) -> List[List[int]]:
        """node -> list of adjacent element ids (ref: body.py:165-179)."""
        out: List[List[int]] = [[] for _ in range(self.n_nodes)]
        for iele, ele in enumerate(self.elements):
            for node in set(int(n) for n in ele):
                out[node].append(iele)
        return out

    @cached_property
    def boundary(self) -> Dict[Tuple[int, ...], int]:
        """boundary facet (sorted global node tuple) -> owning element.

        A facet is on the boundary iff exactly one element owns it
        (ref: body.py:197-234).
        """
        facet_count: Dict[Tuple[int, ...], List[int]] = {}
        local_facets = list(self.element.facet_natural_coos.keys())
        for iele, ele in enumerate(self.elements):
            for facet in local_facets:
                key = tuple(sorted(int(ele[i]) for i in facet))
                facet_count.setdefault(key, []).append(iele)
        return {f: owners[0] for f, owners in facet_count.items() if len(owners) == 1}

    @cached_property
    def boundary_nodes(self) -> np.ndarray:
        nodes = set()
        for facet in self.boundary:
            nodes.update(facet)
        return np.asarray(sorted(nodes), dtype=np.int64)

    # ------------------------------------------------------------------ #
    @cached_property
    def surface_triangles(self) -> Tuple[np.ndarray, np.ndarray]:
        """(triangles (T, 3) of global node ids, owning element (T,)).

        The element's local triangulation expanded globally, keeping only the
        faces owned by exactly one element (3D) or all faces (2D), mirroring
        the per-element ``getMesh`` (e.g. element_quadratic_tetrahedral.py:253-289).
        """
        tri_local = np.asarray(self.element.viz_triangles, dtype=np.int64)
        tris = self.elements[:, tri_local]  # (E, T_local, 3)
        owners = np.repeat(np.arange(self.n_elements), tri_local.shape[0])
        tris = tris.reshape(-1, 3)
        if self.dm == 2:
            return tris, owners
        key = np.sort(tris, axis=1)
        _, first, counts = np.unique(
            key, axis=0, return_index=True, return_counts=True
        )
        keep = first[counts == 1]
        return tris[keep], owners[keep]

    @cached_property
    def surface_edges(self) -> np.ndarray:
        """unique element-facet edges for 2D wireframe viz (ref: body.py:38-46)."""
        edges = set()
        for ele in self.elements:
            for facet in self.element.facet_natural_coos.keys():
                edges.add(tuple(sorted((int(ele[facet[0]]), int(ele[facet[1]])))))
        return np.asarray(sorted(edges), dtype=np.int64)
