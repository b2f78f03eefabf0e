"""Carry state across from the JAX package's objects to the port's.

Every function reads its argument by attribute and never imports
``femcy_tpu`` (which would import JAX), so the reference's objects can be
handed over in a process that has both packages, for example in the parity
tests.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from femcy_tpu_torch import materials
from femcy_tpu_torch.elements import ELEMENT_REGISTRY
from femcy_tpu_torch.io.inp import DirichletBC, InpModel, NeumannBC
from femcy_tpu_torch.mesh import FEMesh

_ELEMENT_BY_NAME = {e.name: e for e in ELEMENT_REGISTRY.values()}


def element_from(ref_element):
    """The port's ElementType of the same name (e.g. "tet4")."""
    return _ELEMENT_BY_NAME[ref_element.name]


def mesh_from(ref_mesh) -> FEMesh:
    """FEMesh with the reference mesh's nodes, elements, element and
    ``structure``."""
    return FEMesh(
        np.array(ref_mesh.nodes),
        np.array(ref_mesh.elements),
        element_from(ref_mesh.element),
        structure=copy.deepcopy(ref_mesh.structure),
    )


def inp_from(ref_inp) -> InpModel:
    """InpModel with the reference model's arrays, sets and BCs."""
    return InpModel(
        nodes=np.array(ref_inp.nodes),
        elements=np.array(ref_inp.elements),
        element_type=ref_inp.element_type,
        node_sets={k: np.array(v) for k, v in ref_inp.node_sets.items()},
        ele_sets={k: np.array(v) for k, v in ref_inp.ele_sets.items()},
        face_sets={k: list(v) for k, v in ref_inp.face_sets.items()},
        dirichlet_bcs=[
            DirichletBC(np.array(b.node_set), b.dof, b.value, b.user)
            for b in ref_inp.dirichlet_bcs
        ],
        neumann_bcs=[
            NeumannBC(
                list(b.face_set), b.traction,
                None if b.direction is None else np.array(b.direction),
            )
            for b in ref_inp.neumann_bcs
        ],
        material_type=ref_inp.material_type,
        material_params=list(ref_inp.material_params),
        geometric_nonlinear=ref_inp.geometric_nonlinear,
        time_incs=dict(ref_inp.time_incs),
    )


def material_from(ref_material) -> materials.Material:
    """The port's material of the same class and constructor fields."""
    cls = getattr(materials, type(ref_material).__name__)
    params = {
        f.name: getattr(ref_material, f.name)
        for f in dataclasses.fields(ref_material)
        if f.init
    }
    return cls(**params)


def dof_from(dof, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A dof vector given as numpy (e.g. ``np.asarray(system.dof)``)."""
    return torch.tensor(np.asarray(dof), dtype=dtype, device=device)
