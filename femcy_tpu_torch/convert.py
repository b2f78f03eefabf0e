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
from femcy_tpu_torch.beam import BeamModel, BeamSection
from femcy_tpu_torch.elements import ELEMENT_REGISTRY
from femcy_tpu_torch.io.inp import DirichletBC, InpModel, NeumannBC
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.mixed import BeamBlock, MixedModel
from femcy_tpu_torch.multiblock import ElementBlock
from femcy_tpu_torch.solvers.amg import AlgebraicMultigrid, _device_levels
from femcy_tpu_torch.solvers.bell import BellPlan
from femcy_tpu_torch.solvers.dia import DIAPattern
from femcy_tpu_torch.topology import ELLPattern
from femcy_tpu_torch.utils.device import resolve_device

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


def _array_or_none(a):
    return None if a is None else np.array(a)


def ell_pattern_from(ref_pattern) -> ELLPattern:
    """ELLPattern with copies of the reference pattern's arrays (numpy)."""
    return ELLPattern(**{
        f.name: (getattr(ref_pattern, f.name)
                 if f.name in ("n_dof", "width", "node_width")
                 else _array_or_none(getattr(ref_pattern, f.name)))
        for f in dataclasses.fields(ELLPattern)
    })


def dia_pattern_from(ref_dia) -> DIAPattern:
    """DIAPattern with the reference pattern's offsets and a copy of its
    scatter map (None on the analytic structured pattern)."""
    return DIAPattern(
        n_dof=int(ref_dia.n_dof),
        offsets=tuple(int(o) for o in ref_dia.offsets),
        diag_idx=int(ref_dia.diag_idx),
        scatter_targets=_array_or_none(ref_dia.scatter_targets),
    )


def bell_plan_from(ref_plan) -> BellPlan:
    """BellPlan with copies of the reference plan's arrays."""
    return BellPlan(
        n_nodes=int(ref_plan.n_nodes), dm=int(ref_plan.dm),
        width=int(ref_plan.width), ncol=np.array(ref_plan.ncol),
        valid=np.array(ref_plan.valid),
    )


def amg_from(ref_amg, device="cuda", dtype=torch.float64) -> AlgebraicMultigrid:
    """An AlgebraicMultigrid holding the reference hierarchy's level
    arrays (its bf16 leaves read through float32, which is exact) and
    coarsest inverse, without a setup of its own; on the card unless
    ``device="cpu"`` (``utils.device.resolve_device``)."""
    device = resolve_device(device)
    def arr(a, dt=np.float32):
        return None if a is None else np.array(a, dt)

    staged = []
    for lv in ref_amg.levels:
        s = {"n_dof": int(lv.n_dof), "bs": int(lv.bs), "lmax": float(lv.lmax),
             "inv_diag": arr(lv.inv_diag)}
        for key, v, c in (("A", lv.values, lv.colidx),
                          ("P", lv.P_values, lv.P_colidx),
                          ("R", lv.R_values, lv.R_colidx)):
            if v is not None:
                s[key] = (arr(v), arr(c, np.int32))
        staged.append(s)
    amg = AlgebraicMultigrid.__new__(AlgebraicMultigrid)
    amg.device = device
    amg.dtype = dtype
    amg.smooth_steps = int(ref_amg.smooth_steps)
    amg.cheby_alpha = float(ref_amg.cheby_alpha)
    amg._fine_nnz = float(ref_amg._fine_nnz)
    amg.setup_seconds = dict(ref_amg.setup_seconds)
    amg._coarse_smooth_only = bool(ref_amg._coarse_smooth_only)
    amg._single = bool(ref_amg._single)
    amg.levels = _device_levels(staged, amg.device)
    amg._coarse_inv = torch.as_tensor(np.asarray(ref_amg._coarse_inv),
                                      dtype=dtype, device=amg.device)
    return amg


def dof_from(dof, device="cuda", dtype=torch.float64) -> torch.Tensor:
    """A dof vector given as numpy (e.g. ``np.asarray(system.dof)``), on
    the card unless ``device="cpu"``."""
    return torch.tensor(np.asarray(dof), dtype=dtype,
                        device=resolve_device(device))


def element_block_from(ref_block):
    """ElementBlock with a copy of the reference block's connectivity, the
    port's element of the same name and material of the same fields."""
    return ElementBlock(
        elements=np.array(ref_block.elements),
        element=element_from(ref_block.element),
        material=material_from(ref_block.material),
        name=ref_block.name,
    )


def blocks_from(ref_system):
    """The port's ElementBlocks of a reference MultiBlockSystem, in order."""
    return [element_block_from(b) for b in ref_system.blocks]


def beam_model_from(ref_model):
    """BeamModel with the reference model's arrays, section and lists."""
    return BeamModel(
        nodes=np.array(ref_model.nodes),
        elements=np.array(ref_model.elements),
        section=_section_from(ref_model.section),
        E=ref_model.E,
        nu=ref_model.nu,
        dirichlet=[tuple(d) for d in ref_model.dirichlet],
        loads=[tuple(d) for d in ref_model.loads],
    )


def _section_from(ref_section) -> BeamSection:
    return BeamSection(**{f.name: getattr(ref_section, f.name)
                          for f in dataclasses.fields(BeamSection)})


def beam_block_from(ref_block) -> BeamBlock:
    """BeamBlock with a copy of the reference block's connectivity, its
    section and its material constants."""
    return BeamBlock(
        elements=np.array(ref_block.elements),
        section=_section_from(ref_block.section),
        E=ref_block.E,
        nu=ref_block.nu,
        name=ref_block.name,
    )


def mixed_model_from(ref_model) -> MixedModel:
    """MixedModel with the reference model's arrays, blocks, lists and
    ``*Dsload`` BCs."""
    return MixedModel(
        nodes=np.array(ref_model.nodes),
        solid_blocks=[element_block_from(b) for b in ref_model.solid_blocks],
        beam_blocks=[beam_block_from(b) for b in ref_model.beam_blocks],
        dirichlet=[tuple(d) for d in ref_model.dirichlet],
        cloads=[tuple(d) for d in ref_model.cloads],
        neumann_bcs=[
            NeumannBC(
                list(b.face_set), b.traction,
                None if b.direction is None else np.array(b.direction),
            )
            for b in ref_model.neumann_bcs
        ],
    )
