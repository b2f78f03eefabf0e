"""Boundary conditions: Dirichlet masks and precomputed Neumann patterns.

Counterpart of ``femcy_tpu.bc``.  The Dirichlet masks and the unit
Neumann patterns are built once on the host in numpy, exactly as in the
JAX package.  The elimination runs on the device: on the ELL layout here
(``apply_dirichlet_linear``, and ``apply_dirichlet_newton`` for the Newton
path), on the DIA layout in solvers/dia.py.

Neumann: the facet geometry is evaluated on the *initial* configuration and
the load enters linearly, so one unit nodal force pattern per ``*Dsload``
is precomputed and scaled by traction x load_ratio (multiple Neumann BCs
sum, as in the JAX package).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from femcy_tpu_torch.io.inp import DirichletBC, NeumannBC
from femcy_tpu_torch.mesh import FEMesh


# --------------------------------------------------------------------------- #
# Dirichlet
# --------------------------------------------------------------------------- #
def dirichlet_dof_indices(bc: DirichletBC, dm: int) -> np.ndarray:
    return np.asarray(bc.node_set, dtype=np.int64) * dm + bc.dof


def build_dirichlet_arrays(
    bcs: List[DirichletBC],
    mesh: FEMesh,
    time: float,
    load_ratio: float,
    user_fn: Optional[Callable] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Combined (fixed_mask, prescribed_values) over all Dirichlet BCs.

    Later BCs overwrite earlier ones on shared dofs (stiffnessMtrx.py:519-529).
    ``user=True`` BCs get their per-node values from ``user_fn(nodes, dof,
    time)`` (by default ``user.default_user_dirichlet``, the reference's
    rotation, user_defined/user_api.py); plain BCs use value * load_ratio
    (stiffnessMtrx.py:687-688).
    """
    n_dof = mesh.n_dof
    fixed = np.zeros(n_dof, dtype=bool)
    sval = np.zeros(n_dof, dtype=np.float64)
    for bc in bcs:
        idx = dirichlet_dof_indices(bc, mesh.dm)
        fixed[idx] = True
        if bc.user:
            if user_fn is None:
                from femcy_tpu_torch.user import default_user_dirichlet

                user_fn = default_user_dirichlet
            sval[idx] = np.asarray(user_fn(
                mesh.nodes[np.asarray(bc.node_set, dtype=np.int64)], bc.dof, time
            ))
        else:
            sval[idx] = bc.value * load_ratio
    return fixed, sval


def apply_dirichlet_linear(values, colidx, diag_slot, rhs, fixed, sval):
    """Symmetric zero-one elimination for the linear solve on the ELL
    layout: prescribed-value couplings move to the rhs
    (ref: stiffnessMtrx.py:293-298), fixed rows and columns are zeroed and
    their diagonal set to 1 (ref: stiffnessMtrx.py:300-307).

    values : (n_dof, W) ELL stiffness values
    colidx : (n_dof, W) int64 column ids (padding points at col 0 and holds
    value 0, so it stays 0 and adds nothing to the rhs)
    diag_slot : (n_dof,) int64 flat slot of each row's diagonal
    rhs, sval : (n_dof,), fixed : (n_dof,) bool

    Returns new (values, rhs); the inputs are not modified.
    """
    col_fixed = fixed[colidx]  # (n_dof, W)
    zero = values.new_zeros(())
    rhs = rhs - torch.where(col_fixed, values * sval[colidx], zero).sum(dim=1)
    rhs = torch.where(fixed, sval, rhs)
    values = torch.where(col_fixed | fixed[:, None], zero, values)
    flat = values.view(-1)
    flat[diag_slot] = torch.where(fixed, values.new_ones(()), flat[diag_slot])
    return values, rhs


def apply_dirichlet_newton(values, colidx, diag_slot, residual, fixed):
    """Newton-path Dirichlet treatment on the ELL layout: constrained
    residual rows zeroed, fixed rows and columns of the Jacobian zeroed
    and their diagonal set to 1 (ref: stiffnessMtrx.py:310-341).

    Returns new (values, residual); the inputs are not modified.
    """
    zero = values.new_zeros(())
    residual = torch.where(fixed, zero, residual)
    values = torch.where(fixed[colidx] | fixed[:, None], zero, values)
    flat = values.view(-1)
    flat[diag_slot] = torch.where(fixed, values.new_ones(()), flat[diag_slot])
    return values, residual


def pin_dof(dof, fixed, sval):
    """Write prescribed values into dof (ref: stiffnessMtrx.py:344-366)."""
    return torch.where(fixed, sval, dof)


# --------------------------------------------------------------------------- #
# Neumann
# --------------------------------------------------------------------------- #
def neumann_unit_pattern(mesh: FEMesh, bc: NeumannBC) -> np.ndarray:
    """Nodal force pattern of one ``*Dsload`` for unit traction (host, once).

    Same quadrature as the reference host loop (stiffnessMtrx.py:369-411):
    facet normals/measures from the element's facet tables on the initial
    configuration; pressure loads point along the outward normal, directional
    loads along the fixed direction.
    """
    dm = mesh.dm
    rhs = np.zeros(mesh.n_dof)
    boundary = mesh.boundary
    for facet in bc.face_set:
        ele = boundary[tuple(facet)]
        ele_nodes = mesh.elements[ele]
        ele_nodes_list = [int(n) for n in ele_nodes]
        local_facet = [ele_nodes_list.index(g) for g in facet]
        coords = mesh.nodes[ele_nodes]
        normals, aw, shape_vals = mesh.element.facet_quadrature(coords, local_facet)
        for q in range(normals.shape[0]):
            if bc.direction is None:
                flux = normals[q] * aw[q]
            else:
                flux = np.asarray(bc.direction)[:dm] * aw[q]
            for g in facet:
                nv = shape_vals[q, ele_nodes_list.index(g)]
                rhs[g * dm : g * dm + dm] += flux * nv
    return rhs


def build_neumann_patterns(mesh: FEMesh, bcs: List[NeumannBC]) -> Tuple[np.ndarray, np.ndarray]:
    """(patterns (n_bc, n_dof), tractions (n_bc,)) for all Neumann BCs."""
    if not bcs:
        return np.zeros((0, mesh.n_dof)), np.zeros((0,))
    patterns = np.stack([neumann_unit_pattern(mesh, bc) for bc in bcs])
    tractions = np.asarray([bc.traction for bc in bcs], dtype=np.float64)
    return patterns, tractions
