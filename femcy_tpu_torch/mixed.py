"""Mixed B31-beam + continuum models: frame-stiffened solids.

Torch counterpart of ``femcy_tpu.mixed``: one equation system over 6-dof
nodes that carries beam blocks (all six dofs) and continuum blocks (the
three translations), so a frame-stiffened plate or solid is one model.

- ``build_union_pattern_6dof`` builds the shared ELL pattern on the host
  at node level (node-pair keys, each tagged as a continuum or a beam
  coupling; E * npe^2 keys, not femcy_tpu's E * edof^2 dof keys) and
  expands it to femcy_tpu's dof-level arrays: a node's three translation
  rows share runs of 3 columns (continuum neighbours) or 6 (beam
  neighbours), a beam node's three rotation rows share its beam
  neighbours' runs of 6, and every other row holds its diagonal alone.
- Rotation dofs of nodes no beam touches carry no stiffness and are
  constrained automatically (``n_auto_fixed``).
- Assembly: the continuum blocks' ``B^T C B`` einsum and the beams' local
  stiffness and frame congruence (``beam.element_matrices``) stay plain
  torch; the scatter of all of them into the union values, in femcy_tpu's
  order (one running sum, blocks in order), is M6
  (``kernels.mixed_scatter``).
- Solve: host direct below ``direct_solve_max_dof`` (scipy's ``spsolve``,
  as femcy_tpu), else the Jacobi ELL-PCG with M2.
- Recovery: per-block continuum stress and Mises on the translations, and
  beam end forces in the local frame.

Linear statics, as in femcy_tpu.  Every tensor lives on the ``device``
given to ``MixedSystem`` (the card unless "cpu").
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Tuple

import numpy as np
import torch

from femcy_tpu_torch import assembly, bc as bc_mod
from femcy_tpu_torch.assembly_host import element_stiffness_block_host
from femcy_tpu_torch.beam import (
    BeamSection,
    _element_frames,
    _read_beam_boundary,
    _read_beam_section,
    _read_cloads,
    element_matrices,
)
from femcy_tpu_torch.config import SolverConfig
from femcy_tpu_torch.kernels import ell_spmv
from femcy_tpu_torch.kernels import mixed_scatter
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.multiblock import ElementBlock
from femcy_tpu_torch.solvers.cg import gather_spmv, pcg_solve
from femcy_tpu_torch.system import cg_done, default_dtype, mises_stress
from femcy_tpu_torch.topology import ELLPattern, colidx_valid_mask
from femcy_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class BeamBlock:
    """One group of B31 elements sharing a section and a material."""

    elements: np.ndarray  # (E, 2) int32, 0-based into the shared nodes
    section: BeamSection
    E: float
    nu: float
    name: str = ""


@dataclasses.dataclass
class MixedModel:
    """A parsed mixed beam+solid ``.inp``."""

    nodes: np.ndarray
    solid_blocks: List[ElementBlock]
    beam_blocks: List[BeamBlock]
    #: (node, dof 0..5, value)
    dirichlet: List[Tuple[int, int, float]]
    #: (node, dof 0..5, value)
    cloads: List[Tuple[int, int, float]]
    neumann_bcs: list


@dataclasses.dataclass
class MixedResult:
    u: np.ndarray  # (N, 6)
    #: per solid block: (E, G, 3, 3) Cauchy stress and (E, G) Mises
    solid_stress: List[np.ndarray]
    solid_mises: List[np.ndarray]
    #: per beam block: (E, 12) local end forces (beam.py convention)
    beam_end_forces: List[np.ndarray]
    n_auto_fixed: int
    cg_iters: int  # 0 on the direct path


def build_union_pattern_6dof(
    n_nodes: int,
    solid_blocks: List[ElementBlock],
    beam_blocks: List[BeamBlock],
) -> Tuple[ELLPattern, List[np.ndarray]]:
    """Shared ELL pattern over the 6-dof/node layout + each block's run
    starts.

    Returns (pattern, block_positions): the pattern's arrays (``colidx``,
    ``row_counts``, ``valid``, ``diag_slot``, the CSR mirror,
    ``element_dofs``, ``force_targets``) equal femcy_tpu's
    ``_union_pattern_6dof``'s; ``block_positions[b]`` is (E_b, npe_b, S_b)
    int64: for pair (e, a) of block b, node n = elements[e, a], and local
    node k, the start of k's run in n's translation row (S_b = npe_b for a
    continuum block), and for a beam block also, at 2 + k, its start in
    n's rotation row (S_b = 4).
    """
    N = n_nodes
    # (elements, dm) of every block, continuum blocks first
    blocks = ([(np.asarray(b.elements, np.int64), 3) for b in solid_blocks]
              + [(np.asarray(b.elements, np.int64), 6) for b in beam_blocks])
    keys_per_block = [(el[:, :, None] * N + el[:, None, :]).reshape(-1)
                      for el, _ in blocks]
    uniq, inv = np.unique(np.concatenate(keys_per_block), return_inverse=True)
    inv = inv.reshape(-1)
    beam_u = np.zeros(uniq.shape[0], dtype=bool)
    start = 0
    for k, (_, dm) in zip(keys_per_block, blocks):
        if dm == 6:
            beam_u[inv[start:start + k.shape[0]]] = True
        start += k.shape[0]
    row_u, col_u = uniq // N, uniq % N
    node_start = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(row_u, minlength=N), out=node_start[1:])
    first = node_start[row_u]  # each node pair's first pair in its row
    # run widths: 3 columns for a continuum coupling, 6 where a beam
    # couples the two nodes; rotation rows hold the beam couplings alone
    w_t = np.where(beam_u, 6, 3)
    w_r = np.where(beam_u, 6, 0)
    excl_t = np.cumsum(w_t) - w_t
    excl_r = np.cumsum(w_r) - w_r
    t_start = excl_t - excl_t[first]
    r_start = excl_r - excl_r[first]
    has = node_start[1:] > node_start[:-1]
    t_count = np.bincount(row_u, weights=w_t, minlength=N).astype(np.int64)
    r_count = np.bincount(row_u, weights=w_r, minlength=N).astype(np.int64)
    beam_node = r_count > 0
    counts = np.empty((N, 6), dtype=np.int64)
    # a node no element names, and the rotations of a node no beam
    # touches, keep only the appended diagonal
    counts[:, :3] = np.where(has, t_count, 1)[:, None]
    counts[:, 3:] = np.where(beam_node, r_count, 1)[:, None]
    width = int(counts.max())

    colidx = np.zeros((N, 6, width), dtype=np.int32)
    rep = np.repeat(np.arange(uniq.shape[0]), w_t)
    j = np.arange(rep.shape[0]) - np.repeat(excl_t, w_t)
    colidx[row_u[rep], :3, t_start[rep] + j] = (6 * col_u[rep] + j)[:, None]
    rep = np.repeat(np.flatnonzero(beam_u), 6)
    j = np.tile(np.arange(6), rep.shape[0] // 6)
    colidx[row_u[rep], 3:, r_start[rep] + j] = (6 * col_u[rep] + j)[:, None]
    sub = np.arange(3)
    lone = np.flatnonzero(~has)
    colidx[lone, :3, 0] = 6 * lone[:, None] + sub
    lone = np.flatnonzero(~beam_node)
    colidx[lone, 3:, 0] = 6 * lone[:, None] + 3 + sub

    diag_pos = np.zeros((N, 6), dtype=np.int64)
    nodes_with = np.flatnonzero(has)
    self_pair = np.searchsorted(uniq, nodes_with * (N + 1))
    diag_pos[nodes_with, :3] = t_start[self_pair][:, None] + sub
    nodes_with = np.flatnonzero(beam_node)
    self_pair = np.searchsorted(uniq, nodes_with * (N + 1))
    diag_pos[nodes_with, 3:] = r_start[self_pair][:, None] + 3 + sub

    n_dof = 6 * N
    colidx = colidx.reshape(n_dof, width)
    row_counts = counts.reshape(-1)
    valid = colidx_valid_mask(colidx, row_counts)
    csr_indptr = np.zeros(n_dof + 1, dtype=np.int64)
    np.cumsum(row_counts, out=csr_indptr[1:])

    block_positions = []
    start = 0
    for k, (el, dm) in zip(keys_per_block, blocks):
        E, npe = el.shape
        iv = inv[start:start + k.shape[0]].reshape(E, npe, npe)
        pos = t_start[iv]
        if dm == 6:
            pos = np.concatenate([pos, r_start[iv]], axis=2)
        block_positions.append(pos)
        start += k.shape[0]
    element_dofs = [(el[:, :, None] * 6 + np.arange(dm)).reshape(el.shape[0], -1)
                    for el, dm in blocks]
    pattern = ELLPattern(
        n_dof=n_dof,
        width=width,
        colidx=colidx,
        row_counts=row_counts.astype(np.int32),
        valid=valid,
        diag_slot=np.arange(n_dof, dtype=np.int64) * width + diag_pos.reshape(-1),
        force_targets=np.concatenate(
            [d.reshape(-1) for d in element_dofs]).astype(np.int32),
        element_dofs=element_dofs[0].astype(np.int32),
        csr_indptr=csr_indptr,
        csr_indices=colidx[valid],
        csr_slots=np.flatnonzero(valid),
    )
    return pattern, block_positions


def union_operator_host(nodes: np.ndarray, solid_blocks, beam_blocks):
    """The raw (no-BC) f64 union operator on the host, as scipy CSR of
    (6 N, 6 N), built without the union pattern or M6's plan: each
    continuum block's host element stiffnesses (``assembly_host``) on the
    translation dofs 6 n + 0..2 of its nodes and each beam block's
    global-frame stiffnesses (in f64 on the CPU) on 6 n + 0..5, summed
    over (dof_i, dof_j) pairs by scipy.  ``pattern.to_scipy(values)``
    of an assembly must equal it: that holds the values and the pattern's
    slot of every pair."""
    import scipy.sparse as sp

    nodes = np.asarray(nodes, np.float64)
    n_dof = 6 * nodes.shape[0]
    parts = [(element_stiffness_block_host(nodes, blk.elements, blk.element,
                                           np.asarray(blk.material.C)),
              np.asarray(blk.elements, np.int64), 3)
             for blk in solid_blocks]
    for bb in beam_blocks:
        L, R = _element_frames(nodes, bb.elements, bb.section.n1)
        parts.append((element_matrices(torch.from_numpy(L),
                                       torch.from_numpy(R), bb.E, bb.nu,
                                       bb.section)[2].numpy(),
                      np.asarray(bb.elements, np.int64), 6))
    out = sp.csr_matrix((n_dof, n_dof))
    for ke, el, dm in parts:
        dofs = (6 * el[:, :, None] + np.arange(dm)).reshape(el.shape[0], -1)
        edof = dofs.shape[1]
        out = out + sp.coo_matrix(
            (ke.reshape(-1),
             (np.repeat(dofs, edof, axis=1).reshape(-1),
              np.tile(dofs, (1, edof)).reshape(-1))),
            shape=(n_dof, n_dof)).tocsr()
    return out


class MixedSystem:
    """Assemble and solve one frame-stiffened solid (linear statics).

    API of femcy_tpu.MixedSystem (nodes, solid_blocks, beam_blocks,
    config) plus the torch ``device`` of every tensor (the card unless
    "cpu"; CUDA without a card raises); the dtype is
    ``system.default_dtype()``.
    """

    def __init__(
        self,
        nodes: np.ndarray,
        solid_blocks: List[ElementBlock],
        beam_blocks: List[BeamBlock],
        config: SolverConfig = SolverConfig(),
        device="cuda",
    ):
        if not beam_blocks and not solid_blocks:
            raise ValueError("need at least one block")
        self.nodes = np.asarray(nodes, dtype=np.float64)
        if self.nodes.shape[1] != 3:
            raise ValueError("mixed beam+solid models are 3-D")
        for blk in solid_blocks:
            if blk.element.dm != 3:
                raise ValueError(
                    f"block {blk.name!r}: mixed models need 3-D continuum "
                    f"elements, got dm={blk.element.dm}"
                )
        device = resolve_device(device)
        dtype = default_dtype()
        self.solid_blocks = solid_blocks
        self.beam_blocks = beam_blocks
        self.config = config
        self.device = device
        self.dtype = dtype
        self.n_nodes = self.nodes.shape[0]
        self.n_dof = 6 * self.n_nodes

        sync = torch.cuda.synchronize if device.type == "cuda" else None
        #: setup phase walls (seconds, synchronised on CUDA)
        init_s = {}
        self._init_seconds = init_s

        def phase(name, fn):
            t = _time.perf_counter()
            out = fn()
            if sync is not None:
                sync()
            init_s[name] = _time.perf_counter() - t
            return out

        self.pattern, self._block_positions = phase(
            "union_pattern", lambda: build_union_pattern_6dof(
                self.n_nodes, solid_blocks, beam_blocks))
        #: M6's plan over every block, in femcy_tpu's block order
        self._plan = phase("plan", lambda: mixed_scatter.build_mixed_plan(
            self.n_nodes, self.pattern.width,
            [b.elements for b in solid_blocks + beam_blocks],
            [3] * len(solid_blocks) + [6] * len(beam_blocks),
            self._block_positions, device))
        # rotation dofs with no beam attached carry zero stiffness:
        # auto-constrain them (their ELL rows are the appended diagonal)
        has_rot = np.zeros(self.n_nodes, dtype=bool)
        for bb in beam_blocks:
            has_rot[np.unique(bb.elements)] = True
        auto = np.zeros((self.n_nodes, 6), dtype=bool)
        auto[~has_rot, 3:] = True
        self.auto_fixed = auto.reshape(-1)

        def tensor(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        def upload():
            # beam frames: host f64 geometry, once
            beams = []
            for bb in beam_blocks:
                L, R = _element_frames(self.nodes, bb.elements, bb.section.n1)
                k_loc, T, k_glob = element_matrices(tensor(L), tensor(R), bb.E,
                                                    bb.nu, bb.section)
                beams.append({"elements": tensor(bb.elements, torch.int64),
                              "k_loc": k_loc, "T": T,
                              "k_glob": k_glob.contiguous()})
            arrs = {
                "nodes": tensor(self.nodes),
                "colidx": tensor(self.pattern.colidx, torch.int64),
                "diag_slot": tensor(self.pattern.diag_slot, torch.int64),
            }
            solids = [{
                "elements": tensor(blk.elements, torch.int64),
                "dN": tensor(blk.element.dshape_at_gp),
                "w": tensor(blk.element.gauss_weights),
                "C": tensor(blk.material.C),
            } for blk in solid_blocks]
            for sa in solids:
                sa["dsdX0"], sa["vol0"] = assembly.gradients_and_volume(
                    arrs["nodes"], sa["elements"], sa["dN"], sa["w"])
            return arrs, solids, beams

        self._arrs, self._solid_arrs, self._beam_arrs = phase("upload", upload)
        # the Jacobi PCG's SpMV: M2 on the union pattern, or the plain one
        self._spmv = (gather_spmv(self._arrs["colidx"])
                      if config.spmv == "slices"
                      else ell_spmv.make_spmv(self.pattern, device))
        #: CG iterations of the most recent CG solve, and of every one
        self._last_cg_iters: int = 0
        self._cg_iters_log: List[int] = []
        self.dof = torch.zeros(self.n_dof, dtype=dtype, device=device)

    # ------------------------------------------------------------------ #
    def _element_matrices(self) -> List[torch.Tensor]:
        """Every block's element matrices in femcy_tpu's block order: the
        continuum blocks' Ke, then the beam blocks' global-frame k_glob."""
        kes = [assembly.element_stiffness(sa["dsdX0"], sa["vol0"],
                                          sa["C"]).contiguous()
               for sa in self._solid_arrs]
        return kes + [ba["k_glob"] for ba in self._beam_arrs]

    def _assemble(self) -> torch.Tensor:
        """The raw union values (n_dof, W): every block summed into one
        running sum by M6 (its plain version on the CPU)."""
        return mixed_scatter.scatter(self._element_matrices(), self._plan)

    def _model_arrays(self, model: MixedModel):
        """(rhs, fixed, sval) numpy arrays of ``model``'s loads and
        supports, the auto-fixed rotations among the fixed dofs."""
        fixed = self.auto_fixed.copy()
        sval = np.zeros(self.n_dof)
        for (nid, dof, val) in model.dirichlet:
            fixed[nid * 6 + dof] = True
            sval[nid * 6 + dof] = val
        rhs = np.zeros(self.n_dof)
        for (nid, dof, val) in model.cloads:
            rhs[nid * 6 + dof] += val
        if model.neumann_bcs:
            # traction patterns on the continuum skin: evaluate on a 3-dof
            # FEMesh of the (single) solid block, then restride to 6
            if len(self.solid_blocks) != 1:
                raise NotImplementedError(
                    "*Dsload on mixed models supports one solid block"
                )
            blk = self.solid_blocks[0]
            m3 = FEMesh(self.nodes, blk.elements, blk.element)
            patterns, tractions = bc_mod.build_neumann_patterns(
                m3, model.neumann_bcs
            )
            if patterns.shape[0]:
                p3 = (tractions @ patterns).reshape(-1, 3)
                r6 = rhs.reshape(-1, 6)
                r6[:, :3] += p3
                rhs = r6.reshape(-1)
        return rhs, fixed, sval

    def _linear_system(self, rhs, fixed, sval):
        """M6's union values with the linear Dirichlet elimination:
        (values_bc, b) tensors."""
        return bc_mod.apply_dirichlet_linear(
            self._assemble(), self._arrs["colidx"], self._arrs["diag_slot"],
            self._tensor(rhs), torch.as_tensor(fixed, device=self.device),
            self._tensor(sval))

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _solve_values(self, values_bc, b) -> torch.Tensor:
        """Host direct below the crossover (scipy's spsolve, as femcy_tpu),
        else the Jacobi ELL-PCG (M2); sets ``_last_cg_iters`` (0 direct)."""
        cfg = self.config
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto"
            and self.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            import scipy.sparse.linalg as spla

            A = self.pattern.to_scipy(values_bc.cpu().numpy().astype(np.float64))
            u = spla.spsolve(A.tocsc(), b.cpu().numpy().astype(np.float64))
            self._last_cg_iters = 0
            return self._tensor(u)
        x, iters, rmax = pcg_solve(
            values_bc, self._arrs["colidx"], self._arrs["diag_slot"], b,
            eps=cfg.cg_eps, max_iters=cfg.cg_max_iters, spmv=self._spmv)
        return cg_done(self, self.n_dof, "CG", x, iters, rmax, b)

    # ------------------------------------------------------------------ #
    def solve(self, model: MixedModel) -> MixedResult:
        values_bc, b = self._linear_system(*self._model_arrays(model))
        self.dof = self._solve_values(values_bc, b)
        del values_bc, b
        u6 = self.dof.reshape(self.n_nodes, 6)

        # --- recovery ----------------------------------------------------
        solid_stress, solid_mises = [], []
        ut = u6[:, :3].reshape(-1)
        for blk, sa in zip(self.solid_blocks, self._solid_arrs):
            F = assembly.deformation_gradient(ut, sa["elements"], sa["dsdX0"])
            stress = assembly.gp_stress(F, blk.material, large=False)
            solid_stress.append(stress.cpu().numpy())
            solid_mises.append(mises_stress(stress, blk.material).cpu().numpy())
        beam_forces = []
        for ba in self._beam_arrs:
            ue = u6[ba["elements"]].reshape(ba["elements"].shape[0], 12)
            f_loc = torch.einsum("eij,ejk,ek->ei", ba["k_loc"], ba["T"], ue)
            beam_forces.append(f_loc.cpu().numpy())
        return MixedResult(
            u=u6.cpu().numpy(),
            solid_stress=solid_stress,
            solid_mises=solid_mises,
            beam_end_forces=beam_forces,
            n_auto_fixed=int(self.auto_fixed.sum()),
            cg_iters=self._last_cg_iters,
        )


# --------------------------------------------------------------------------- #
# .inp front end
# --------------------------------------------------------------------------- #


def read_mixed_inp(file_name: str) -> MixedModel:
    """Parse a mixed beam+solid ``.inp``: the multi-block schema
    (io.inp.read_inp_multi) for nodes/blocks/materials/*Dsload, plus the
    beam-grade ``*Boundary`` (full dof ranges, named types), ``*Cload`` and
    ``*Beam Section`` blocks (beam.py's readers)."""
    from femcy_tpu_torch.elements import get_element
    from femcy_tpu_torch.io.inp import (
        _read_nodes,
        _read_sets,
        _sequence_nodes,
        read_inp_multi,
    )
    from femcy_tpu_torch.materials import material_from_inp

    model = read_inp_multi(file_name)
    with open(file_name, "r") as fh:
        lines = fh.read().splitlines()
    _, key2id = _sequence_nodes(_read_nodes(lines))
    node_sets, _ = _read_sets(lines, key2id, require_instance=False)

    solid_blocks: List[ElementBlock] = []
    beam_blocks: List[BeamBlock] = []
    for bi, (etype, elset, elements) in enumerate(model.element_blocks):
        mtype, params = model.material_of_block(bi)
        if etype.upper() == "B31":
            section = _read_beam_section(lines)
            if not mtype.lower().startswith("elastic"):
                raise ValueError("B31 blocks need *Elastic materials")
            beam_blocks.append(BeamBlock(
                elements=elements, section=section,
                E=params[0], nu=params[1], name=elset,
            ))
        else:
            solid_blocks.append(ElementBlock(
                elements=elements,
                element=get_element(etype),
                material=material_from_inp(mtype, params, etype),
                name=elset,
            ))
    return MixedModel(
        nodes=model.nodes,
        solid_blocks=solid_blocks,
        beam_blocks=beam_blocks,
        dirichlet=_read_beam_boundary(lines, node_sets, key2id),
        cloads=_read_cloads(lines, node_sets, key2id),
        neumann_bcs=model.neumann_bcs,
    )


def solve_mixed(model: MixedModel, config: SolverConfig = SolverConfig(),
                device="cuda") -> MixedResult:
    """One-call front end: MixedModel -> MixedResult, on ``device``."""
    system = MixedSystem(model.nodes, model.solid_blocks, model.beam_blocks,
                         config, device=device)
    return system.solve(model)
