"""The equation system: assembly + BCs + linear solve + load stepping +
post-processing.

Torch counterpart of ``femcy_tpu.system.FEMSystem`` for the linear static
analysis of any mesh, in the JAX package's three layouts:

- a structured box (``meshgen.box_tets``, ``sparse_format`` "auto" or
  "dia"): assembly goes from the node coordinates to the analytic DIA
  layout through ``structured.structured_assemble_coords``; on CUDA the
  fused kernel (kernels/structured_fused, P3) for an isotropic material,
  else the prep and the accumulate kernel (kernels/structured_accumulate,
  P2); on the CPU their plain torch versions;
- any other mesh (or a box with ``sparse_format="ell"``): the ELL pattern
  (topology.build_pattern, native C++ code), and the general DIA layout
  when the mesh's offsets are bounded (``build_dia_pattern``, chosen
  exactly as in femcy_tpu); element stiffnesses scattered into either
  layout by the deterministic scatter kernel on CUDA (kernels/ell_scatter,
  M1) or its plain indexed add on the CPU;
- Dirichlet conditions are eliminated on the layout in use;
- the linear solve is the host direct solve below ``direct_solve_max_dof``
  dofs, the PCG above it.  On DIA: Jacobi, block-Jacobi, or (boxes only)
  the geometric multigrid V-cycle (solvers/multigrid), with the DIA SpMV
  kernel (kernels/dia_spmv, P1); on ELL: the Jacobi PCG with the ELL SpMV
  kernel (kernels/ell_spmv, M2) -- scalar Jacobi also under
  ``preconditioner="block_jacobi"``, as in femcy_tpu.  ``spmv="slices"``
  asks for the plain SpMV on either layout;
- the adaptive load-stepping loop of ``solve`` is the JAX package's, with
  the linear branch of its increment.

Every tensor lives on the ``device`` given to ``FEMSystem`` (``"cuda"`` by
default, ``"cpu"`` when asked for; CUDA without a card raises) in one float
dtype (float64 unless ``FEMCY_TPU_X64=0``, as in femcy_tpu).  Geometric
nonlinearity (the Newton slice) and the options listed in config._LATER
raise NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly, bc as bc_mod
from femcy_tpu_torch.config import SolverConfig
from femcy_tpu_torch.io.inp import InpModel
from femcy_tpu_torch.kernels import ell_spmv
from femcy_tpu_torch.kernels.dia_spmv import make_spmv
from femcy_tpu_torch.kernels.ell_scatter import build_scatter_plan, scatter
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.solvers.cg import pcg_solve
from femcy_tpu_torch.solvers.dia import (
    DIAPattern,
    build_dia_pattern,
    build_structured_dia_pattern,
    dia_dirichlet_linear,
    dia_pcg_solve,
)
from femcy_tpu_torch.solvers.direct import direct_solve
from femcy_tpu_torch.solvers.multigrid import StructuredMultigrid, coarsen_grids
from femcy_tpu_torch.structured import (
    build_structured_plan,
    structured_assemble_coords,
)
from femcy_tpu_torch.topology import ELLPattern, build_pattern
from femcy_tpu_torch.utils.device import resolve_device
from femcy_tpu_torch.utils.timing import Timer

logger = logging.getLogger("femcy_tpu_torch")


def default_dtype() -> torch.dtype:
    """float64, or float32 when FEMCY_TPU_X64=0 (the JAX package's switch)."""
    if os.environ.get("FEMCY_TPU_X64", "1") == "0":
        return torch.float32
    return torch.float64


@dataclasses.dataclass
class IncrementRecord:
    kinc: int
    time: float
    dt: float
    newton_iters: int
    residual: float
    converged: bool


@dataclasses.dataclass
class SolveReport:
    success: bool
    increments: List[IncrementRecord]
    wall_time: float
    message: str = ""
    #: energy dissipated by static stabilization; always 0 here (the
    #: option is not ported yet)
    stabilization_energy: float = 0.0

    @property
    def n_increments(self) -> int:
        return len(self.increments)


class FEMSystem:
    """Assemble and solve one body with one material.

    Parameters mirror femcy_tpu.FEMSystem (mesh, material, geometric
    nonlinearity flag, config) plus the torch ``device`` that every tensor
    of the system uses.  The dtype is ``default_dtype()``.
    """

    def __init__(
        self,
        mesh: FEMesh,
        material: Material,
        geometric_nonlinear: bool = False,
        config: SolverConfig = SolverConfig(),
        device="cuda",
    ):
        if geometric_nonlinear:
            raise NotImplementedError(
                "geometric_nonlinear=True needs the Newton path on both "
                "layouts (ROADMAP slice C, queue 1.1), not yet ported to "
                "femcy_tpu_torch"
            )
        box = mesh.structure is not None and mesh.structure.get("kind") == "box_tets"
        structured = box and config.sparse_format in ("auto", "dia")
        if config.preconditioner == "multigrid":
            if not structured:
                raise ValueError(
                    "preconditioner='multigrid' needs a structured box_tets "
                    "mesh with the DIA layout (e.g. meshgen.box_tets)"
                )
            # fail fast, before any setup, if the grid cannot be coarsened
            info = mesh.structure
            coarsen_grids((info["nx"], info["ny"], info["nz"]))
        device = resolve_device(device)
        dtype = default_dtype()

        self.mesh = mesh
        self.material = material
        self.geometric_nonlinear = False
        self.config = config
        self.device = device
        self.dtype = dtype

        nu = getattr(material, "poisson_ratio", 0.0)
        if nu >= 0.495 and dtype == torch.float32:
            logger.warning(
                "near-incompressible material (nu=%.4f) in float32: expect "
                "O(1%%) stress error; use float64 (the default)", nu,
            )

        sync = torch.cuda.synchronize if device.type == "cuda" else None
        self.pattern: Optional[ELLPattern] = None
        self.dia: Optional[DIAPattern] = None
        self._structured_plan = None
        #: element stiffness -> values scatter of the general layouts
        self._scatter_plan = None
        #: setup phase walls (seconds, synchronised on CUDA): "pattern",
        #: "dia_pattern" and "scatter_map" on the general layouts, then
        #: "upload" and "gradients"
        init_s = {}
        self._init_seconds = init_s

        def phase(name, fn):
            t = _time.perf_counter()
            out = fn()
            if sync is not None:
                sync()
            init_s[name] = _time.perf_counter() - t
            return out

        if structured:
            # analytic pattern + scatter-free assembly plan (O(1) host setup)
            self.dia = build_structured_dia_pattern(mesh)
            self._structured_plan = build_structured_plan(mesh, self.dia)
        else:
            self.pattern = phase("pattern", lambda: build_pattern(mesh))
            # gather-free DIA layout when the offset structure allows it,
            # chosen exactly as femcy_tpu does
            if config.sparse_format in ("auto", "dia"):
                dia = phase("dia_pattern", lambda: build_dia_pattern(
                    mesh, max_offsets=config.dia_max_offsets, ell=self.pattern))
                dense_enough = (
                    dia is not None
                    and dia.n_offsets * self.pattern.n_dof <= 4 * self.pattern.nnz
                )
                if dia is not None and (config.sparse_format == "dia" or dense_enough):
                    self.dia = dia
                elif config.sparse_format == "dia":
                    raise ValueError(
                        "sparse_format='dia' but the mesh has no bounded offset "
                        "structure (try a bandwidth-reducing node ordering)"
                    )
            self._scatter_plan = phase("scatter_map", lambda: build_scatter_plan(
                self.pattern, device, dia=self.dia))

        elem = mesh.element

        def tensor(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        def upload():
            arrs = {
                "nodes": tensor(mesh.nodes),
                "elements": tensor(mesh.elements, torch.int64),
                "dN": tensor(elem.dshape_at_gp),
                "w": tensor(elem.gauss_weights),
                "C": tensor(material.C),
            }
            if self.pattern is not None and self.dia is None:
                # the ELL Dirichlet elimination and Jacobi diagonal
                arrs["colidx"] = tensor(self.pattern.colidx, torch.int64)
                arrs["diag_slot"] = tensor(self.pattern.diag_slot, torch.int64)
            return arrs

        arrs = phase("upload", upload)
        # initial-configuration gradients are constant: precompute once
        arrs["dsdX0"], arrs["vol0"] = phase(
            "gradients", lambda: assembly.gradients_and_volume(
                arrs["nodes"], arrs["elements"], arrs["dN"], arrs["w"]))
        self._arrs = arrs

        # --- state ----------------------------------------------------------
        self.dof = torch.zeros(mesh.n_dof, dtype=dtype, device=device)
        self._last_vol = arrs["vol0"]  # volume of the most recent assembly
        self.time0 = 0.0
        self.time1 = 0.0
        self.dt = 0.0
        #: PCG iteration count of the most recent CG solve (0 until one ran)
        self._last_cg_iters: int = 0
        self.timer = Timer(verbose=config.verbose, sync=sync)
        #: last Dirichlet (fixed, sval) tensors applied by solve()
        self._last_dirichlet = None

        #: (prep, apply) of the SpMV kernel of the layout (P1 on DIA, M2 on
        #: ELL); None = the plain torch SpMV
        if config.spmv == "slices":
            self._spmv = None
        elif self.dia is not None:
            self._spmv = make_spmv(mesh.n_dof, self.dia.offsets, device)
        else:
            self._spmv = ell_spmv.make_spmv(self.pattern, device)
        # block Jacobi runs on the DIA layout only; the ELL PCG keeps the
        # scalar Jacobi under "block_jacobi", as femcy_tpu's does
        self._block_dm = (
            mesh.dm if config.preconditioner == "block_jacobi" else 0
        )
        # geometric multigrid (lazy: needs the fixed-dof mask, known only at
        # solve time)
        self._mg: Optional[StructuredMultigrid] = None
        self._mg_fixed_key: Optional[bytes] = None

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _assemble_values(self):
        """Values of the stiffness on the initial configuration in the
        system's layout: on the structured box by
        structured_assemble_coords' default route, else element
        stiffnesses scattered by kernels/ell_scatter (one M1 launch on
        CUDA)."""
        a = self._arrs
        if self._structured_plan is not None:
            return structured_assemble_coords(
                a["nodes"], self.mesh, a["dN"], a["w"], a["C"],
                self._structured_plan, C_host=np.asarray(self.material.C),
            )
        return scatter(self._element_stiffness(), self._scatter_plan)

    def _element_stiffness(self):
        """Element stiffnesses (E, edof, edof) on the initial configuration
        (plain torch einsum, as femcy_tpu leaves it to XLA)."""
        a = self._arrs
        return assembly.element_stiffness(a["dsdX0"], a["vol0"], a["C"])

    def _linear_system(self, rhs, fixed, sval):
        """Assemble + Dirichlet-eliminate for the linear path, always on the
        initial configuration (as femcy_tpu's _linear_system_impl)."""
        values = self._assemble_values()
        if self.dia is not None:
            values, rhs = dia_dirichlet_linear(
                values, self.dia.offsets, self.dia.diag_idx, rhs, fixed, sval
            )
        else:
            values, rhs = bc_mod.apply_dirichlet_linear(
                values, self._arrs["colidx"], self._arrs["diag_slot"], rhs,
                fixed, sval,
            )
        return values, rhs, self._arrs["vol0"]

    def _solve_linear_system(self, values, b, fixed):
        """Direct host solve below ``direct_solve_max_dof`` dofs (or when
        forced), the PCG of the layout otherwise (ref:
        stiffnessMtrx.py:272-276); ``fixed`` (the Dirichlet mask ``values``
        was eliminated with) keys the multigrid hierarchy."""
        cfg = self.config
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto"
            and self.mesh.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            pattern = self.dia if self.dia is not None else self.pattern
            x = direct_solve(pattern, values.cpu().numpy(), b.cpu().numpy())
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if cfg.preconditioner == "multigrid":
            self._ensure_multigrid(fixed)
            # <=0 means "up to n_dof", like the Jacobi path
            max_iters = cfg.cg_max_iters if cfg.cg_max_iters > 0 else self.mesh.n_dof
            x, iters, rmax = self._mg.pcg_solve(
                values, b, eps=cfg.cg_eps, max_iters=max_iters, spmv=self._spmv
            )
            if cfg.verbose:
                logger.info("MG-CG: %d iters, ||r||_inf=%.3e", iters, float(rmax))
            self._warn_cg_cap(iters, rmax, b)
            self._last_cg_iters = iters
            return x
        if self.dia is not None:
            x, iters, rmax = dia_pcg_solve(
                values, self.dia.offsets, self.dia.diag_idx, b,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                block_dm=self._block_dm, spmv=self._spmv,
            )
        else:
            x, iters, rmax = pcg_solve(
                values, self._arrs["colidx"], self._arrs["diag_slot"], b,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters, spmv=self._spmv,
            )
        if cfg.verbose:
            logger.info("CG: %d iters, ||r||_inf=%.3e", iters, float(rmax))
        self._warn_cg_cap(iters, rmax, b)
        self._last_cg_iters = iters
        return x

    def _ensure_multigrid(self, fixed):
        """Build (or rebuild, if the fixed-dof mask changed) the V-cycle
        hierarchy; it is reused across increments while the mask holds."""
        fixed_host = fixed.cpu().numpy()
        key = fixed_host.tobytes()
        if self._mg is not None and self._mg_fixed_key == key:
            return
        self._mg = StructuredMultigrid(
            self.mesh, self.material, fixed_host, dia=self.dia,
            coarse_spmv="slices" if self.config.spmv == "slices" else "auto",
            device=self.device, dtype=self.dtype,
        )
        self._mg_fixed_key = key

    def _warn_cg_cap(self, iters, rmax, b):
        """Warn when the CG exited on its iteration cap unconverged: the
        returned solution is silently truncated otherwise."""
        cap = (
            self.config.cg_max_iters
            if self.config.cg_max_iters > 0
            else self.mesh.n_dof
        )
        if iters < cap:
            return
        rmax0 = float(b.abs().max())
        if rmax0 > 0.0 and float(rmax) >= self.config.cg_eps * rmax0:
            logger.warning(
                "CG exited at the iteration cap (%d) UNCONVERGED: "
                "||r||_inf=%.3e >= eps*||r0||_inf=%.3e -- the solution is "
                "truncated; raise cg_max_iters, loosen cg_eps, or use a "
                "stronger preconditioner",
                cap, float(rmax), self.config.cg_eps * rmax0,
            )

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def solve(
        self,
        inp: InpModel,
        user_dirichlet: Optional[Callable] = None,
        on_increment: Optional[Callable] = None,
        on_newton: Optional[Callable] = None,
        resume: bool = False,
    ) -> SolveReport:
        """Run the load-stepping analysis (ref: stiffnessMtrx.py:647-711).

        The same loop as femcy_tpu.FEMSystem.solve; every increment of a
        linear analysis converges, so the cutback branch never runs here.
        ``on_newton`` needs the Newton path and raises until it is ported.
        ``resume=True`` continues from the current (dof, time0, dt) state,
        e.g. after ``load_checkpoint``.
        """
        if on_newton is not None:
            raise NotImplementedError(
                "on_newton needs the Newton path (ROADMAP queue 1.1), not "
                "yet ported to femcy_tpu_torch"
            )
        t_start = _time.time()
        cfg = self.config
        incs = inp.time_incs
        max_time = incs["max_time"]
        max_inc = incs["max_inc"]
        if not resume:
            self.dt = incs["ini_inc"]
            self.time0 = self.time1 = 0.0
            self.dof = torch.zeros_like(self.dof)

        patterns, tractions = bc_mod.build_neumann_patterns(self.mesh, inp.neumann_bcs)
        patterns_d = torch.as_tensor(patterns, dtype=self.dtype, device=self.device)
        tractions_d = torch.as_tensor(tractions, dtype=self.dtype, device=self.device)

        records: List[IncrementRecord] = []
        kinc = -1
        while self.time1 < max_time:
            kinc += 1
            self.time1 = min(self.time0 + self.dt, max_time)
            load_ratio = self.time1 / max_time
            if cfg.verbose:
                logger.info("kinc=%d time0=%.6g dt=%.6g", kinc, self.time0, self.dt)

            fixed, sval = bc_mod.build_dirichlet_arrays(
                inp.dirichlet_bcs, self.mesh, self.time1, load_ratio, user_dirichlet
            )
            fixed_d = torch.as_tensor(fixed, device=self.device)
            sval_d = torch.as_tensor(sval, dtype=self.dtype, device=self.device)
            self._last_dirichlet = (fixed_d, sval_d)
            if patterns.shape[0]:
                rhs = (tractions_d * load_ratio) @ patterns_d
            else:
                rhs = torch.zeros_like(self.dof)

            newton_loops, res = self._advance_inc(rhs, fixed_d, sval_d)

            # grow dt after fast convergence (ref: stiffnessMtrx.py:702-704)
            if newton_loops <= cfg.newton_fast_iters:
                self.dt = min(self.dt * cfg.dt_growth, max_inc)
            self.time0 = self.time1
            records.append(
                IncrementRecord(kinc, self.time1, self.dt, newton_loops, res, True)
            )
            if cfg.checkpoint_path:
                self._write_checkpoint(cfg.checkpoint_path, kinc)
            if on_increment is not None:
                on_increment(self, records[-1])

        return SolveReport(
            success=True,
            increments=records,
            wall_time=_time.time() - t_start,
            message="converged",
        )

    def _advance_inc(self, rhs, fixed, sval):
        """One load increment of the linear analysis: assemble, eliminate,
        solve.  Returns (newton_loops, final residual) = (0, 0.0)."""
        with self.timer.section("assemble+bc"):
            values, rhs_bc, vol = self._linear_system(rhs, fixed, sval)
        with self.timer.section("linear_solve"):
            self.dof = self._solve_linear_system(values, rhs_bc, fixed)
        self._last_vol = vol
        return 0, 0.0

    # ------------------------------------------------------------------ #
    # post-processing (ref: stiffnessMtrx.py:436-606)
    # ------------------------------------------------------------------ #
    def deformation_gradient(self):
        a = self._arrs
        return assembly.deformation_gradient(self.dof, a["elements"], a["dsdX0"])

    def compute_strain_stress(self):
        """(small strain, cauchy stress, mises) at every (element, GP)."""
        F = self.deformation_gradient()
        eye = torch.eye(self.mesh.dm, dtype=F.dtype, device=F.device)
        strain = (F + F.transpose(-1, -2)) / 2.0 - eye
        stress = assembly.gp_stress(F, self.material, large=False)
        return strain, stress, mises_stress(stress, self.material)

    def elastic_energy(self) -> float:
        """Total elastic energy = sum psi(F) * vol over the most recently
        assembled configuration's volumes (ref: stiffnessMtrx.py:592-606)."""
        dens = assembly.gp_energy_density(self.deformation_gradient(), self.material)
        return float((dens * self._last_vol).sum())

    def extrapolate(self, gp_vals):
        """GP -> nodal patch extrapolation, (E, G) -> (E, n_nodes)."""
        M = torch.as_tensor(
            self.mesh.element.extrapolation_matrix,
            dtype=gp_vals.dtype, device=gp_vals.device,
        )
        return gp_vals @ M.T

    # ------------------------------------------------------------------ #
    def _write_checkpoint(self, path: str, kinc: int):
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez(
            path, dof=self.dof.cpu().numpy(), time0=self.time0, dt=self.dt,
            kinc=kinc, ini_residual=np.nan,
        )

    def load_checkpoint(self, path: str):
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        self.dof = torch.as_tensor(data["dof"], dtype=self.dtype, device=self.device)
        self.time0 = self.time1 = float(data["time0"])
        self.dt = float(data["dt"])


def mises_stress(stress, material: Material):
    """Von Mises stress per (element, GP), with the material-type-specific
    out-of-plane treatment (ref: stiffnessMtrx.py:457-501)."""
    s3 = stress
    if material.type in ("planeStress", "planeStrain"):
        s3 = stress.new_zeros(stress.shape[:-2] + (3, 3))
        s3[..., :2, :2] = stress
        if material.type == "planeStrain":
            s3[..., 2, 2] = material.poisson_ratio * (
                stress[..., 0, 0] + stress[..., 1, 1]
            )
    eye = torch.eye(3, dtype=stress.dtype, device=stress.device)
    tr = s3.diagonal(dim1=-2, dim2=-1).sum(-1)
    dev = s3 - tr[..., None, None] / 3.0 * eye
    return torch.sqrt(1.5 * (dev * dev).sum(dim=(-2, -1)))
