"""The equation system on the structured box: assembly + BCs + linear solve
+ load stepping + post-processing.

Torch counterpart of ``femcy_tpu.system.FEMSystem`` for its structured
branch (meshes from ``meshgen.box_tets``) and the linear static analysis:

- assembly goes from the node coordinates to the DIA layout through
  ``structured.structured_assemble_coords``: on CUDA the fused kernel
  (kernels/structured_fused, P3) for an isotropic material, else the prep
  and the accumulate kernel (kernels/structured_accumulate, P2); on the
  CPU their plain torch versions;
- Dirichlet conditions are eliminated on the DIA layout;
- the linear solve is the host direct solve below ``direct_solve_max_dof``
  dofs, the PCG above it: Jacobi, block-Jacobi or the geometric multigrid
  V-cycle (solvers/multigrid, ``preconditioner="multigrid"``), whose SpMV
  at every level but the coarsest is the DIA kernel (kernels/dia_spmv)
  unless ``SolverConfig.spmv == "slices"``;
- the adaptive load-stepping loop of ``solve`` is the JAX package's, with
  the linear branch of its increment.

Every tensor lives on the ``device`` given to ``FEMSystem`` (``"cpu"`` or
``"cuda"``; asking for CUDA without a card raises) in one float dtype
(float64 unless ``FEMCY_TPU_X64=0``, as in femcy_tpu).  Meshes without the
box structure, geometric nonlinearity and the options listed in
config._LATER raise NotImplementedError naming the slice that brings them.
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
from femcy_tpu_torch.kernels.dia_spmv import make_spmv
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.solvers.dia import (
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
    """Assemble and solve one structured box body with one material.

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
        device="cpu",
    ):
        if geometric_nonlinear:
            raise NotImplementedError(
                "geometric_nonlinear=True needs the Newton path (ROADMAP "
                "slice C and the structured Newton slice), not yet ported "
                "to femcy_tpu_torch"
            )
        box = mesh.structure is not None and mesh.structure.get("kind") == "box_tets"
        if config.preconditioner == "multigrid":
            if not box:
                raise ValueError(
                    "preconditioner='multigrid' needs a structured box_tets "
                    "mesh with the DIA layout (e.g. meshgen.box_tets)"
                )
            # fail fast, before any setup, if the grid cannot be coarsened
            info = mesh.structure
            coarsen_grids((info["nx"], info["ny"], info["nz"]))
        if not box:
            raise NotImplementedError(
                "meshes without box_tets structure need the general ELL "
                "path (ROADMAP slice B), not yet ported to femcy_tpu_torch"
            )
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch.cuda.is_available() "
                "is False; femcy_tpu_torch never falls back to the CPU"
            )
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
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

        # analytic pattern + scatter-free assembly plan (O(1) host setup)
        self.dia = build_structured_dia_pattern(mesh)
        self._structured_plan = build_structured_plan(mesh, self.dia)

        elem = mesh.element

        def tensor(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        arrs = {
            "nodes": tensor(mesh.nodes),
            "elements": tensor(mesh.elements, torch.int64),
            "dN": tensor(elem.dshape_at_gp),
            "w": tensor(elem.gauss_weights),
            "C": tensor(material.C),
        }
        # initial-configuration gradients are constant: precompute once
        arrs["dsdX0"], arrs["vol0"] = assembly.gradients_and_volume(
            arrs["nodes"], arrs["elements"], arrs["dN"], arrs["w"]
        )
        self._arrs = arrs

        # --- state ----------------------------------------------------------
        self.dof = torch.zeros(mesh.n_dof, dtype=dtype, device=device)
        self._last_vol = arrs["vol0"]  # volume of the most recent assembly
        self.time0 = 0.0
        self.time1 = 0.0
        self.dt = 0.0
        #: PCG iteration count of the most recent CG solve (0 until one ran)
        self._last_cg_iters: int = 0
        self.timer = Timer(
            verbose=config.verbose,
            sync=torch.cuda.synchronize if device.type == "cuda" else None,
        )
        #: last Dirichlet (fixed, sval) tensors applied by solve()
        self._last_dirichlet = None

        #: (prep, apply) of the DIA SpMV kernel; None = the plain slices
        self._spmv = (
            None if config.spmv == "slices"
            else make_spmv(mesh.n_dof, self.dia.offsets, device)
        )
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
        """DIA values (n_dof, K) of the stiffness on the initial
        configuration, by structured_assemble_coords' default route."""
        a = self._arrs
        return structured_assemble_coords(
            a["nodes"], self.mesh, a["dN"], a["w"], a["C"],
            self._structured_plan, C_host=np.asarray(self.material.C),
        )

    def _linear_system(self, rhs, fixed, sval):
        """Assemble + Dirichlet-eliminate for the linear path, always on the
        initial configuration (as femcy_tpu's _linear_system_impl)."""
        values = self._assemble_values()
        values, rhs = dia_dirichlet_linear(
            values, self.dia.offsets, self.dia.diag_idx, rhs, fixed, sval
        )
        return values, rhs, self._arrs["vol0"]

    def _solve_linear_system(self, values, b, fixed):
        """Direct host solve below ``direct_solve_max_dof`` dofs (or when
        forced), the DIA PCG otherwise (ref: stiffnessMtrx.py:272-276);
        ``fixed`` (the Dirichlet mask ``values`` was eliminated with) keys
        the multigrid hierarchy."""
        cfg = self.config
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto"
            and self.mesh.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            x = direct_solve(
                self.dia, values.cpu().numpy(), b.cpu().numpy()
            )
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
        x, iters, rmax = dia_pcg_solve(
            values, self.dia.offsets, self.dia.diag_idx, b,
            eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
            block_dm=self._block_dm, spmv=self._spmv,
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
                "on_newton needs the Newton path (the structured Newton "
                "slice), not yet ported to femcy_tpu_torch"
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
