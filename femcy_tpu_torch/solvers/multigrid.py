"""Geometric multigrid preconditioner for structured box_tets meshes.

Torch counterpart of ``femcy_tpu.solvers.multigrid``: a V-cycle over
dyadically coarsened box grids, used as the preconditioner of the CG solve.

* prolongation = separable linear interpolation on the (n+1)^3 node grid
  (slice assignments per axis), restriction = its exact transpose;
* each coarse level's operator is the analytic uniform-grid DIA matrix with
  the same Dirichlet zero-one elimination, built on the host in f64 and
  uploaded once in the working dtype;
* damped-Jacobi (or Chebyshev) smoothing with fixed sweep counts keeps the
  cycle a fixed symmetric linear operator, valid inside plain PCG;
* the coarsest level is solved with a dense inverse (host LAPACK in f64,
  then a matrix-vector product on the device).

Every operator application of levels 0 to L-2 goes through the DIA SpMV
kernel (kernels/dia_spmv.py) unless ``coarse_spmv="slices"``: level 0
through the caller's ``spmv`` pair, the coarse levels through their own
plans and transposed operands, made at setup.  The JAX package's
``newton_schulz_inverse`` (a matmul-only inverse for a TPU backend without
LAPACK) and ``operands`` (level arrays as jit arguments) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from femcy_tpu_torch.kernels import dia_spmv as k_spmv
from femcy_tpu_torch.materials import Material
from femcy_tpu_torch.mesh import FEMesh
from femcy_tpu_torch.meshgen import box_tets
from femcy_tpu_torch.solvers.dia import (
    DIAPattern,
    build_structured_dia_pattern,
    dia_spmv,
    pcg,
)
from femcy_tpu_torch.structured import (
    analytic_structured_dia_values,
    dia_dirichlet_linear_numpy,
)


def _axis_slice(ndim: int, axis: int, sl: slice):
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


def _interp_axis(u, axis: int):
    """Linear interpolation n+1 -> 2n+1 along one axis (even: copy, odd: mean)."""
    n1 = u.shape[axis]
    shape = list(u.shape)
    shape[axis] = 2 * n1 - 1
    out = u.new_zeros(shape)
    out[_axis_slice(u.ndim, axis, slice(0, None, 2))] = u
    lo = u[_axis_slice(u.ndim, axis, slice(0, -1))]
    hi = u[_axis_slice(u.ndim, axis, slice(1, None))]
    out[_axis_slice(u.ndim, axis, slice(1, None, 2))] = 0.5 * (lo + hi)
    return out


def _restrict_axis(r, axis: int):
    """Exact transpose of _interp_axis: 2n+1 -> n+1 along one axis."""
    even = r[_axis_slice(r.ndim, axis, slice(0, None, 2))]
    odd = r[_axis_slice(r.ndim, axis, slice(1, None, 2))]
    shape = list(odd.shape)
    shape[axis] = 1
    zero = odd.new_zeros(shape)
    lo = torch.cat([zero, odd], dim=axis)
    hi = torch.cat([odd, zero], dim=axis)
    return even + 0.5 * (lo + hi)


def prolong(u_coarse, grid_coarse: Tuple[int, int, int]):
    """(prod(nc+1)*3,) coarse dofs -> fine dofs on the doubled grid."""
    ncx, ncy, ncz = grid_coarse
    u = u_coarse.reshape(ncx + 1, ncy + 1, ncz + 1, 3)
    for axis in range(3):
        u = _interp_axis(u, axis)
    return u.reshape(-1)


def restrict(r_fine, grid_fine: Tuple[int, int, int]):
    """Transpose of prolong: fine dofs -> coarse dofs on the halved grid."""
    nfx, nfy, nfz = grid_fine
    r = r_fine.reshape(nfx + 1, nfy + 1, nfz + 1, 3)
    for axis in range(3):
        r = _restrict_axis(r, axis)
    return r.reshape(-1)


def _gershgorin(values_host: np.ndarray, diag_idx: int) -> float:
    """Upper bound on lambda_max(D^-1 A) from the DIA row sums (host)."""
    diag = values_host[:, diag_idx]
    s = np.abs(values_host).sum(axis=1)
    d = np.where(diag > 0.0, diag, 1.0)
    return float((s / d).max())


def coarsen_grids(
    grid: Tuple[int, int, int],
    coarsest_max_dof: int = 3000,
    n_levels: int = 0,
) -> List[Tuple[int, int, int]]:
    """Dyadic level grids fine -> coarse, or raise ValueError when the grid
    cannot be halved down to a dense-solvable coarsest level.  Callers that
    want to validate multigrid feasibility before paying for setup (e.g. at
    FEMSystem construction) call this directly."""
    grids = [tuple(int(d) for d in grid)]
    while (
        all(d % 2 == 0 and d >= 4 for d in grids[-1])
        and 3 * int(np.prod([d + 1 for d in grids[-1]])) > coarsest_max_dof
        and (n_levels <= 0 or len(grids) < n_levels)
    ):
        grids.append(tuple(d // 2 for d in grids[-1]))
    coarsest_dof = 3 * int(np.prod([d + 1 for d in grids[-1]]))
    if coarsest_dof > 4 * coarsest_max_dof:
        raise ValueError(
            f"cannot coarsen below {grids[-1]} ({coarsest_dof} dofs): "
            "grid dims should contain enough factors of 2 for multigrid"
        )
    return grids


@dataclasses.dataclass
class _Level:
    grid: Tuple[int, int, int]
    dia: DIAPattern
    #: BC-eliminated DIA operator and its inverse diagonal (None at level
    #: 0: the fine operator is the caller's, handed to each solve)
    values: Optional[torch.Tensor]
    inv_diag: Optional[torch.Tensor]
    fixed: torch.Tensor  # bool per dof
    #: the level's DIA SpMV kernel plan and (K, n) operand, or None (level 0,
    #: the coarsest level, and coarse_spmv="slices")
    spmv_plan: Optional[k_spmv.SpmvPlan] = None
    values_t: Optional[torch.Tensor] = None


_COARSE_SPMV = ("auto", "slices", "pallas")


class StructuredMultigrid:
    """V-cycle preconditioner over dyadically coarsened box_tets grids.

    Built for a specific (mesh, material, fixed-dof mask) on ``device`` in
    ``dtype``; ``precondition``/``pcg_solve`` operate on BC-eliminated
    residuals.

    smoother="chebyshev" replaces the damped-Jacobi sweeps with a
    degree-``smooth_steps`` Chebyshev polynomial in D^-1 A targeting
    [lambda_max/cheby_alpha, lambda_max], lambda_max per level from a host
    Gershgorin bound of the analytic level operator.

    coarse_spmv: "auto" and "pallas" apply the coarse levels' operators
    through the DIA SpMV kernel wrapper (the kernel on CUDA, its plain
    version on the CPU); "slices" through the plain shifted-slice SpMV.
    """

    def __init__(
        self,
        mesh: FEMesh,
        material: Material,
        fixed: np.ndarray,
        n_levels: int = 0,
        omega: float = 0.7,
        smooth_steps: int = 2,
        coarsest_max_dof: int = 3000,
        dia: Optional[DIAPattern] = None,
        smoother: str = "jacobi",
        cheby_alpha: float = 4.0,
        coarse_spmv: str = "auto",
        device="cpu",
        dtype: torch.dtype = torch.float64,
    ):
        info = mesh.structure
        if info is None or info.get("kind") != "box_tets":
            raise ValueError("StructuredMultigrid needs a meshgen.box_tets mesh")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"smoother={smoother!r}: expected 'jacobi' or "
                             "'chebyshev'")
        if coarse_spmv not in _COARSE_SPMV:
            raise ValueError(f"coarse_spmv={coarse_spmv!r}: expected one of "
                             f"{_COARSE_SPMV}")
        nx, ny, nz = info["nx"], info["ny"], info["nz"]
        lx = mesh.nodes[:, 0].max()
        ly = mesh.nodes[:, 1].max()
        lz = mesh.nodes[:, 2].max()
        self.omega = omega
        self.smooth_steps = smooth_steps
        self.material = material
        self.smoother = smoother
        self.cheby_alpha = cheby_alpha
        self.device = torch.device(device)
        self.dtype = dtype
        self._lmax: List[float] = []  # per level, Gershgorin of D^-1 A

        grids = coarsen_grids((nx, ny, nz), coarsest_max_dof, n_levels)
        self.grids = grids

        def upload(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=self.device)

        # The fine operator (level 0) is not assembled here: the cycle
        # smooths level 0 with the operator handed to each solve.  Coarse
        # operators are the analytic uniform-grid ones, O(n_dof * K) numpy.
        self.levels: List[_Level] = []
        fixed_l = np.asarray(fixed, dtype=bool)
        values_host = None  # host f64 values of the last built level
        for li, g in enumerate(grids):
            if li == 0:
                dia0 = dia if dia is not None else build_structured_dia_pattern(mesh)
                self.levels.append(
                    _Level(grid=g, dia=dia0, values=None, inv_diag=None,
                           fixed=upload(fixed_l, torch.bool))
                )
                if smoother == "chebyshev":
                    # Gershgorin bound of D^-1 A from the analytic fine
                    # operator (the BC'd runtime operator only shrinks it)
                    v0 = analytic_structured_dia_values(
                        mesh, np.asarray(material.C), dia0
                    )
                    self._lmax.append(_gershgorin(v0, dia0.diag_idx))
                continue
            mesh_l = box_tets(*g, lx, ly, lz)
            # coarse grid nodes are the even-index fine nodes; a coarse dof
            # is fixed iff its fine image is fixed
            fixed_l = self._coarsen_mask(fixed_l, grids[li - 1])
            dia_l = build_structured_dia_pattern(mesh_l)
            values_host = self._assemble_level_host(mesh_l, dia_l, fixed_l)
            if smoother == "chebyshev":
                self._lmax.append(_gershgorin(values_host, dia_l.diag_idx))
            diag = values_host[:, dia_l.diag_idx]
            level = _Level(
                grid=g,
                dia=dia_l,
                values=upload(values_host),
                inv_diag=upload(np.where(diag != 0.0, 1.0 / diag, 0.0)),
                fixed=upload(fixed_l, torch.bool),
            )
            if coarse_spmv != "slices" and li < len(grids) - 1:
                level.spmv_plan = k_spmv.spmv_plan(
                    dia_l.n_dof, dia_l.offsets, self.device
                )
                level.values_t = k_spmv.prep_values(level.spmv_plan,
                                                    level.values)
            self.levels.append(level)

        # coarsest: dense inverse (host LAPACK, f64, once).  With a single
        # level the cycle is a direct solve of the fine operator, which is
        # then assembled here (small by the coarsest_max_dof guard).
        last = self.levels[-1]
        if last.values is None:
            values_host = self._assemble_level_host(mesh, last.dia, fixed)
            last.values = upload(values_host)
        dense = last.dia.to_scipy(values_host).toarray()
        self._coarse_inv = upload(np.linalg.inv(dense))

    def _assemble_level_host(
        self, mesh_l: FEMesh, dia_l: DIAPattern, fixed_l
    ) -> np.ndarray:
        """One level's BC-eliminated operator, closed-form on the host."""
        values = analytic_structured_dia_values(
            mesh_l, np.asarray(self.material.C), dia_l
        )
        return dia_dirichlet_linear_numpy(
            values, dia_l.offsets, dia_l.diag_idx,
            np.asarray(fixed_l, dtype=bool),
        )

    @staticmethod
    def _coarsen_mask(fixed_fine: np.ndarray, grid_fine) -> np.ndarray:
        nfx, nfy, nfz = grid_fine
        m = fixed_fine.reshape(nfx + 1, nfy + 1, nfz + 1, 3)
        return np.ascontiguousarray(m[::2, ::2, ::2, :]).reshape(-1)

    # ------------------------------------------------------------------ #
    def _apply(self, li: int, x, apply0):
        """One level's operator: level 0 through the caller's apply0, the
        coarse levels through their kernel plan when one was built, else
        the plain shifted-slice SpMV."""
        if li == 0:
            return apply0(x)
        level = self.levels[li]
        if level.spmv_plan is not None:
            return k_spmv.spmv(level.spmv_plan, level.values_t, x)
        return dia_spmv(level.values, level.dia.offsets, x)

    def _smooth(self, li: int, x, b, steps: int, apply0, inv_diag):
        if self.smoother == "chebyshev":
            return self._smooth_cheby(li, x, b, steps, apply0, inv_diag)
        for _ in range(steps):
            r = b - self._apply(li, x, apply0)
            x = x + self.omega * inv_diag[li] * r
        return x

    def _smooth_cheby(self, li: int, x, b, degree: int, apply0, inv_diag):
        """Degree-``degree`` Chebyshev smoothing of D^-1 A on
        [lmax/alpha, lmax] (the standard 3-term MG smoother recurrence);
        one SpMV per degree, like one Jacobi sweep."""
        lmax = self._lmax[li] * 1.05  # safety over the Gershgorin bound
        lmin = lmax / self.cheby_alpha
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        minv = inv_diag[li]
        r = b - self._apply(li, x, apply0)
        d = (minv * r) / theta
        x = x + d
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = b - self._apply(li, x, apply0)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * (minv * r)
            x = x + d
            rho_old = rho
        return x

    def _vcycle(self, li: int, b, apply0, inv_diag):
        if li == len(self.levels) - 1:
            return self._coarse_inv @ b
        fixed, fixed_next = self.levels[li].fixed, self.levels[li + 1].fixed
        x = self._smooth(li, torch.zeros_like(b), b, self.smooth_steps,
                         apply0, inv_diag)
        r = b - self._apply(li, x, apply0)
        # keep transfers out of the fixed dofs so BC rows stay exact
        rc = restrict(r.masked_fill(fixed, 0.0), self.levels[li].grid)
        rc = rc.masked_fill(fixed_next, 0.0)
        ec = self._vcycle(li + 1, rc, apply0, inv_diag)
        e = prolong(ec.masked_fill(fixed_next, 0.0), self.levels[li + 1].grid)
        x = x + e.masked_fill(fixed, 0.0)
        return self._smooth(li, x, b, self.smooth_steps, apply0, inv_diag)

    def _fine(self, values, spmv):
        """(apply0, per-level inverse diagonals) for the fine operator
        ``values``: apply0 through the caller's (prep, apply) pair, or the
        plain SpMV when ``spmv`` is None."""
        dia = self.levels[0].dia
        if spmv is not None:
            prep, apply_fn = spmv
            operand = prep(values)

            def apply0(x):
                return apply_fn(operand, x)

        else:
            def apply0(x):
                return dia_spmv(values, dia.offsets, x)

        diag = values[:, dia.diag_idx]
        inv0 = torch.where(diag != 0.0, 1.0 / diag, torch.zeros_like(diag))
        return apply0, [inv0] + [lv.inv_diag for lv in self.levels[1:]]

    def precondition(self, values, r, spmv=None):
        """Apply one V-cycle: a fixed symmetric linear operator M^-1 r.

        ``values`` is the BC-eliminated fine DIA operator (smoothed against
        directly -- the hierarchy never stores a fine-level copy)."""
        apply0, inv_diag = self._fine(values, spmv)
        return self._vcycle(0, r, apply0, inv_diag)

    # ------------------------------------------------------------------ #
    def pcg_solve(self, values, b, eps: float = 1.0e-3, max_iters: int = 200,
                  spmv=None):
        """PCG on the fine DIA operator with the V-cycle preconditioner.

        ``values`` must be BC-eliminated with the same fixed mask the cycle
        was built with.  spmv: optional (prep, apply) pair
        (kernels.dia_spmv.make_spmv) for every fine-level operator
        application (CG body + level-0 smoothing); ``prep`` runs once.
        The iteration and stopping rule are ``solvers.dia.pcg``'s.
        Returns (x, iterations, max|r|).
        """
        apply0, inv_diag = self._fine(values, spmv)
        return pcg(apply0, lambda r: self._vcycle(0, r, apply0, inv_diag),
                   b, eps, max_iters)
