"""The device-loop analysis (``SolverConfig.device_loop``).

Torch counterpart of ``femcy_tpu.device_loop``.  femcy_tpu compiles the
whole adaptive-stepping Newton analysis into one XLA program; the port
keeps that program's semantics in a loop over device tensors, each decision
reading one scalar back as the host loop does (capturing it as a CUDA graph
is later work).  Where it differs from ``system.run_increments`` and
``system.run_newton`` it follows femcy_tpu's program:

* line-search and convergence probes evaluate the residual alone
  (``FEMSystem._residual_rms``); a full evaluation (residual + tangent)
  runs once per Newton iteration;
* the boost line search keeps the pre-step (dof, residual) pair when a
  step worsens the residual, where the host loop steps back and
  re-evaluates;
* relaxation backtracks by halving du while the residual grows;
* the records carry ``iters = max(k - 1, 0)`` for k Newton solves, the
  time1 of every attempt and the dt after it; ``kinc`` is rebuilt from
  the converged flags; status 1 is success, 2 a dt below ``min_inc``, 3
  the record capacity ``device_loop_max_records``;
* the linear solve is ``FEMSystem._step_solve`` (dense CG, or the Jacobi
  PCG of the layout): the multigrid, the AMG and the direct solve are
  never used, as in femcy_tpu;
* the checkpoint is written only on success;
* the schedule (time, dt) is kept in Python floats, the residuals are read
  back from the system's dtype.

Unsupported (raises ValueError, never runs the host loop instead): a linear
analysis, sharding, stabilization, dynamic rescue, refinement, and
per-increment or per-Newton callbacks.
"""

from __future__ import annotations

import math
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from femcy_tpu_torch import assembly, bc as bc_mod
from femcy_tpu_torch.utils.timing import seconds_since


def _unsupported(cfg, system, on_increment, on_newton) -> Optional[str]:
    """Why the device loop cannot run this configuration (None if it can)."""
    if not system.geometric_nonlinear:
        return ("device_loop covers geometric-nonlinear analyses (the "
                "linear path is already a single program)")
    if system._shard_sys is not None:
        return "device_loop is single-device (sharding='none')"
    if cfg.stabilize_factor > 0.0:
        return ("device_loop does not support stabilize_factor (calibration "
                "is host-side)")
    if cfg.dynamic_rescue:
        return "device_loop does not support dynamic_rescue"
    if cfg.mixed_precision_refine:
        return "device_loop does not support mixed_precision_refine"
    if on_increment is not None or on_newton is not None:
        return ("device_loop cannot invoke per-increment/per-Newton host "
                "callbacks")
    return None


class DeviceLoopProgram:
    """The device-loop analysis of one (system, model, user hook)."""

    def __init__(self, system, inp, user_dirichlet: Optional[Callable]):
        self.system = system
        self.inp = inp
        self.user_dirichlet = user_dirichlet
        mesh = system.mesh
        fixed = np.zeros(mesh.n_dof, dtype=bool)
        for bc in inp.dirichlet_bcs:
            fixed[bc_mod.dirichlet_dof_indices(bc, mesh.dm)] = True
        self.fixed = torch.as_tensor(fixed, device=system.device)
        patterns, tractions = bc_mod.build_neumann_patterns(
            mesh, inp.neumann_bcs)
        rhs_base = (tractions @ patterns if patterns.shape[0]
                    else np.zeros(mesh.n_dof))
        self.rhs_base = torch.as_tensor(rhs_base, dtype=system.dtype,
                                        device=system.device)
        incs = inp.time_incs
        self.max_time = float(incs["max_time"])
        self.min_inc = float(incs["min_inc"])
        self.max_inc = float(incs["max_inc"])
        self.ini_inc = float(incs["ini_inc"])
        self.max_records = int(system.config.device_loop_max_records)

    def _build_sval(self, time1: float, load_ratio: float):
        """Prescribed values at time1, in BC order (later BCs overwrite):
        plain BCs scale with load_ratio, ``user`` BCs call the hook at
        time1 on the host (it is numpy), uploaded once per increment."""
        sy = self.system
        _, sval = bc_mod.build_dirichlet_arrays(
            self.inp.dirichlet_bcs, sy.mesh, time1, load_ratio,
            self.user_dirichlet)
        return torch.as_tensor(sval, dtype=sy.dtype, device=sy.device)

    def _probe(self, dof, rhs, sval) -> float:
        """rms of the residual at dof, no tangent; one read-back."""
        _, res = self.system._residual_rms(dof, rhs, self.fixed, sval)
        return float(res)

    def _newton(self, dof0, rhs, sval, ini_cache: float):
        """The Newton loop of one increment (femcy_tpu's ``_newton``):
        evaluate -> solve -> update -> boost line search -> relaxation ->
        converge on res/ini < newton_rel_tol.  ``ini_cache`` is the
        analysis-lifetime initial residual (NaN until set).  Returns (dof,
        solves, res, converged, ini_cache)."""
        sy = self.system
        cfg = sy.config
        fixed = self.fixed
        dof, res0 = sy._residual_rms(dof0, rhs, fixed, sval)
        res0 = float(res0)
        if math.isnan(ini_cache):
            ini_cache = res0
        ini = ini_cache if cfg.newton_residual_ref == "global" else res0
        tiny = 1.0e-30
        pre, k, fail = res0, 0, False
        while (not fail and pre / (ini + tiny) >= cfg.newton_rel_tol
               and k < cfg.newton_max_iters and ini >= cfg.newton_abs_tol):
            dof, values, residual, _, _ = sy._newton_eval(dof, rhs, fixed,
                                                          sval)
            du = sy._step_solve(values, residual)
            dof1 = dof - du
            res1 = self._probe(dof1, rhs, sval)
            # boost (ref: stiffnessMtrx.py:792-807): while the residual
            # declined into (0.1*pre, pre), keep stepping relax*du; a step
            # that worsens it is dropped (the pre-step pair is kept) and
            # the relaxation halved
            relax, n = 1.0, 0
            while (n < cfg.newton_boost_max and 0.1 * pre < res1 < pre):
                d2 = dof1 - relax * du
                r2 = self._probe(d2, rhs, sval)
                if r2 > res1:
                    relax *= 0.5
                else:
                    dof1, res1 = d2, r2
                n += 1
            # relaxation (ref: stiffnessMtrx.py:809-819): while the residual
            # grew, undo half the step and retry
            n = 0
            while res1 > pre and n < cfg.newton_relax_max:
                dof1 = dof1 + 0.5 * du
                du = 0.5 * du
                res1 = self._probe(dof1, rhs, sval)
                n += 1
            fail = not math.isfinite(res1)
            dof, pre, k = dof1, res1, k + 1
        converged = not fail and (pre / (ini + tiny) < cfg.newton_rel_tol
                                  or ini < cfg.newton_abs_tol)
        return dof, k, pre, converged, ini_cache

    def _run(self, dof, time0: float, dt: float, ini_res: float):
        """The analysis (femcy_tpu's ``_run_impl``).  Returns the final
        (dof, time0, dt, ini_res, status) and the records as (time1, dt
        after, iters, residual, converged) tuples."""
        cfg = self.system.config
        dof_old = dof_prev = dof
        dt_prev = 0.0
        status, records = 0, []
        while status == 0:
            time1 = min(time0 + dt, self.max_time)
            load_ratio = time1 / self.max_time
            sval = self._build_sval(time1, load_ratio)
            rhs = load_ratio * self.rhs_base
            dof_start = dof
            if cfg.predictor == "extrapolate" and dt_prev > 0.0:
                alpha = (time1 - time0) / dt_prev
                dof_start = dof_old + alpha * (dof_old - dof_prev)
            dof_n, k, res, conv, ini_res = self._newton(dof_start, rhs, sval,
                                                        ini_res)
            # the host loop reports #solves - 1 on convergence; dt growth
            # compares that count (ref: stiffnessMtrx.py:702-704)
            iters = max(k - 1, 0)
            if conv and iters <= cfg.newton_fast_iters:
                dt_next = min(dt * cfg.dt_growth, self.max_inc)
            elif conv:
                dt_next = dt
            else:
                dt_next = dt * cfg.dt_cutback
            if conv:
                # the predictor pair advances on converged increments only
                dof_prev, dt_prev = dof_old, time1 - time0
                dof_old = dof_n
                time0 = time1
            dof = dof_old
            records.append((time1, dt_next, iters, res, conv))
            dt = dt_next
            if conv and time1 >= self.max_time:
                status = 1
            elif not conv and dt_next < self.min_inc:
                status = 2
            elif len(records) >= self.max_records:
                status = 3
        return dof, time0, dt, ini_res, status, records

    def run(self, resume: bool = False):
        """The analysis from t = 0 (or the system's state with
        ``resume``); returns a SolveReport and updates the system."""
        from femcy_tpu_torch.system import IncrementRecord, SolveReport

        sy = self.system
        t_start = _time.perf_counter()
        if not resume:
            sy.dt = self.ini_inc
            sy.time0 = sy.time1 = 0.0
            sy.dof = torch.zeros_like(sy.dof)
        # the analysis-lifetime initial residual is shared with the host
        # loop (ref quirk, stiffnessMtrx.py:760-762)
        ini0 = sy._ini_residual if sy._ini_residual is not None else math.nan
        dof, time0, dt, ini_out, status, recs = self._run(
            sy.dof, sy.time0, sy.dt, ini0)
        sy.dof = dof
        sy.time0 = sy.time1 = time0
        sy.dt = dt
        if math.isfinite(ini_out):
            sy._ini_residual = ini_out
        # the volumes (elastic_energy integrates over them) and the
        # Dirichlet state at the final time
        lr = sy.time1 / self.max_time if self.max_time else 1.0
        a = sy._arrs
        coords = a["nodes"] + dof.reshape(-1, sy.mesh.dm)
        _, sy._last_vol = assembly.gradients_and_volume(
            coords, a["elements"], a["dN"], a["w"])
        sy._last_dirichlet = (self.fixed, self._build_sval(sy.time1, lr))

        records: List[IncrementRecord] = []
        kinc = -1
        for time1, dt_after, iters, res, conv in recs:
            if conv:
                kinc += 1
            records.append(IncrementRecord(
                kinc=max(kinc, 0), time=time1, dt=dt_after,
                newton_iters=iters, residual=res, converged=conv))
        success = status == 1
        if status == 1:
            message = "converged"
        elif status == 2:
            message = ("allowable minimum dt reached; Newton's method did "
                       "not converge")
        else:
            message = (f"device loop hit its record capacity "
                       f"({self.max_records} increments attempted); raise "
                       "device_loop_max_records")
        if sy.config.checkpoint_path and success:
            sy._write_checkpoint(sy.config.checkpoint_path, kinc)
        return SolveReport(success=success, increments=records,
                           wall_time=seconds_since(t_start, sy.device),
                           message=message)


def device_solve(system, inp, user_dirichlet: Optional[Callable] = None,
                 resume: bool = False):
    """FEMSystem.solve's route under config.device_loop: the program is
    cached on the system per (model, user hook) object pair."""
    key = (id(inp), id(user_dirichlet))
    prog = system._device_loop_prog
    if prog is None or prog._key != key:
        prog = DeviceLoopProgram(system, inp, user_dirichlet)
        prog._key = key
        system._device_loop_prog = prog
    return prog.run(resume=resume)
