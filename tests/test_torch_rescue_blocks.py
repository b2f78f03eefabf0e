"""The implicit-dynamics rescue on ``MultiBlockSystem`` (femcy_tpu's
multi-block twin of the Newmark hooks), femcy_tpu_torch against femcy_tpu,
on the CPU, in float64, on femcy_tpu's snap-through arch split at midspan
into two CPE4 blocks (tests/test_dynamic_rescue.py::
test_multiblock_dynamic_rescue's model).

- ``solve_nonlinear`` from t = 0 (it has no resume) snaps through and
  completes: success, time0 == 1.0, the apex below -2 * rise, one rescue
  record, and the minimum uy within 1e-6 relative of femcy_tpu's
  single-block rescued run (tests/test_torch_rescue.py's fixture; the port's
  single-block run matches that run's records field by field); the
  records' (Newton loops, convergence) equal the single-block run's.
- The multi-block probes at a seeded state against femcy_tpu's
  ``MultiBlockSystem``: the lumped volume diagonal (summed block by block)
  within 1e-13 relative, the Dirichlet-treated union tangent's diagonal
  within 1e-12, and the stabilization hook: with a nonzero (diagonal,
  reference, scale) the evaluation's residual and tangent within 1e-12 of
  femcy_tpu's (the packages compute element volumes and matrices in other
  orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femcy_tpu as F
from femcy_tpu.multiblock import ElementBlock as JBlock
from femcy_tpu.multiblock import MultiBlockSystem as JMulti

import femcy_tpu_torch as T
from femcy_tpu_torch import convert

from test_torch_rescue import (  # noqa: F401  (fixtures)
    RISE,
    arch_inp,
    jax_rescued,
    one_thread,
)


def _blocks(inp, pkg):
    mat = F.materials.material_from_inp(inp.material_type,
                                        inp.material_params, inp.element_type)
    half = len(inp.elements) // 2
    blocks = [JBlock(inp.elements[:half], F.elements.get_element("CPE4"),
                     mat, "l"),
              JBlock(inp.elements[half:], F.elements.get_element("CPE4"),
                     mat, "r")]
    if pkg == "jax":
        return blocks
    return [convert.element_block_from(b) for b in blocks]


def test_multiblock_rescue_matches_single_block(jax_rescued):  # noqa: F811
    inp = arch_inp()
    system = T.MultiBlockSystem(
        inp.nodes, _blocks(inp, "port"),
        T.SolverConfig(tangent="consistent", dynamic_rescue=True),
        device="cpu")
    report = system.solve_nonlinear(convert.inp_from(inp))
    assert report.success
    assert system.time0 == 1.0
    uy = system.dof.numpy().reshape(-1, 2)[:, 1]
    assert uy.min() < -2 * RISE
    assert sum(r.converged and r.residual == 0.0
               for r in report.increments) == 1
    js, jr, _ = jax_rescued
    assert [(r.newton_iters, r.converged) for r in report.increments] == [
        (r.newton_iters, r.converged) for r in jr.increments]
    uy_j = np.asarray(js.dof).reshape(-1, 2)[:, 1]
    assert uy.min() == pytest.approx(uy_j.min(), rel=1e-6)


def test_multiblock_rescue_hooks_match_jax():
    inp = arch_inp()
    cfg = dict(tangent="consistent", dynamic_rescue=True)
    js = JMulti(inp.nodes, _blocks(inp, "jax"), F.SolverConfig(**cfg))
    ts = T.MultiBlockSystem(inp.nodes, _blocks(inp, "port"),
                            T.SolverConfig(**cfg), device="cpu")
    rng = np.random.default_rng(3)
    n = ts.n_dof
    dof = rng.normal(scale=0.05, size=n)
    js.dof, ts.dof = jnp.asarray(dof), torch.as_tensor(dof)
    fixed = np.zeros(n, bool)
    fixed[[130, 131, 258, 259]] = True  # the hinges
    sval = np.zeros(n)
    rhs = rng.normal(size=n)
    args_j = (jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval))
    args_t = (torch.as_tensor(rhs), torch.as_tensor(fixed),
              torch.as_tensor(sval))

    mj = np.asarray(js._lumped_volume_diag())
    mt = ts._lumped_volume_diag().numpy()
    assert np.abs(mt - mj).max() <= 1e-13 * np.abs(mj).max()
    kj = js._tangent_diag_host(*args_j)
    kt = ts._tangent_diag_host(*args_t)
    assert np.abs(kt - kj).max() <= 1e-12 * np.abs(kj).max()

    ref = dof + rng.normal(scale=1e-3, size=n)
    js._arrs.update(stab_diag=jnp.asarray(mj), stab_ref=jnp.asarray(ref),
                    stab_scale=jnp.asarray(250.0))
    ts._stab_diag, ts._stab_ref = torch.as_tensor(mt), torch.as_tensor(ref)
    ts._stab_scale = ts._scalar(250.0)
    _, vj, rj, _ = js._jit_newton_eval(js._arrs, js.dof, *args_j)
    _, vt, rt, _ = ts._newton_eval(ts.dof, *args_t)
    for a, b in ((vt, vj), (rt, rj)):
        a, b = a.numpy(), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
