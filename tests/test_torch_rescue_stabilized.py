"""The implicit-dynamics rescue with static stabilization also on
(``SolverConfig(dynamic_rescue=True, stabilize_factor=2e-4)``), femcy_tpu_torch
against femcy_tpu, on the CPU, in float64, on femcy_tpu's snap-through arch
(tests/test_torch_rescue.py has the model and the resumed-run helpers).

From femcy_tpu's last converged state before the snap, no increment
converges before the rescue, so the stabilization is still uncalibrated
(scale 0) when the rescue starts; the first static increment after it
calibrates C.  The records equal femcy_tpu's (kinc, Newton loops,
convergence), the rescue's record is there, and the dissipated energy
equals femcy_tpu's within 1e-6 relative (the states it integrates differ
at the solver's tolerance, not at roundoff).

Resumed one increment earlier, so that the calibration happens before the
snap, the two packages' calibrated scales differ at 2e-10 relative, the
near-singular arch amplifies that, and a Newmark step at the edge of
Newton's 24-iteration cap converges in one package and not in the other:
their rescues then settle in different basins (measured: min uy -14.07
here, -20.54 in femcy_tpu).  That case is held at the rescue itself
(tests/test_torch_rescue.py::
test_rescue_zeroes_and_restores_a_live_stabilization).
"""

import pytest

from femcy_tpu_torch import convert

from test_torch_rescue import (  # noqa: F401  (fixtures)
    arch_inp,
    jax_rescued,
    one_thread,
    jax_system,
    port_system,
    pre_snap,
    record_tuples,
    resumed,
)


def test_rescue_with_stabilization_matches_jax(jax_rescued):  # noqa: F811
    inp = arch_inp()
    state = pre_snap(jax_rescued)
    cfg = dict(dynamic_rescue=True, stabilize_factor=2e-4)
    ts, js = port_system(inp, **cfg), jax_system(inp, **cfg)
    report = resumed(ts, state, convert.inp_from(inp))
    jreport = resumed(js, state, inp)
    assert report.success and jreport.success
    assert record_tuples(report) == record_tuples(jreport)
    assert any(r.converged and r.residual == 0.0 for r in report.increments)
    assert jreport.stabilization_energy > 0.0
    assert report.stabilization_energy == pytest.approx(
        jreport.stabilization_energy, rel=1e-6)
    assert float(ts._stab_scale) > 0.0  # calibrated after the rescue
