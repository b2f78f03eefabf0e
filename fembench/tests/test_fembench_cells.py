"""Every cell run through the harness on the CPU at a small size: the
reference agrees with the program in float64; its control, the program in
float32, and the program with its answer broken underneath come out not
correct."""

import math

import pytest
import torch

from conftest import cpu_run
from femcy_tpu_torch import FEMSystem

CELLS = ["box1m.twist", "ell1m.amg_cases", "ell1m.jacobi_cases"]


def _within(result):
    return {k: c["value"] <= c["limit"] for k, c in result["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    r = cpu_run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert "setup_s" in r["metrics"]
    assert {"solve_s", "solve_s.host"} & set(r["metrics"])
    assert all(m["value"] > 0 for m in r["metrics"].values())
    for name, c in r["checks"].items():
        if name.endswith("_gap"):
            assert c["value"] < 1e-12, name


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(cell):
    r = cpu_run(cell, dtype="float32")
    assert not r["correct"]
    within = _within(r)
    # the recovered fields part float64 from float32, as on the card
    assert not within["stress_gap"] and not within["strain_gap"]


def _unchanged(monkeypatch):
    # every increment "converges" on the state it started from
    monkeypatch.setattr(FEMSystem, "_advance_inc",
                        lambda self, rhs, fixed, sval, on_newton=None:
                        (True, 0, 0.0))


def _half(monkeypatch):
    # the stress recovery leaves out every second element
    orig = FEMSystem.compute_strain_stress

    def half(self):
        strain, stress, mises = orig(self)
        stress = stress.clone()
        stress[::2] = 0.0
        return strain, stress, mises

    monkeypatch.setattr(FEMSystem, "compute_strain_stress", half)


def _altered_u(monkeypatch):
    # one free dof of the returned displacement moved by 5% of the largest
    orig = FEMSystem.solve

    def solve(self, *a, **k):
        report = orig(self, *a, **k)
        d = self.dof.clone()
        j = d.numel() // 2 + 1
        d[j] += 0.05 * float(d.abs().max())
        self.dof = d
        return report

    monkeypatch.setattr(FEMSystem, "solve", solve)


def _altered_stress(monkeypatch):
    # one stress component of one element off by a millionth of the
    # largest stress
    orig = FEMSystem.compute_strain_stress

    def altered(self):
        strain, stress, mises = orig(self)
        stress = stress.clone()
        stress.view(-1)[stress.numel() // 3] += 1e-6 * stress.abs().max()
        return strain, stress, mises

    monkeypatch.setattr(FEMSystem, "compute_strain_stress", altered)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered_u": _altered_u,
          "altered_stress": _altered_stress}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["box1m.twist", "ell1m.amg_cases"])
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = cpu_run(cell, seconds=0.0)
    assert not r["correct"], (fault, r["checks"])


def test_a_nan_fails():
    from fembench.harness import checks

    assert not checks.judge({"a": math.nan}, {"a": 1.0})
    assert not checks.judge({}, {"a": 1.0})
    assert checks.judge({"a": 1.0}, {"a": 1.0})
    assert torch.isnan(torch.tensor(math.nan))
