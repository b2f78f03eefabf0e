"""The C3D20 configuration and the general Newton twist on the CPU at small
sizes: the frozen brick generator builds what the program's meshgen
builds, both new cells come out correct in float64 through the harness,
their float32 controls and three planted faults do not, the reference's
shape functions and Gauss rule hold their identities, and the assembly
yardstick counts one element by hand."""

import time

import numpy as np
import pytest
import torch

from fembench.harness import bench, element_work, named
from femcy_tpu_torch import meshgen
from test_fembench_cells import FAULTS

#: the CPU sizes of the new cells' meshes
SMALL = {"hex20box.amg_cases": {"nx": 3, "ny": 3, "nz": 3},
         "ell1m.twist_jacobi": {"nx": 8}}
CELLS = sorted(SMALL)


def _spec(cell):
    spec = bench.load_spec(cell)
    spec.config["mesh"] = dict(spec.config["mesh"], **SMALL[cell])
    return spec


def _run(cell, seconds=0.3, dtype=None, mesh=None):
    spec = _spec(cell)
    spec.config["mesh"].update(mesh or {})
    result, _, _ = bench.run(spec, 2**31 + 11, seconds, False, "cpu",
                             time.perf_counter(), dtype=dtype)
    return result


@pytest.mark.parametrize("size", [(3, 4, 5), (2, 2, 1)])
def test_box_hexes20_equals_meshgen(size):
    ours = named.module("generators", "box_hexes20").build(*size)
    theirs = meshgen.box_hexes20(*size)
    assert np.array_equal(ours.nodes, theirs.nodes)
    assert np.array_equal(ours.elements, theirs.elements)
    assert ours.elements.dtype == np.int32 and ours.structure is None


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert "setup_s" in r["metrics"]
    for name, c in r["checks"].items():
        if name.endswith("_gap"):
            assert c["value"] < 1e-12, name


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(cell):
    r = _run(cell, dtype="float32")
    assert not r["correct"]
    for name in ("strain_gap", "stress_gap", "mises_gap"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"], name


@pytest.mark.parametrize("fault", ["half", "altered_u", "altered_stress"])
def test_broken_program_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    # "altered_u" moves dof n_dof // 2 + 1, a free dof on 3 x 3 x 4 bricks
    # (on 3 x 3 x 3 it is a clamped one)
    r = _run("hex20box.amg_cases", seconds=0.0, mesh={"nz": 4})
    assert not r["correct"], (fault, r["checks"])


def test_reference_shapes_and_gauss_rule():
    ref = named.module("reference", "c3d20_elastic")
    pts, w = ref.gauss_rule()
    assert pts.shape == (27, 3) and float(w.sum()) == pytest.approx(8.0)
    # xi outermost, zeta innermost
    assert pts[1, 2] == 0.0 and pts[1, 0] == pts[0, 0] == pts[2, 0] < 0
    assert pts[9, 0] == 0.0
    dN = ref.shape_derivatives(pts)
    # the shapes sum to one everywhere: their derivatives to zero
    assert float(dN.sum(1).abs().max()) < 1e-14
    # linear fields are reproduced: sum_a X_a (x) dN_a = I on the cube
    X = ref.natural_nodes()
    J = torch.einsum("ai,gaj->gij", X, dN)
    assert torch.allclose(J, torch.eye(3, dtype=torch.float64).expand_as(J),
                          atol=1e-14)


def test_element_work_by_hand():
    # C3D4, one point: J 72, inverse and det 63, grad N 72, C B 864,
    # B^T C B 1,728, vol 144
    assert element_work.element_flops(4, 1) == 2943
    # C3D20, 27 points: J 360, 63, grad N 360, C B 4,320, B^T C B 43,200,
    # vol 3,600 a point
    assert element_work.element_flops(20, 27) == 27 * 51903
    tet = np.array([[0, 1, 2, 3]])
    # read: 4 nodes x 24 + 16 connectivity + 12 x 8 rhs; write: 16 node
    # pairs x 9 x 8 + 12 x 8 rhs
    assert element_work.assembly_work(4, tet, 1, 144, 8) == (
        96 + 16 + 96 + 1152 + 96, 2943)
    brick = np.arange(20)[None]
    assert element_work.assembly_work(20, brick, 27, 9 * 400, 8) == (
        480 + 80 + 480 + 28800 + 480, 27 * 51903)


class _Trace:
    sections = {"assemble+bc": (2, 2e-3)}


def test_assemble_roofline_reads_the_sections():
    mesh = named.module("generators", "box_hexes20").build(2, 2, 2)
    run = bench.Record([], 1.0, _Trace(), mesh, 8, "NVIDIA H100 80GB HBM3",
                       torch, "cpu")
    reader = bench.metric_reader("assemble_roofline")
    least = element_work.assembly_least_seconds(run)
    # 8 bricks: flop-bound, 8 x 27 x 51,903 flops at 67 TFLOP/s
    assert least == pytest.approx(8 * 27 * 51903 / 67e12)
    assert reader.read(run) == pytest.approx(100.0 * least / 1e-3)
    run.trace = None
    assert reader.read(run) is None
    run.trace, run.device_kind = _Trace(), "cpu"
    assert reader.read(run) is None
