"""The yardstick's byte and operation counts against hand-computed
shapes."""

import numpy as np
import pytest
import torch

from fembench.harness import meshes, roofline


def node_pairs_host(elements, n_nodes):
    """``roofline.node_pairs`` in numpy: the cross-check."""
    npe = elements.shape[1]
    e = elements.astype(np.int64)
    a = np.repeat(e, npe, axis=1).reshape(-1)
    b = np.tile(e, (1, npe)).reshape(-1)
    return int(np.unique(a * n_nodes + b).size)


def test_node_pairs_by_hand():
    one = np.array([[0, 1, 2, 3]])
    assert node_pairs_host(one, 4) == 16
    # two tets on a shared face: 16 + 16 - 9 pairs among the face's nodes
    two = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    assert node_pairs_host(two, 5) == 23
    assert roofline.node_pairs(two, 5, torch, "cpu") == 23


def test_node_pairs_of_the_box():
    m = meshes.build({"generator": "box_tets", "nx": 3, "ny": 3, "nz": 3})
    n = m.nodes.shape[0]
    # Kuhn boxes: every node pairs with itself and its 14 edge neighbours
    # (6 axis, 6 face-diagonal, 2 body-diagonal), fewer on the boundary
    pairs = node_pairs_host(m.elements, n)
    assert pairs == roofline.node_pairs(m.elements, n, torch, "cpu")
    interior = [(i * 4 + j) * 4 + k for i in (1, 2) for j in (1, 2)
                for k in (1, 2)]
    e = m.elements.astype(np.int64)
    for v in interior:
        nbrs = set(e[(e == v).any(axis=1)].reshape(-1).tolist())
        assert len(nbrs) == 15
    assert pairs < 15 * n


def test_spmv_bytes():
    # 10 rows, 90 nonzeros in f64: 90 x (8 + 4) + 10 x (4 + 16)
    assert roofline.spmv_bytes(10, 90, 8) == 1080 + 200
    assert roofline.spmv_bytes(10, 90, 4) == 720 + 120


def test_newton_eval_work():
    nbytes, flops = roofline.newton_eval_work(5, 2, 4, 23 * 9, 8)
    assert nbytes == 5 * 3 * 8 + 2 * 4 * 4 + 15 * 8 + 23 * 9 * 8 + 15 * 8
    assert flops == 2 * roofline.C3D4_EVAL_FLOPS
    # B^T C B alone is 2 x (6 x 6 x 12 + 12 x 6 x 12) flops
    assert roofline.C3D4_EVAL_FLOPS > 2592


def test_least_seconds():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.least_seconds(kind, 8, 3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_seconds(kind, 8, 0.0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds("cpu", 8, 1.0, 1.0) is None
