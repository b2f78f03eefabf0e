"""The frozen mesh generators build what the program's meshgen builds
today."""

import numpy as np

from femcy_tpu_torch import meshgen
from fembench.harness import meshes, named


def test_box_tets_equals_meshgen():
    ours = named.module("generators", "box_tets").build(3, 4, 5)
    theirs = meshgen.box_tets(3, 4, 5)
    assert np.array_equal(ours.nodes, theirs.nodes)
    assert np.array_equal(ours.elements, theirs.elements)
    assert ours.elements.dtype == np.int32
    s = theirs.structure
    assert {k: ours.structure[k] for k in ("kind", "nx", "ny", "nz")} == {
        k: s[k] for k in ("kind", "nx", "ny", "nz")}
    assert [tuple(c) for c in ours.structure["corner_delta"]] == [
        tuple(c) for c in s["corner_delta"]]
    assert [tuple(k) for k in ours.structure["kuhn"]] == [
        tuple(k) for k in s["kuhn"]]


def test_unstructured_box_tets_equals_meshgen():
    ours = named.module("generators", "unstructured_box_tets").build(
        6, seed=0, jitter=0.2)
    theirs = meshgen.unstructured_box_tets(6, seed=0, jitter=0.2)
    assert np.array_equal(ours.nodes, theirs.nodes)
    assert np.array_equal(ours.elements, theirs.elements)
    assert ours.structure is None and theirs.structure is None


def test_build_reads_a_configuration_entry():
    m = meshes.build({"generator": "unstructured_box_tets", "nx": 4,
                      "seed": 0, "jitter": 0.2})
    assert m.elements.shape == (6 * 4 ** 3, 4)


def test_faces_of_the_unit_box():
    m = meshes.build({"generator": "box_tets", "nx": 2, "ny": 2, "nz": 2})
    bottom, top = meshes.faces(m.nodes)
    assert len(bottom) == len(top) == 9
    assert (m.nodes[bottom, 2] == 0).all() and (m.nodes[top, 2] == 1).all()
