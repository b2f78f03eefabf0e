"""The element zoo: CPS3/CPE3, CPS6/CPE6, CPS4/CPE4, CPS8/CPE8, C3D4, C3D10.

Node orderings, Gauss rules, facet tables and extrapolation coefficients match
the reference element_zoo/ exactly (cited per element below) so that Abaqus
``.inp`` meshes and face numbers mean the same thing.  Everything is static
numpy; see elements/base.py for the design rationale.

Host copy of ``femcy_tpu.elements.library`` (pure numpy): the port owns it so that
importing it never imports JAX.  tests/test_torch_host.py diffs its
output against the reference module.
"""

from __future__ import annotations

import numpy as np

from femcy_tpu_torch.elements.base import ElementType

_SQRT3 = np.sqrt(3.0)


# --------------------------------------------------------------------------- #
# Linear triangle (CPS3 / CPE3)
# ref: element_zoo/element_linear_triangular.py
# --------------------------------------------------------------------------- #
def _tri3_shape(nc):
    return np.array([nc[0], nc[1], 1.0 - nc[0] - nc[1]])


def _tri3_dshape(nc):
    return np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])


TRI3 = ElementType(
    name="tri3",
    dm=2,
    n_nodes=3,
    gauss_points=np.array([[1.0 / 3.0, 1.0 / 3.0]]),
    gauss_weights=np.array([0.5]),
    shape_fn=_tri3_shape,
    dshape_fn=_tri3_dshape,
    # ref: element_linear_triangular.py:35-53
    facet_natural_coos={
        (0, 1): [[0.5, 0.5]],
        (1, 2): [[0.0, 0.5]],
        (0, 2): [[0.5, 0.0]],
    },
    facet_point_weights={(0, 1): [1.0], (1, 2): [1.0], (0, 2): [1.0]},
    facet_natural_normals={
        (0, 1): [[np.sqrt(0.5), np.sqrt(0.5)]],
        (1, 2): [[-1.0, 0.0]],
        (0, 2): [[0.0, -1.0]],
    },
    # ref: element_linear_triangular.py:56-58
    inp_surface_num=(((0, 1),), ((1, 2),), ((0, 2),)),
    # linear element: copy the single centre GP to all nodes
    # (ref: element_linear_triangular.py:211-226)
    extrapolation_matrix=np.ones((3, 1)),
    viz_triangles=((0, 1, 2),),
)


# --------------------------------------------------------------------------- #
# Quadratic triangle (CPS6 / CPE6)
# ref: element_zoo/element_quadratic_triangular.py
# --------------------------------------------------------------------------- #
def _tri6_shape(nc):
    l = np.array([nc[0], nc[1], 1.0 - nc[0] - nc[1]])
    return np.array(
        [
            l[0] * (2.0 * l[0] - 1.0),
            l[1] * (2.0 * l[1] - 1.0),
            l[2] * (2.0 * l[2] - 1.0),
            4.0 * l[0] * l[1],
            4.0 * l[1] * l[2],
            4.0 * l[2] * l[0],
        ]
    )


def _tri6_dshape(nc):
    l = np.array([nc[0], nc[1], 1.0 - nc[0] - nc[1]])
    return np.array(
        [
            [4.0 * l[0] - 1.0, 0.0],
            [0.0, 4.0 * l[1] - 1.0],
            [1.0 - 4.0 * l[2], 1.0 - 4.0 * l[2]],
            [4.0 * l[1], 4.0 * l[0]],
            [-4.0 * l[1], 4.0 * (l[2] - l[1])],
            [4.0 * (l[2] - l[0]), -4.0 * l[0]],
        ]
    )


TRI6 = ElementType(
    name="tri6",
    dm=2,
    n_nodes=6,
    # ref: element_quadratic_triangular.py:26-33
    gauss_points=np.array(
        [[2.0 / 3.0, 1.0 / 6.0], [1.0 / 6.0, 2.0 / 3.0], [1.0 / 6.0, 1.0 / 6.0]]
    ),
    gauss_weights=np.array([1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0]),
    shape_fn=_tri6_shape,
    dshape_fn=_tri6_dshape,
    # ref: element_quadratic_triangular.py:39-67
    facet_natural_coos={
        (0, 3): [[0.5, 0.5], [1.0, 0.0]],
        (1, 3): [[0.5, 0.5], [0.0, 1.0]],
        (1, 4): [[0.0, 0.5], [0.0, 1.0]],
        (2, 4): [[0.0, 0.5], [0.0, 0.0]],
        (2, 5): [[0.5, 0.0], [0.0, 0.0]],
        (0, 5): [[0.5, 0.0], [1.0, 0.0]],
    },
    facet_point_weights={
        (0, 3): [0.5, 0.5],
        (1, 3): [0.5, 0.5],
        (1, 4): [0.5, 0.5],
        (2, 4): [0.5, 0.5],
        (2, 5): [0.5, 0.5],
        (0, 5): [0.5, 0.5],
    },
    facet_natural_normals={
        (0, 3): [[1.0, 1.0], [1.0, 1.0]],
        (1, 3): [[1.0, 1.0], [1.0, 1.0]],
        (1, 4): [[-1.0, 0.0], [-1.0, 0.0]],
        (2, 4): [[-1.0, 0.0], [-1.0, 0.0]],
        (2, 5): [[0.0, -1.0], [0.0, -1.0]],
        (0, 5): [[0.0, -1.0], [0.0, -1.0]],
    },
    inp_surface_num=(((0, 3), (3, 1)), ((1, 4), (4, 2)), ((2, 5), (5, 0))),
    # natural coords of the nodes in GP-triangle coordinates
    # (ref: element_quadratic_triangular.py:295-305)
    extrapolation_matrix=np.array(
        [
            [5.0 / 3.0, -1.0 / 3.0, -1.0 / 3.0],
            [-1.0 / 3.0, 5.0 / 3.0, -1.0 / 3.0],
            [-1.0 / 3.0, -1.0 / 3.0, 5.0 / 3.0],
            [2.0 / 3.0, 2.0 / 3.0, -1.0 / 3.0],
            [-1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0],
            [2.0 / 3.0, -1.0 / 3.0, 2.0 / 3.0],
        ]
    ),
    # ref: element_quadratic_triangular.py:244-247
    viz_triangles=((0, 3, 5), (1, 3, 4), (2, 4, 5), (3, 4, 5)),
)


# --------------------------------------------------------------------------- #
# Linear quadrilateral (CPS4 / CPE4)
# ref: element_zoo/element_linear_quadrilateral.py
# --------------------------------------------------------------------------- #
def _quad4_shape(nc):
    return np.array(
        [
            (1.0 - nc[0]) * (1.0 - nc[1]) / 4.0,
            (1.0 + nc[0]) * (1.0 - nc[1]) / 4.0,
            (1.0 + nc[0]) * (1.0 + nc[1]) / 4.0,
            (1.0 - nc[0]) * (1.0 + nc[1]) / 4.0,
        ]
    )


def _quad4_dshape(nc):
    return np.array(
        [
            [-(1.0 - nc[1]) / 4.0, -(1.0 - nc[0]) / 4.0],
            [(1.0 - nc[1]) / 4.0, -(1.0 + nc[0]) / 4.0],
            [(1.0 + nc[1]) / 4.0, (1.0 + nc[0]) / 4.0],
            [-(1.0 + nc[1]) / 4.0, (1.0 - nc[0]) / 4.0],
        ]
    )


_QUAD_GP = np.array(
    [
        [-1.0 / _SQRT3, -1.0 / _SQRT3],
        [1.0 / _SQRT3, -1.0 / _SQRT3],
        [1.0 / _SQRT3, 1.0 / _SQRT3],
        [-1.0 / _SQRT3, 1.0 / _SQRT3],
    ]
)

# extrapolation: bilinear shape functions evaluated at the nodes' stretched
# (+-sqrt(3)) coordinates (ref: element_linear_quadrilateral.py:228-238)
_QUAD4_EXTRAP = np.stack(
    [
        _quad4_shape(c)
        for c in [
            [-_SQRT3, -_SQRT3],
            [_SQRT3, -_SQRT3],
            [_SQRT3, _SQRT3],
            [-_SQRT3, _SQRT3],
        ]
    ]
)

QUAD4 = ElementType(
    name="quad4",
    dm=2,
    n_nodes=4,
    gauss_points=_QUAD_GP,
    gauss_weights=np.array([1.0, 1.0, 1.0, 1.0]),
    shape_fn=_quad4_shape,
    dshape_fn=_quad4_dshape,
    # ref: element_linear_quadrilateral.py:35-57
    facet_natural_coos={
        (0, 1): [[-1.0, -1.0], [1.0, -1.0]],
        (1, 2): [[1.0, -1.0], [1.0, 1.0]],
        (2, 3): [[1.0, 1.0], [-1.0, 1.0]],
        (0, 3): [[-1.0, 1.0], [-1.0, -1.0]],
    },
    facet_point_weights={
        (0, 1): [0.5, 0.5],
        (1, 2): [0.5, 0.5],
        (2, 3): [0.5, 0.5],
        (0, 3): [0.5, 0.5],
    },
    facet_natural_normals={
        (0, 1): [[0.0, -1.0], [0.0, -1.0]],
        (1, 2): [[1.0, 0.0], [1.0, 0.0]],
        (2, 3): [[0.0, 1.0], [0.0, 1.0]],
        (0, 3): [[-1.0, 0.0], [-1.0, 0.0]],
    },
    inp_surface_num=(((0, 1),), ((1, 2),), ((2, 3),), ((0, 3),)),
    extrapolation_matrix=_QUAD4_EXTRAP,
    viz_triangles=((0, 1, 2), (0, 2, 3)),
)


# --------------------------------------------------------------------------- #
# Quadratic (serendipity) quadrilateral (CPS8 / CPE8), reduced 2x2 integration
# ref: element_zoo/element_quadratic_quadrilateral.py
# --------------------------------------------------------------------------- #
def _quad8_shape(nc):
    return np.array(
        [
            (1.0 - nc[0]) * (1.0 - nc[1]) * (-1.0 - nc[0] - nc[1]) / 4.0,
            (1.0 + nc[0]) * (1.0 - nc[1]) * (-1.0 + nc[0] - nc[1]) / 4.0,
            (1.0 + nc[0]) * (1.0 + nc[1]) * (-1.0 + nc[0] + nc[1]) / 4.0,
            (1.0 - nc[0]) * (1.0 + nc[1]) * (-1.0 - nc[0] + nc[1]) / 4.0,
            (1.0 - nc[0] ** 2) * (1.0 - nc[1]) / 2.0,
            (1.0 - nc[1] ** 2) * (1.0 + nc[0]) / 2.0,
            (1.0 - nc[0] ** 2) * (1.0 + nc[1]) / 2.0,
            (1.0 - nc[1] ** 2) * (1.0 - nc[0]) / 2.0,
        ]
    )


def _quad8_dshape(nc):
    return np.array(
        [
            [
                -(1.0 - nc[1]) * (-2.0 * nc[0] - nc[1]) / 4.0,
                -(1.0 - nc[0]) * (-2.0 * nc[1] - nc[0]) / 4.0,
            ],
            [
                (1.0 - nc[1]) * (2.0 * nc[0] - nc[1]) / 4.0,
                -(1.0 + nc[0]) * (-2.0 * nc[1] + nc[0]) / 4.0,
            ],
            [
                (1.0 + nc[1]) * (2.0 * nc[0] + nc[1]) / 4.0,
                (1.0 + nc[0]) * (2.0 * nc[1] + nc[0]) / 4.0,
            ],
            [
                -(1.0 + nc[1]) * (-2.0 * nc[0] + nc[1]) / 4.0,
                (1.0 - nc[0]) * (2.0 * nc[1] - nc[0]) / 4.0,
            ],
            [-2.0 * nc[0] * (1.0 - nc[1]) / 2.0, -(1.0 - nc[0] ** 2) / 2.0],
            [(1.0 - nc[1] ** 2) / 2.0, -2.0 * nc[1] * (1.0 + nc[0]) / 2.0],
            [-2.0 * nc[0] * (1.0 + nc[1]) / 2.0, (1.0 - nc[0] ** 2) / 2.0],
            [-(1.0 - nc[1] ** 2) / 2.0, -2.0 * nc[1] * (1.0 - nc[0]) / 2.0],
        ]
    )


# the 8 nodes extrapolated with the *bilinear* 4-node functions at stretched
# coordinates (ref: element_quadratic_quadrilateral.py:249-301)
_QUAD8_EXTRAP = np.stack(
    [
        _quad4_shape(c)
        for c in [
            [-_SQRT3, -_SQRT3],
            [_SQRT3, -_SQRT3],
            [_SQRT3, _SQRT3],
            [-_SQRT3, _SQRT3],
            [0.0, -_SQRT3],
            [_SQRT3, 0.0],
            [0.0, _SQRT3],
            [-_SQRT3, 0.0],
        ]
    ]
)

QUAD8 = ElementType(
    name="quad8",
    dm=2,
    n_nodes=8,
    gauss_points=_QUAD_GP,  # reduced integration, kept for parity
    gauss_weights=np.array([1.0, 1.0, 1.0, 1.0]),
    shape_fn=_quad8_shape,
    dshape_fn=_quad8_dshape,
    # ref: element_quadratic_quadrilateral.py:36-57
    facet_natural_coos={
        (0, 4): [[-1.0, -1.0], [0.0, -1.0]],
        (1, 4): [[1.0, -1.0], [0.0, -1.0]],
        (1, 5): [[1.0, -1.0], [1.0, 0.0]],
        (2, 5): [[1.0, 1.0], [1.0, 0.0]],
        (2, 6): [[1.0, 1.0], [0.0, 1.0]],
        (3, 6): [[-1.0, 1.0], [0.0, 1.0]],
        (0, 7): [[-1.0, 1.0], [-1.0, 0.0]],
        (3, 7): [[-1.0, -1.0], [-1.0, 0.0]],
    },
    facet_point_weights={
        (0, 4): [0.5, 0.5],
        (1, 4): [0.5, 0.5],
        (1, 5): [0.5, 0.5],
        (2, 5): [0.5, 0.5],
        (2, 6): [0.5, 0.5],
        (3, 6): [0.5, 0.5],
        (0, 7): [0.5, 0.5],
        (3, 7): [0.5, 0.5],
    },
    facet_natural_normals={
        (0, 4): [[0.0, -1.0], [0.0, -1.0]],
        (1, 4): [[0.0, -1.0], [0.0, -1.0]],
        (1, 5): [[1.0, 0.0], [1.0, 0.0]],
        (2, 5): [[1.0, 0.0], [1.0, 0.0]],
        (2, 6): [[0.0, 1.0], [0.0, 1.0]],
        (3, 6): [[0.0, 1.0], [0.0, 1.0]],
        (0, 7): [[-1.0, 0.0], [-1.0, 0.0]],
        (3, 7): [[-1.0, 0.0], [-1.0, 0.0]],
    },
    inp_surface_num=(
        ((0, 4), (1, 4)),
        ((1, 5), (2, 5)),
        ((2, 6), (3, 6)),
        ((0, 7), (3, 7)),
    ),
    extrapolation_matrix=_QUAD8_EXTRAP,
    # ref: element_quadratic_quadrilateral.py:227-231
    viz_triangles=((0, 4, 7), (1, 4, 5), (2, 5, 6), (3, 6, 7), (5, 6, 7), (4, 5, 7)),
)


# --------------------------------------------------------------------------- #
# Linear tetrahedron (C3D4)
# ref: element_zoo/element_linear_tetrahedral.py
# --------------------------------------------------------------------------- #
def _tet4_shape(nc):
    return np.array([nc[2], nc[0], 1.0 - nc[0] - nc[1] - nc[2], nc[1]])


def _tet4_dshape(nc):
    return np.array(
        [
            [0.0, 0.0, 1.0],
            [1.0, 0.0, 0.0],
            [-1.0, -1.0, -1.0],
            [0.0, 1.0, 0.0],
        ]
    )


TET4 = ElementType(
    name="tet4",
    dm=3,
    n_nodes=4,
    gauss_points=np.array([[0.25, 0.25, 0.25]]),
    gauss_weights=np.array([1.0 / 6.0]),
    shape_fn=_tet4_shape,
    dshape_fn=_tet4_dshape,
    # ref: element_linear_tetrahedral.py:38-59
    facet_natural_coos={
        (1, 2, 3): [[1.0 / 3.0, 1.0 / 3.0, 0.0]],
        (0, 2, 3): [[0.0, 1.0 / 3.0, 1.0 / 3.0]],
        (0, 1, 3): [[1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0]],
        (0, 1, 2): [[1.0 / 3.0, 0.0, 1.0 / 3.0]],
    },
    facet_point_weights={
        (1, 2, 3): [1.0],
        (0, 2, 3): [1.0],
        (0, 1, 3): [1.0],
        (0, 1, 2): [1.0],
    },
    facet_natural_normals={
        (1, 2, 3): [[0.0, 0.0, -1.0]],
        (0, 2, 3): [[-1.0, 0.0, 0.0]],
        (0, 1, 3): [[1.0, 1.0, 1.0]],
        (0, 1, 2): [[0.0, -1.0, 0.0]],
    },
    # ref: element_linear_tetrahedral.py:61-64
    inp_surface_num=(((0, 1, 2),), ((0, 1, 3),), ((1, 2, 3),), ((0, 2, 3),)),
    extrapolation_matrix=np.ones((4, 1)),
    viz_triangles=((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
)


# --------------------------------------------------------------------------- #
# Quadratic tetrahedron (C3D10)
# ref: element_zoo/element_quadratic_tetrahedral.py
# --------------------------------------------------------------------------- #
def _tet10_lambdas(nc):
    return np.array([nc[2], nc[0], 1.0 - nc[0] - nc[1] - nc[2], nc[1]])


def _tet10_shape(nc):
    l = _tet10_lambdas(nc)
    return np.array(
        [
            l[0] * (2.0 * l[0] - 1.0),
            l[1] * (2.0 * l[1] - 1.0),
            l[2] * (2.0 * l[2] - 1.0),
            l[3] * (2.0 * l[3] - 1.0),
            4.0 * l[0] * l[1],
            4.0 * l[1] * l[2],
            4.0 * l[2] * l[0],
            4.0 * l[0] * l[3],
            4.0 * l[3] * l[1],
            4.0 * l[2] * l[3],
        ]
    )


def _tet10_dshape(nc):
    l = _tet10_lambdas(nc)
    return np.array(
        [
            [0.0, 0.0, 4.0 * l[0] - 1.0],
            [4.0 * l[1] - 1.0, 0.0, 0.0],
            [1.0 - 4.0 * l[2], 1.0 - 4.0 * l[2], 1.0 - 4.0 * l[2]],
            [0.0, 4.0 * l[3] - 1.0, 0.0],
            [4.0 * l[0], 0.0, 4.0 * l[1]],
            [4.0 * (l[2] - l[1]), -4.0 * l[1], -4.0 * l[1]],
            [-4.0 * l[0], -4.0 * l[0], 4.0 * (l[2] - l[0])],
            [0.0, 4.0 * l[0], 4.0 * l[3]],
            [4.0 * l[3], 4.0 * l[1], 0.0],
            [-4.0 * l[3], 4.0 * (l[2] - l[3]), -4.0 * l[3]],
        ]
    )


_TET10_A = 0.585410196624968
_TET10_B = 0.138196601125010
_TET10_C = (1.0 - _TET10_A) / (_TET10_A - _TET10_B)
_TET10_D = _TET10_B / (_TET10_A - _TET10_B)
_TET10_X = (0.5 - _TET10_B) / (_TET10_A - _TET10_B)

# natural coords of the 10 nodes in the GP sub-tet's coordinates
# (ref: element_quadratic_tetrahedral.py:325-342)
_TET10_EXTRAP = np.array(
    [
        [-_TET10_D, -_TET10_D, 1.0 + _TET10_C, 2.0 * _TET10_D - _TET10_C],
        [1.0 + _TET10_C, -_TET10_D, -_TET10_D, 2.0 * _TET10_D - _TET10_C],
        [-_TET10_D, -_TET10_D, -_TET10_D, 1.0 + 3.0 * _TET10_D],
        [-_TET10_D, 1.0 + _TET10_C, -_TET10_D, 2.0 * _TET10_D - _TET10_C],
        [_TET10_X, -_TET10_D, _TET10_X, 1.0 - 2.0 * _TET10_X + _TET10_D],
        [_TET10_X, -_TET10_D, -_TET10_D, 1.0 + 2.0 * _TET10_D - _TET10_X],
        [-_TET10_D, -_TET10_D, _TET10_X, 1.0 + 2.0 * _TET10_D - _TET10_X],
        [-_TET10_D, _TET10_X, _TET10_X, 1.0 - 2.0 * _TET10_X + _TET10_D],
        [_TET10_X, _TET10_X, -_TET10_D, 1.0 - 2.0 * _TET10_X + _TET10_D],
        [-_TET10_D, _TET10_X, -_TET10_D, 1.0 + 2.0 * _TET10_D - _TET10_X],
    ]
)

_TET10_FACE_W = [1.0 / 12.0] * 3 + [1.0 / 4.0] * 3

TET10 = ElementType(
    name="tet10",
    dm=3,
    n_nodes=10,
    gauss_points=np.array(
        [
            [_TET10_A, _TET10_B, _TET10_B],
            [_TET10_B, _TET10_A, _TET10_B],
            [_TET10_B, _TET10_B, _TET10_A],
            [_TET10_B, _TET10_B, _TET10_B],
        ]
    ),
    gauss_weights=np.array([1.0 / 24.0] * 4),
    shape_fn=_tet10_shape,
    dshape_fn=_tet10_dshape,
    # ref: element_quadratic_tetrahedral.py:48-78
    facet_natural_coos={
        (1, 2, 3, 5, 8, 9): [
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0],
            [0.5, 0.5, 0.0],
            [0.0, 0.5, 0.0],
            [0.5, 0.0, 0.0],
        ],
        (0, 2, 3, 6, 7, 9): [
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0],
            [0.0, 0.5, 0.5],
            [0.0, 0.0, 0.5],
        ],
        (0, 1, 3, 4, 7, 8): [
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [0.5, 0.0, 0.5],
            [0.0, 0.5, 0.5],
            [0.5, 0.5, 0.0],
        ],
        (0, 1, 2, 4, 5, 6): [
            [1.0, 0.0, 0.0],
            [0.0, 0.0, 1.0],
            [0.0, 0.0, 0.0],
            [0.5, 0.0, 0.5],
            [0.5, 0.0, 0.0],
            [0.0, 0.0, 0.5],
        ],
    },
    facet_point_weights={
        (1, 2, 3, 5, 8, 9): _TET10_FACE_W,
        (0, 2, 3, 6, 7, 9): _TET10_FACE_W,
        (0, 1, 3, 4, 7, 8): _TET10_FACE_W,
        (0, 1, 2, 4, 5, 6): _TET10_FACE_W,
    },
    facet_natural_normals={
        (1, 2, 3, 5, 8, 9): [[0.0, 0.0, -1.0]] * 6,
        (0, 2, 3, 6, 7, 9): [[-1.0, 0.0, 0.0]] * 6,
        (0, 1, 3, 4, 7, 8): [[1.0, 1.0, 1.0]] * 6,
        (0, 1, 2, 4, 5, 6): [[0.0, -1.0, 0.0]] * 6,
    },
    # ref: element_quadratic_tetrahedral.py:80-83
    inp_surface_num=(
        ((0, 1, 2, 4, 5, 6),),
        ((0, 1, 3, 4, 7, 8),),
        ((1, 2, 3, 5, 8, 9),),
        ((0, 2, 3, 6, 7, 9),),
    ),
    extrapolation_matrix=_TET10_EXTRAP,
    # ref: element_quadratic_tetrahedral.py:258-274
    viz_triangles=(
        (1, 5, 8),
        (3, 8, 9),
        (2, 5, 9),
        (5, 9, 8),
        (0, 6, 7),
        (3, 7, 9),
        (2, 9, 6),
        (6, 7, 9),
        (0, 4, 7),
        (1, 8, 4),
        (3, 7, 8),
        (4, 7, 8),
        (0, 4, 6),
        (1, 5, 4),
        (2, 6, 5),
        (4, 5, 6),
    ),
)


# --------------------------------------------------------------------------- #
# Trilinear hexahedron (C3D8) -- BEYOND the reference: FEMcy parses C3D8 but
# has no element class for it (SURVEY.md: KeyError at inp_info.py:123).
# Abaqus node order: 1-4 bottom face counterclockwise (r=-1), 5-8 top (r=+1).
# --------------------------------------------------------------------------- #
_HEX8_SIGNS = np.array(
    [
        [-1, -1, -1],
        [1, -1, -1],
        [1, 1, -1],
        [-1, 1, -1],
        [-1, -1, 1],
        [1, -1, 1],
        [1, 1, 1],
        [-1, 1, 1],
    ],
    dtype=np.float64,
)


def _hex8_shape(nc):
    s = _HEX8_SIGNS
    return (
        (1.0 + s[:, 0] * nc[0])
        * (1.0 + s[:, 1] * nc[1])
        * (1.0 + s[:, 2] * nc[2])
        / 8.0
    )


def _hex8_dshape(nc):
    s = _HEX8_SIGNS
    gx = 1.0 + s[:, 0] * nc[0]
    gy = 1.0 + s[:, 1] * nc[1]
    gz = 1.0 + s[:, 2] * nc[2]
    return np.stack(
        [s[:, 0] * gy * gz, gx * s[:, 1] * gz, gx * gy * s[:, 2]], axis=1
    ) / 8.0


# full 2x2x2 Gauss rule, points ordered like the nodes (corner signs) so the
# extrapolation matrix is the trilinear functions at sqrt(3)-stretched coords
_HEX8_GP = _HEX8_SIGNS / _SQRT3
_HEX8_EXTRAP = np.stack([_hex8_shape(c) for c in _HEX8_SIGNS * _SQRT3])

# Abaqus C3D8 faces S1..S6 (0-based local nodes)
_HEX8_FACES = [
    (0, 1, 2, 3),  # S1 bottom
    (4, 7, 6, 5),  # S2 top
    (0, 4, 5, 1),  # S3
    (1, 5, 6, 2),  # S4
    (2, 6, 7, 3),  # S5
    (3, 7, 4, 0),  # S6
]
#: outward normal of each face in natural coordinates
_HEX8_FACE_NORMALS = [
    (0.0, 0.0, -1.0),
    (0.0, 0.0, 1.0),
    (0.0, -1.0, 0.0),
    (1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0),
    (-1.0, 0.0, 0.0),
]


def _hex8_face_gps(face):
    """2x2 Gauss points on a face: corners of the face pulled to +-1/sqrt(3)
    within the face plane."""
    corners = _HEX8_SIGNS[list(face)]
    center = corners.mean(axis=0)
    return [tuple(center + (c - center) / _SQRT3) for c in corners]


_HEX8_FACET_COOS = {}
_HEX8_FACET_W = {}
_HEX8_FACET_N = {}
_HEX8_FACET_AXES = {}
for _face, _nrm in zip(_HEX8_FACES, _HEX8_FACE_NORMALS):
    _key = tuple(sorted(_face))
    _HEX8_FACET_COOS[_key] = _hex8_face_gps(_face)
    # per-GP Jacobian-based area integration (facet_axes below): the 2x2 rule
    # over the face's [-1,1]^2 parameter square has unit weights and is exact
    # for planar (even non-parallelogram) quad faces
    _HEX8_FACET_W[_key] = [1.0, 1.0, 1.0, 1.0]
    _HEX8_FACET_N[_key] = [list(_nrm)] * 4
    _normal_axis = int(np.argmax(np.abs(_nrm)))
    _HEX8_FACET_AXES[_key] = tuple(a for a in range(3) if a != _normal_axis)

HEX8 = ElementType(
    name="hex8",
    dm=3,
    n_nodes=8,
    gauss_points=_HEX8_GP,
    gauss_weights=np.ones(8),
    shape_fn=_hex8_shape,
    dshape_fn=_hex8_dshape,
    facet_natural_coos=_HEX8_FACET_COOS,
    facet_point_weights=_HEX8_FACET_W,
    facet_natural_normals=_HEX8_FACET_N,
    inp_surface_num=tuple((f,) for f in _HEX8_FACES),
    extrapolation_matrix=_HEX8_EXTRAP,
    viz_triangles=tuple(
        tri for (a, b, c, d) in _HEX8_FACES for tri in ((a, b, c), (a, c, d))
    ),
    facet_axes=_HEX8_FACET_AXES,
)


# --------------------------------------------------------------------------- #
# Linear wedge / triangular prism (C3D6) -- BEYOND the reference: FEMcy
# parses C3D6 but has no element class for it (SURVEY.md: KeyError at
# inp_info.py:123).  Abaqus node order: 1-3 bottom triangle (r=-1), 4-6 top
# (r=+1).  Natural coordinates (g, h, r): triangle barycentric pair (g, h)
# with r in [-1, 1] along the prism axis.
# --------------------------------------------------------------------------- #
_WEDGE6_NODE_NAT = np.array(
    [
        [0.0, 0.0, -1.0],
        [1.0, 0.0, -1.0],
        [0.0, 1.0, -1.0],
        [0.0, 0.0, 1.0],
        [1.0, 0.0, 1.0],
        [0.0, 1.0, 1.0],
    ]
)


def _wedge6_shape(nc):
    g, h, r = nc[0], nc[1], nc[2]
    b = np.array([1.0 - g - h, g, h])
    return np.concatenate([b * (1.0 - r) / 2.0, b * (1.0 + r) / 2.0])


def _wedge6_dshape(nc):
    g, h, r = nc[0], nc[1], nc[2]
    b = np.array([1.0 - g - h, g, h])
    dg = np.array([-1.0, 1.0, 0.0])
    dh = np.array([-1.0, 0.0, 1.0])
    lo, hi = (1.0 - r) / 2.0, (1.0 + r) / 2.0
    return np.block(
        [
            [dg[:, None] * lo, dh[:, None] * lo, -b[:, None] / 2.0],
            [dg[:, None] * hi, dh[:, None] * hi, b[:, None] / 2.0],
        ]
    )


# 3x2 rule: degree-2 triangle points x 2-point Gauss along the axis (exact
# for the linear-wedge stiffness, which the 2-point centroid rule Abaqus
# uses for C3D6 is not); ordered bottom-then-top like the nodes so the
# extrapolation matrix is the wedge shape functions in GP-wedge coordinates
_WEDGE6_TRI_PTS = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
_WEDGE6_GP = np.vstack(
    [
        np.column_stack([_WEDGE6_TRI_PTS, np.full(3, s / _SQRT3)])
        for s in (-1.0, 1.0)
    ]
)
# the GPs form a smaller wedge: tri coords scale by 1/2 about the centroid
# (1/3, 1/3), the axis by 1/sqrt(3) -- invert that map and evaluate
_WEDGE6_EXTRAP = np.stack(
    [
        _wedge6_shape([2.0 * g - 1.0 / 3.0, 2.0 * h - 1.0 / 3.0, _SQRT3 * r])
        for (g, h, r) in _WEDGE6_NODE_NAT
    ]
)

# Abaqus C3D6 faces S1..S5 (0-based local nodes): two triangles, three quads
_WEDGE6_FACES = [
    (0, 1, 2),  # S1 bottom
    (3, 4, 5),  # S2 top
    (0, 1, 4, 3),  # S3 (h = 0)
    (1, 2, 5, 4),  # S4 (g + h = 1)
    (2, 0, 3, 5),  # S5 (g = 0)
]
_WEDGE6_FACET_COOS = {}
_WEDGE6_FACET_W = {}
_WEDGE6_FACET_N = {}
_WEDGE6_FACET_AXES = {}

# triangle faces: centroid point, unit weight; the corner-triangle measure
# fallback is exact (same treatment as TET4 facets)
_WEDGE6_FACET_COOS[(0, 1, 2)] = [(1 / 3, 1 / 3, -1.0)]
_WEDGE6_FACET_COOS[(3, 4, 5)] = [(1 / 3, 1 / 3, 1.0)]
for _key, _nrm in (((0, 1, 2), (0.0, 0.0, -1.0)), ((3, 4, 5), (0.0, 0.0, 1.0))):
    _WEDGE6_FACET_W[_key] = [1.0]
    _WEDGE6_FACET_N[_key] = [list(_nrm)]

# quad faces: 2x2 Gauss over the (edge in [0,1]) x (r in [-1,1]) parameter
# rectangle (weight 1/2 each), per-GP Jacobian area via natural tangents
_g2 = [0.5 - 0.5 / _SQRT3, 0.5 + 0.5 / _SQRT3]
_r2 = [-1.0 / _SQRT3, 1.0 / _SQRT3]
for _face, _nrm, _param, _tans in [
    ((0, 1, 4, 3), (0.0, -1.0, 0.0),
     lambda s, r: (s, 0.0, r), [(1.0, 0.0, 0.0), (0.0, 0.0, 1.0)]),
    ((1, 2, 5, 4), (1.0, 1.0, 0.0),
     lambda s, r: (1.0 - s, s, r), [(-1.0, 1.0, 0.0), (0.0, 0.0, 1.0)]),
    ((2, 0, 3, 5), (-1.0, 0.0, 0.0),
     lambda s, r: (0.0, s, r), [(0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]),
]:
    _key = tuple(sorted(_face))
    _WEDGE6_FACET_COOS[_key] = [_param(s, r) for s in _g2 for r in _r2]
    _WEDGE6_FACET_W[_key] = [0.5] * 4
    _WEDGE6_FACET_N[_key] = [list(_nrm)] * 4
    _WEDGE6_FACET_AXES[_key] = np.asarray(_tans)

WEDGE6 = ElementType(
    name="wedge6",
    dm=3,
    n_nodes=6,
    gauss_points=_WEDGE6_GP,
    gauss_weights=np.full(6, 1.0 / 6.0),
    shape_fn=_wedge6_shape,
    dshape_fn=_wedge6_dshape,
    facet_natural_coos=_WEDGE6_FACET_COOS,
    facet_point_weights=_WEDGE6_FACET_W,
    facet_natural_normals=_WEDGE6_FACET_N,
    inp_surface_num=tuple((tuple(sorted(f)),) for f in _WEDGE6_FACES),
    extrapolation_matrix=_WEDGE6_EXTRAP,
    viz_triangles=(
        (0, 1, 2), (3, 4, 5),
        (0, 1, 4), (0, 4, 3), (1, 2, 5), (1, 5, 4), (2, 0, 3), (2, 3, 5),
    ),
    facet_axes=_WEDGE6_FACET_AXES,
)


# --------------------------------------------------------------------------- #
# Quadratic serendipity hexahedron (C3D20) -- BEYOND the reference: FEMcy
# parses C3D20 (keeping only the 8 corner nodes, inp_info.py:85-113) but has
# no element class.  Abaqus node order: 1-8 corners (C3D8 order), 9-12 bottom
# edge midpoints (1-2, 2-3, 3-4, 4-1), 13-16 top edge midpoints (5-6 ... 8-5),
# 17-20 vertical edge midpoints (1-5, 2-6, 3-7, 4-8).  Full 3x3x3 Gauss.
# --------------------------------------------------------------------------- #
_HEX20_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]
_HEX20_NAT = np.vstack(
    [_HEX8_SIGNS] + [(_HEX8_SIGNS[a] + _HEX8_SIGNS[b]) / 2.0 for a, b in _HEX20_EDGES]
)


def _hex20_shape(nc):
    g, h, r = float(nc[0]), float(nc[1]), float(nc[2])
    x = np.array([g, h, r])
    N = np.zeros(20)
    for i, p in enumerate(_HEX20_NAT):
        if i < 8:
            t = p @ x
            N[i] = (1 + p[0] * g) * (1 + p[1] * h) * (1 + p[2] * r) * (t - 2) / 8
        else:
            z = int(np.nonzero(p == 0)[0][0])
            o = [a for a in range(3) if a != z]
            N[i] = (
                (1 - x[z] ** 2)
                * (1 + p[o[0]] * x[o[0]])
                * (1 + p[o[1]] * x[o[1]])
                / 4
            )
    return N


def _hex20_dshape(nc):
    g, h, r = float(nc[0]), float(nc[1]), float(nc[2])
    x = np.array([g, h, r])
    dN = np.zeros((20, 3))
    for i, p in enumerate(_HEX20_NAT):
        if i < 8:
            t = p @ x
            # d/dx_a [prod_b (1 + p_b x_b) * (t - 2)] with dt/dx_a = p_a:
            # = p_a * (others product) * (t - 2 + (1 + p_a x_a))
            for a in range(3):
                others = np.prod([1 + p[b] * x[b] for b in range(3) if b != a])
                dN[i, a] = p[a] * others * (t - 1 + p[a] * x[a]) / 8
        else:
            z = int(np.nonzero(p == 0)[0][0])
            o = [a for a in range(3) if a != z]
            f0, f1 = 1 + p[o[0]] * x[o[0]], 1 + p[o[1]] * x[o[1]]
            dN[i, z] = -2 * x[z] * f0 * f1 / 4
            dN[i, o[0]] = (1 - x[z] ** 2) * p[o[0]] * f1 / 4
            dN[i, o[1]] = (1 - x[z] ** 2) * f0 * p[o[1]] / 4
    return dN


# full 3x3x3 Gauss
_G3 = np.sqrt(0.6)
_W3 = np.array([5.0, 8.0, 5.0]) / 9.0
_HEX20_GP = np.array(
    [(a, b, c) for a in (-_G3, 0.0, _G3) for b in (-_G3, 0.0, _G3) for c in (-_G3, 0.0, _G3)]
)
_HEX20_W = np.array(
    [wa * wb * wc for wa in _W3 for wb in _W3 for wc in _W3]
)


def _lagrange3(xi):
    """Quadratic Lagrange basis on the 3-point Gauss grid (-g3, 0, g3)."""
    return np.array(
        [
            xi * (xi - _G3) / (2 * _G3**2),
            1.0 - xi**2 / _G3**2,
            xi * (xi + _G3) / (2 * _G3**2),
        ]
    )


# GP -> node extrapolation: triquadratic Lagrange interpolation on the
# 3x3x3 GP grid, evaluated at the node coordinates (same construction as
# the reference's GP-element extrapolation matrices)
_HEX20_EXTRAP = np.stack(
    [
        np.einsum(
            "a,b,c->abc", _lagrange3(p[0]), _lagrange3(p[1]), _lagrange3(p[2])
        ).reshape(-1)
        for p in _HEX20_NAT
    ]
)

# Abaqus C3D20 faces S1..S6: the C3D8 corner cycles + their edge midpoints
_HEX20_EDGE_IDX = {
    tuple(sorted(e)): 8 + i for i, e in enumerate(_HEX20_EDGES)
}
_HEX20_FACES = []
for _f8 in _HEX8_FACES:
    mids = [
        _HEX20_EDGE_IDX[tuple(sorted((_f8[a], _f8[(a + 1) % 4])))]
        for a in range(4)
    ]
    _HEX20_FACES.append(tuple(_f8) + tuple(mids))

_HEX20_FACET_COOS = {}
_HEX20_FACET_W = {}
_HEX20_FACET_N = {}
_HEX20_FACET_AXES = {}
for _face, _nrm in zip(_HEX20_FACES, _HEX8_FACE_NORMALS):
    _key = tuple(sorted(_face))
    _axis = int(np.argmax(np.abs(_nrm)))
    _o = [a for a in range(3) if a != _axis]
    _coos = []
    for a in (-_G3, 0.0, _G3):
        for b in (-_G3, 0.0, _G3):
            p = [0.0, 0.0, 0.0]
            p[_axis] = float(np.sign(_nrm[_axis]))
            p[_o[0]], p[_o[1]] = a, b
            _coos.append(tuple(p))
    _HEX20_FACET_COOS[_key] = _coos
    _HEX20_FACET_W[_key] = [wa * wb for wa in _W3 for wb in _W3]
    _HEX20_FACET_N[_key] = [list(_nrm)] * 9
    _HEX20_FACET_AXES[_key] = tuple(_o)


def _hex20_face_triangles(face):
    c = face[:4]
    m = face[4:]
    tris = []
    for a in range(4):
        tris.append((c[a], m[a], m[(a - 1) % 4]))
    tris += [(m[0], m[1], m[2]), (m[0], m[2], m[3])]
    return tris


HEX20 = ElementType(
    name="hex20",
    dm=3,
    n_nodes=20,
    gauss_points=_HEX20_GP,
    gauss_weights=_HEX20_W,
    shape_fn=_hex20_shape,
    dshape_fn=_hex20_dshape,
    facet_natural_coos=_HEX20_FACET_COOS,
    facet_point_weights=_HEX20_FACET_W,
    facet_natural_normals=_HEX20_FACET_N,
    inp_surface_num=tuple((f,) for f in _HEX20_FACES),
    extrapolation_matrix=_HEX20_EXTRAP,
    viz_triangles=tuple(
        tri for f in _HEX20_FACES for tri in _hex20_face_triangles(f)
    ),
    facet_axes=_HEX20_FACET_AXES,
)


#: Abaqus/CalculiX element-type keyword -> element definition
#: (ref: reader/inp_info.py:118-123)
ELEMENT_REGISTRY = {
    "CPS3": TRI3,
    "CPE3": TRI3,
    "CPS4": QUAD4,
    "CPE4": QUAD4,
    "CPS6": TRI6,
    "CPE6": TRI6,
    "CPS8": QUAD8,
    "CPE8": QUAD8,
    "C3D4": TET4,
    "C3D10": TET10,
    "C3D8": HEX8,  # beyond the reference (it parses C3D8 but cannot solve it)
    "C3D6": WEDGE6,  # beyond the reference (parses but cannot solve)
    "C3D20": HEX20,  # beyond the reference (parses but cannot solve)
}


def get_element(abaqus_name: str) -> ElementType:
    try:
        return ELEMENT_REGISTRY[abaqus_name]
    except KeyError:
        raise KeyError(
            f"element type {abaqus_name!r} is not supported "
            f"(supported: {sorted(ELEMENT_REGISTRY)})"
        ) from None
