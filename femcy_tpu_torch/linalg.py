"""Tiny batched linear algebra (closed-form 2x2 / 3x3).

Torch counterpart of ``femcy_tpu.linalg``: the adjugate forms are a handful
of elementwise ops on the last two axes, cheaper than a batched LU for the
small matrices FEM kinematics produces, and identical in every dtype and on
every device.
"""

from __future__ import annotations

import torch


def det_small(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form determinant of (..., 2, 2) or (..., 3, 3)."""
    if a.shape[-1] == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def inv_small(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) inverse of (..., 2, 2) or (..., 3, 3)."""
    det = det_small(a)[..., None, None]
    if a.shape[-1] == 2:
        adj = torch.stack(
            [
                torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
                torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        )
        return adj / det

    def cof(i1, i2, j1, j2):
        return a[..., i1, j1] * a[..., i2, j2] - a[..., i1, j2] * a[..., i2, j1]

    # adjugate: transpose of the cofactor matrix
    row0 = torch.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], dim=-1)
    row1 = torch.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], dim=-1)
    row2 = torch.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) / det
