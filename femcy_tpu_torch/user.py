"""User-programmable Dirichlet boundary conditions.

Host copy of ``femcy_tpu.user``.  The reference exposes one hardcoded
kernel as its UMAT-like extension point (user_defined/user_api.py:6-30): a
rigid rotation of the node set about (40, 5, 0) by angle time*pi,
dispatched when the ``.inp`` says ``*Boundary, user``.  Here the hook is a
plain callable

    user_fn(nodes: (K, dm) array, dof_dim: int, time: float) -> (K,) values

passed to ``FEMSystem.solve(..., user_dirichlet=...)``; the default
reproduces the reference kernel.  The port evaluates it on the host, in
numpy, once per increment, on the device loop too (the JAX package writes
it with ``jnp`` so that its one-program analysis loop can trace it).
"""

from __future__ import annotations

import numpy as np


def make_rotation_dirichlet(center, axis: str = "z"):
    """Rigid rotation about ``center`` by angle ``time * pi``, about the z
    axis (``axis`` is accepted for the JAX package's signature)."""
    center = np.asarray(center, dtype=np.float64)

    def user_fn(nodes: np.ndarray, dof_dim: int, time) -> np.ndarray:
        angle = time * np.pi
        c, s = np.cos(angle), np.sin(angle)
        # ref rotation matrix (user_api.py:22-26):
        # rows [cos, sin, 0; -sin, cos, 0; 0,0,1]; applied as rel @ rot.T
        rel = np.asarray(nodes, np.float64) - center[: nodes.shape[1]]
        x, y = rel[:, 0], rel[:, 1]
        new_cols = [c * x + s * y, -s * x + c * y]
        if nodes.shape[1] == 3:
            new_cols.append(rel[:, 2])
        disp = np.stack(new_cols, axis=1) - rel
        return disp[:, dof_dim]

    return user_fn


#: parity default: rotation about (40, 5, 0) (ref: user_api.py:18)
default_user_dirichlet = make_rotation_dirichlet((40.0, 5.0, 0.0))
