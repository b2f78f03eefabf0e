"""Host direct sparse solve (scipy), the small-problem path.

Mirrors the reference crossover: below ``direct_solve_max_dof`` dofs the
system is flattened ELL -> CSR on the host and solved with SuperLU
(ref: stiffnessMtrx.py:219-251, 272-276).  Also serves as the cross-check
oracle in tests.

FEM stiffness matrices are structurally symmetric, so SuperLU's symmetric
mode with the MMD_AT_PLUS_A ordering roughly halves the factorization cost
vs the plain ``spsolve`` default (measured 0.10 s vs 0.22 s on the 6k-dof
C3D10 twist tangent).  ``factorize`` exposes the LU object so the Newton
loop can reuse one factorization across iterations (modified Newton,
SolverConfig.newton_jacobian_reuse).

Host copy of ``femcy_tpu.solvers.direct``; it takes the port's DIA pattern
(``DIAPattern.to_scipy``) and numpy values.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla


def factorize(pattern, values):
    """LU-factorize the assembled operator (ELL or DIA pattern + values)."""
    K = pattern.to_scipy(np.asarray(values)).tocsc()
    try:
        # SymmetricMode is documented to pair with a small pivot threshold;
        # the default 1.0 re-enables full partial pivoting and forfeits most
        # of the symmetric-ordering speedup
        return spla.splu(
            K,
            permc_spec="MMD_AT_PLUS_A",
            diag_pivot_thresh=0.001,
            options=dict(SymmetricMode=True),
        )
    except RuntimeError:
        # singular in symmetric mode (e.g. zero pivot): retry with the
        # default pivoting before giving up
        return spla.splu(K)


def direct_solve(pattern, values, b) -> np.ndarray:
    return factorize(pattern, values).solve(np.asarray(b))
