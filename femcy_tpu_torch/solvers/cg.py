"""Jacobi-preconditioned conjugate gradient on the padded ELL layout, and
the small-model dense CG.

Torch counterpart of ``femcy_tpu.solvers.cg`` (``ell_spmv``,
``pcg_solve``, ``ell_to_dense``, ``dense_pcg_solve``): the same algorithm
and convergence rule as the reference,
||r||_inf < eps * ||r0||_inf with eps defaulting to 1e-3
(conjugateGradientSolver.py:15), at most n_dof iterations (:109).  The
loop is the port's generic ``solvers.dia.pcg``.

``ell_spmv`` and ``pcg_solve`` are the public names (``solvers.__all__``,
as in femcy_tpu).  On CUDA tensors they run the hand-written ELL SpMV
(kernels/ell_spmv.py, M2), on CPU tensors its plain version
``ell_spmv_plain``, and on any other device they raise.  The solvers of
the port pass ``spmv``: M2's (prep, apply) pair built from their pattern,
or under ``spmv="slices"`` the plain gather's (``gather_spmv``); without
one, ``pcg_solve`` builds M2's pair from ``colidx`` on its device, once
per solve.
"""

from __future__ import annotations

import torch

from femcy_tpu_torch.linalg import inv_small
from femcy_tpu_torch.solvers.dia import pcg


def ell_spmv_plain(values, colidx, x):
    """y = A @ x on the padded ELL format: one row gather and a row sum.
    Padding slots hold value 0, so their (column 0) gather adds nothing
    (ref: conjugateGradientSolver.py:53-58).  The plain version of M2, on
    any device."""
    return (values * x[colidx]).sum(dim=1)


def _device_kind(t) -> str:
    return t.device.type


def _kernel_spmv(colidx):
    """M2's (prep, apply) pair on ``colidx``'s own device, every row at
    its full width (kernels.ell_spmv.colidx_spmv)."""
    from femcy_tpu_torch.kernels import ell_spmv as k_ell

    return k_ell.colidx_spmv(colidx)


def gather_spmv(colidx):
    """(prep, apply) pair of the plain gather on ``colidx``, on any
    device: what ``spmv="slices"``, an explicit request for the plain
    torch SpMV, hands ``pcg_solve``."""
    return (lambda values: values,
            lambda values, x: ell_spmv_plain(values, colidx, x))


def _default_spmv(colidx, t):
    """(prep, apply) pair for a call that brings none, by ``t``'s device:
    the plain gather on the CPU, M2 on CUDA (its plan built from
    ``colidx`` on the card); any other device raises."""
    kind = _device_kind(t)
    if kind == "cpu":
        return gather_spmv(colidx)
    if kind == "cuda":
        return _kernel_spmv(colidx)
    raise ValueError(f"unsupported device {t.device}")


def ell_spmv(values, colidx, x):
    """y = A @ x on the padded ELL format (n, W) values and int column ids.

    CPU tensors take ``ell_spmv_plain``; CUDA tensors launch M2, with its
    plan built from ``colidx`` on the card at every call (a CG should
    call ``pcg_solve``, which builds it once); any other device raises."""
    prep, apply_fn = _default_spmv(colidx, x)
    return apply_fn(prep(values), x)


def pcg_solve(values, colidx, diag_slot, b, eps: float = 1.0e-3,
              max_iters: int = 0, spmv=None):
    """Solve A x = b with the Jacobi PCG.  Returns (x, iterations,
    max|r|); ``max_iters <= 0`` means n.

    ``diag_slot`` indexes each row's diagonal in the flattened values; the
    preconditioner is M^-1 = 1/diag, 0 where the diagonal is 0
    (ref: conjugateGradientSolver.py:48-51).

    spmv: optional (prep, apply) pair (kernels.ell_spmv.make_spmv, or
    ``gather_spmv``); ``prep(values)`` runs once per solve.  Without one,
    ``_default_spmv`` picks it by device: M2's pair built from ``colidx``
    on CUDA, the plain gather on the CPU, and any other device raises.
    """
    n = b.shape[0]
    if max_iters <= 0:
        max_iters = n
    prep, apply_fn = spmv if spmv is not None else _default_spmv(colidx, b)
    operand = prep(values)

    def apply_a(d):
        return apply_fn(operand, d)

    diag = values.reshape(-1)[diag_slot]
    minv = torch.where(diag != 0.0, 1.0 / diag, torch.zeros_like(diag))

    def apply_m(r):
        return minv * r

    return pcg(apply_a, apply_m, b, eps, max_iters)


def ell_to_dense(values, colidx, n: int):
    """Padded ELL values -> dense (n, n) operator, one indexed add.

    Padding slots hold value 0 at column 0, so a row's true (r, 0) entry
    shares its target with them: the add keeps it (a plain indexed write
    could let a padding zero overwrite it)."""
    rows = torch.arange(n, device=values.device)[:, None].expand_as(colidx)
    A = values.new_zeros((n, n))
    return A.index_put_((rows, colidx), values, accumulate=True)


def dense_pcg_solve(A, b, eps: float = 1.0e-3, max_iters: int = 0,
                    block_dm: int = 0):
    """Jacobi PCG with a DENSE operator: A d is one (n, n) @ (n,) product.

    Same stopping rule as ``pcg_solve``; ``max_iters <= 0`` means n.
    ``block_dm`` > 0 uses the dm x dm node-block Jacobi preconditioner
    (closed-form small inverses; a block whose trace is 0, a fully
    eliminated node, takes the identity, as femcy_tpu's does).  Returns
    (x, iterations, max|r|)."""
    n = b.shape[0]
    if max_iters <= 0:
        max_iters = n
    if block_dm > 0:
        nb = n // block_dm
        node = torch.arange(nb, device=A.device)
        blocks = A.reshape(nb, block_dm, nb, block_dm)[node, :, node, :]
        empty = blocks.diagonal(dim1=-2, dim2=-1).sum(-1) == 0.0
        eye = torch.eye(block_dm, dtype=A.dtype, device=A.device)
        minv_blocks = inv_small(torch.where(empty[:, None, None], eye, blocks))

        def apply_m(r):
            return torch.einsum(
                "aij,aj->ai", minv_blocks, r.reshape(nb, block_dm)
            ).reshape(-1)

    else:
        diag = A.diagonal()
        minv = torch.where(diag != 0.0, 1.0 / diag, torch.zeros_like(diag))

        def apply_m(r):
            return minv * r

    return pcg(lambda d: torch.mv(A, d), apply_m, b, eps, max_iters)
