"""Hand-written CUDA kernels for Hopper.  Sources live in ../csrc; _build
compiles them at first use.  Each wrapper runs its plain torch version for
CPU tensors and its kernel for CUDA tensors, and counts its kernel
launches in ``<wrapper>.launches``.

The three TPU kernels of femcy_tpu/kernels/:

- dia_spmv.spmv                       <- femcy_tpu/kernels/dia_spmv.py (P1)
- structured_accumulate.accumulate    <- femcy_tpu/kernels/structured_accumulate.py (P2)
- structured_fused.fused_assemble     <- femcy_tpu/kernels/structured_fused.py (P3)

and the device ops that carry the general (ELL) path and the Newton
path, which the JAX package leaves to XLA's scatters and gathers:

- ell_scatter.scatter            <- assembly.scatter_stiffness_blocks / solvers/dia.dia_scatter (M1)
- ell_spmv.spmv                  <- solvers/cg.ell_spmv (M2)
- internal_force.scatter_force   <- assembly.internal_force (M4, general layouts)
- structured_force.force_scatter <- structured.structured_force_scatter (M5, the box)
"""
