"""Hand-written CUDA kernels for Hopper.  Sources live in ../csrc; _build
compiles them at first use.  Each wrapper runs its plain torch version for
CPU tensors and its kernel for CUDA tensors, and counts its kernel
launches in ``<wrapper>.launches``.

The three TPU kernels of femcy_tpu/kernels/:

- dia_spmv.spmv                       <- femcy_tpu/kernels/dia_spmv.py (P1)
- structured_accumulate.accumulate    <- femcy_tpu/kernels/structured_accumulate.py (P2)
- structured_fused.fused_assemble     <- femcy_tpu/kernels/structured_fused.py (P3)

and the device ops that carry the general (ELL) path, the algebraic
multigrid, the Newton path and the mixed beam + continuum models, which the JAX package leaves to XLA's
scatters and gathers:

- ell_scatter.scatter            <- assembly.scatter_stiffness_blocks / solvers/dia.dia_scatter (M1)
- ell_spmv.spmv                  <- solvers/cg.ell_spmv (M2)
- bell_spmv.spmv                 <- solvers/bell.bell_spmv (M3, the algebraic multigrid)
- internal_force.scatter_force   <- assembly.internal_force (M4, general layouts)
- structured_force.force_scatter <- structured.structured_force_scatter (M5, the box)
- newton_element.evaluate        <- the box Newton evaluation's einsums, system._internal_force_parts + _newton_eval (M9)
- mixed_scatter.scatter          <- mixed.MixedSystem._assemble_impl (M6, beams + continuum)
"""
