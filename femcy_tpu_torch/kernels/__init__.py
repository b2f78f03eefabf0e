"""Hand-written CUDA kernels for Hopper, one module per TPU kernel they
replace (femcy_tpu/kernels/).  Sources live in ../csrc; _build compiles
them at first use.  Each wrapper runs its plain torch version for CPU
tensors and its kernel for CUDA tensors, and counts its kernel launches in
``<wrapper>.launches``:

- dia_spmv.spmv                       <- femcy_tpu/kernels/dia_spmv.py
- structured_accumulate.accumulate    <- femcy_tpu/kernels/structured_accumulate.py

femcy_tpu/kernels/structured_fused.py has no counterpart yet (ROADMAP).
"""
