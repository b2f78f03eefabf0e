from femcy_tpu_torch.solvers.dia import dia_pcg_solve, dia_spmv
from femcy_tpu_torch.solvers.direct import direct_solve

__all__ = ["dia_pcg_solve", "dia_spmv", "direct_solve"]
