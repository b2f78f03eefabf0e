from femcy_tpu_torch.solvers.cg import ell_spmv, pcg_solve
from femcy_tpu_torch.solvers.dia import dia_pcg_solve, dia_spmv
from femcy_tpu_torch.solvers.direct import direct_solve

__all__ = ["ell_spmv", "pcg_solve", "direct_solve", "dia_pcg_solve",
           "dia_spmv"]
