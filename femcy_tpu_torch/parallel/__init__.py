"""Multi-device solves (femcy_tpu.parallel): the general-mesh element-sharded
solve and Newton step (sharded.py), the slab-sharded structured solve
(structured.py) and the RCM block-tridiagonal sharded solve (banded.py)."""

from femcy_tpu_torch.parallel.sharded import (
    ShardedLinearSolver,
    ShardedNewtonStep,
    build_sharded_operands,
)

__all__ = ["ShardedLinearSolver", "ShardedNewtonStep", "build_sharded_operands"]
