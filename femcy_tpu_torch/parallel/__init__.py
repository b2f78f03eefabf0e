"""Multi-device solves (femcy_tpu.parallel): the slab-sharded structured
solve (structured.py).  The general and banded sharded solvers of
femcy_tpu.parallel come with ROADMAP slices I.2 and I.3."""
