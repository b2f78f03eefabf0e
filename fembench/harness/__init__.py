"""The benchmark's harness: generator, reference check, trace reduction and the
arithmetic of its metrics."""
