"""Measurement scripts for the port's kernels; nothing in the package
imports them."""
