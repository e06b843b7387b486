"""Operators of the port: the serving attention helpers (plain torch) and
the hand-written kernels under `pallas_kernels`."""
