"""Workload configurations of the port (copies of `repro/configs`'s, so the
port reads no module of the JAX package).  This slice carries the paper's
structured-grid workload, `dpc_grid`."""
