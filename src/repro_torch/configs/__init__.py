"""Workload configurations of the port (copies of `repro/configs`'s, so the
port reads no module of the JAX package): the paper's structured-grid
workload, `dpc_grid`, its edge-list one, `dpc_graph`, and the serving
layer's, `serve_topology` (`repro_torch.serve`)."""
