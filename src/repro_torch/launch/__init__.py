"""Launchers of the port (port of `repro/launch`): `serve`, the batched
serving entry point (LM prefill + decode, and the topology engine),
`train`, the fault-tolerant LM training loop, `mesh`, the production
meshes, and the dry-run tools: `cells` (each arch x shape cell's step and
sharded arguments), `dryrun` (rank 0's step traced on the meta device
under a fake process group), `roofline`, `perf` and `report`."""
