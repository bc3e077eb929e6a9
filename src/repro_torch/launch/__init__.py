"""Launchers of the port (port of `repro/launch`): `serve`, the batched
serving entry point (LM prefill + decode, and the topology engine), and
`train`, the fault-tolerant LM training loop."""
