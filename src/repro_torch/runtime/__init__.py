"""The fault-tolerant training driver (port of `repro/runtime/driver.py`)
and the logical-axis sharding context (`runtime.meshctx`, port of
`repro/runtime/meshctx.py`: a named-axis `Mesh` over torch.distributed
ranks with explicit collectives)."""
from .driver import TrainDriver, InjectedFailure, StragglerStats
