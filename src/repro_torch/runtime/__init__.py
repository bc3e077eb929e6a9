"""The fault-tolerant training driver (port of `repro/runtime/driver.py`;
`runtime/meshctx.py` is ROADMAP.md Queue 1 item 5d)."""
from .driver import TrainDriver, InjectedFailure, StragglerStats
