"""Batched multi-tenant topology serving (port of `repro/serve`, DESIGN.md
§Serve / §Serve-v2 / §Serve-v3).

    from repro_torch.serve import TopologyEngine
    from repro_torch.topology import TopologyRequest

    eng = TopologyEngine()            # on "cuda"; device="cpu" for the CPU
    results = eng.submit_batch([TopologyRequest("cc", mask=m), ...])
    eng.stats.as_dict()   # requests/batches, cache hit rate, pad waste

Async plane (queueing, deadline-aware flushing, split-retry, idempotency):

    from repro_torch.serve import AsyncTopologyEngine, VirtualClock

    eng = AsyncTopologyEngine(clock=VirtualClock())
    h = eng.submit(req, deadline=0.5, idempotency_key="tenant-42/9001")
    eng.advance(0.5)      # deadline flush (virtual time)
    h.result()            # bit-identical to repro_torch.topology.submit(req)

Overload plane (admission control, load shedding, shared builds):

    from repro_torch.serve import SharedExecutableCache, PlaneError

    cache = SharedExecutableCache(capacity=64)
    eng = AsyncTopologyEngine(max_queue_depth=256, shed_policy="hopeless",
                              compile_cache=cache, name="replica-0")
    h = eng.submit(req, deadline=...)
    if h.done() and isinstance(h.exception(), PlaneError):
        ...               # Overloaded (rejected) or DeadlineShed (dropped)
"""
from .engine import (TopologyEngine, AsyncTopologyEngine, TopologyHandle,
                     EngineStats, PlaneError, Overloaded, DeadlineShed)
from .compile_cache import SharedExecutableCache
from .scheduler import (FlushScheduler, VirtualClock, MonotonicClock,
                        COLD_START_ESTIMATE, SHED_POLICIES)
from .bucketing import (bucket_shape, batch_capacity, remap_flat_labels,
                        merge_adjacent_layouts)

__all__ = ["TopologyEngine", "AsyncTopologyEngine", "TopologyHandle",
           "EngineStats", "PlaneError", "Overloaded", "DeadlineShed",
           "SharedExecutableCache", "FlushScheduler", "VirtualClock",
           "MonotonicClock", "COLD_START_ESTIMATE", "SHED_POLICIES",
           "bucket_shape", "batch_capacity", "remap_flat_labels",
           "merge_adjacent_layouts"]
