"""Cross-engine shared executable cache (port of
`repro/serve/compile_cache.py`, DESIGN.md §Serve-v3).

An engine with a private bounded-LRU executable cache makes N engine
replicas serving the same tenant mix pay N identical builds for every
(kind, backend, layout, capacity, dtype, table_mode) executable.
`SharedExecutableCache` factors that cache out: any number of
`TopologyEngine` / `AsyncTopologyEngine` instances (sync and async alike)
attach to one cache and each executable is built exactly once, whichever
engine asks first.  In the port an executable is a cached batched callable
(`engine.TopologyEngine._build_executable`); a build is counted where the
JAX package counts an XLA compile, so `compiles` and every hit / miss /
eviction counter equal the JAX engine's on the same request stream.

Attribution stays per engine: `attach()` hands out an owner tag and
`lookup()` charges the hit or miss to it, so per-replica hit rates remain
observable (`attribution()`) even though the store is shared.

Invalidation rules (deliberately minimal):
  * LRU only — an insert past `capacity` evicts the least-recently-used
    entry, whichever engine inserted it; `capacity=None` disables eviction.
  * Executables are keyed by everything that shapes the executable
    (the engine's `_exec_key`), so entries never go stale — there is no
    TTL and no explicit invalidation API.
  * The plane is cooperative single-threaded on an injected clock
    (DESIGN.md §Serve-v2), so the cache takes no locks; callers running
    engines from multiple threads must serialize externally.
"""
from __future__ import annotations

import collections
import itertools
from typing import Any, Callable


class SharedExecutableCache:
    """Bounded LRU of built executables, shareable across engines."""

    def __init__(self, capacity: int | None = 64):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = None if capacity is None else int(capacity)
        self.compiles = 0     # build() invocations == distinct cold builds
        self.evictions = 0
        self._store: collections.OrderedDict = collections.OrderedDict()
        self._owners: dict = {}       # owner tag -> {"hits": n, "misses": n}
        self._ids = itertools.count()

    # --- attachment -----------------------------------------------------------

    def attach(self, name: str | None = None) -> str:
        """Register an engine and return its owner tag (auto-numbered when
        `name` is None; attaching an existing name rejoins its counters)."""
        owner = f"engine-{next(self._ids)}" if name is None else str(name)
        self._owners.setdefault(owner, {"hits": 0, "misses": 0})
        return owner

    # --- the one hot-path operation -------------------------------------------

    def lookup(self, key, build: Callable[[], Any], owner: str):
        """Return `(executable, hit, evicted)`; on a miss, build via
        `build()` and insert.  The hit/miss is charged to `owner`;
        `evicted` is how many entries the insert pushed out (0 or 1)."""
        counters = self._owners.setdefault(owner, {"hits": 0, "misses": 0})
        cached = self._store.get(key)
        if cached is not None:
            counters["hits"] += 1
            self._store.move_to_end(key)
            return cached, True, 0
        counters["misses"] += 1
        self.compiles += 1
        built = build()
        self._store[key] = built
        evicted = 0
        if self.capacity is not None and len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1
            evicted = 1
        return built, False, evicted

    # --- introspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        return key in self._store

    def attribution(self) -> dict:
        """Per-attached-engine hit/miss counters."""
        return {owner: dict(c) for owner, c in self._owners.items()}

    def info(self) -> dict:
        return {
            "size": len(self._store),
            "capacity": self.capacity,
            "compiles": self.compiles,
            "evictions": self.evictions,
            "engines": self.attribution(),
        }


__all__ = ["SharedExecutableCache"]
