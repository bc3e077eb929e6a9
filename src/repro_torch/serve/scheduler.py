"""Deadline-aware flush scheduling for the async serving plane (port of
`repro/serve/scheduler.py`, plain Python copied unchanged;
DESIGN.md §Serve-v2).

A synchronous engine flushes on every `submit_batch`, so bucket
occupancies are whatever one caller happened to hand over and the pow2
batch capacities rarely fill.  The `FlushScheduler` decouples *admission* from *execution*:
work items enqueue into per-bucket FIFO queues and a bucket flushes only

  * when it reaches its batch capacity (the pow2 capacity actually fills),
  * when the earliest deadline in it would otherwise be missed — `now >=
    deadline - estimate`, where the estimate is a measured per-layout
    execute time (EWMA of observed durations, `default_estimate` before the
    first observation), or
  * on explicit `drain()` (`pop_all`).

Time is injected, never read from the wall directly: `MonotonicClock` for
production, `VirtualClock` for tests and benchmarks — a deterministic
virtual time source the test advances by hand, which makes deadline-flush
sequences exactly reproducible (the testability deviation recorded in
DESIGN.md §Serve-v2).  Durations observed through a `VirtualClock` are 0
unless the engine charges measured wall time back to the clock
(`charge_execution_time`), so virtual-clock runs degrade gracefully to
"flush exactly at the deadline".

Serve-v3 (DESIGN.md §Serve-v3) grows the scheduler from a flush *detector*
into a *scheduler* proper: `due()` orders buckets by deadline slack
(most-overdue first), cold buckets estimate from a global cross-bucket
EWMA instead of flushing exactly at the deadline, and `shed()` / `purge()`
let the engine drop queued work whose deadline is already unmeetable
before wasting an execution on it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

# Conservative cold-start execute estimate (seconds).  With the historical
# default of 0.0, a never-measured bucket's flush_at equalled its earliest
# deadline, so the very first request in every bucket flushed exactly AT its
# deadline and missed it by the execution time.
# 50ms is on the order of one warm bucket execution on the smoke shapes —
# pessimistic enough to flush early, small enough not to starve batching.
COLD_START_ESTIMATE = 0.05

# Load-shedding policies (`FlushScheduler.shed` / engine `shed_policy`):
#   never    — keep everything; overload only rejects at admission
#   late     — shed entries whose deadline has already passed (now > d)
#   hopeless — shed entries that cannot finish in time (now + estimate > d)
SHED_POLICIES = ("never", "late", "hopeless")


def check_shed_policy(policy: str) -> str:
    if policy not in SHED_POLICIES:
        raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                         f"got {policy!r}")
    return policy


class VirtualClock:
    """Deterministic time source: advances only when told to."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += float(dt)
        return self._t


class MonotonicClock:
    """Wall time source (monotonic, so deadline arithmetic never jumps)."""

    def now(self) -> float:
        return time.monotonic()


@dataclasses.dataclass
class _Entry:
    """One queued work item with its admission metadata."""
    item: Any
    deadline: float | None
    enqueued_at: float


class FlushScheduler:
    """Per-bucket FIFO queues with capacity- and deadline-driven flushes.

    The scheduler only *decides* when a bucket should flush; popping and
    executing is the engine's job (`AsyncTopologyEngine._flush`), so the
    decision logic stays a pure function of (queues, clock, estimates) and
    unit-testable without compiling anything.
    """

    def __init__(self, capacity: int = 64, clock=None,
                 default_estimate: float | None = None, ewma: float = 0.5):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock if clock is not None else MonotonicClock()
        # None selects the conservative cold-start default; an explicit 0.0
        # restores the pre-v3 "flush exactly at the deadline" behaviour.
        self.default_estimate = float(COLD_START_ESTIMATE
                                      if default_estimate is None
                                      else default_estimate)
        self.ewma = float(ewma)
        self._queues: dict = {}       # bucket key -> list[_Entry]
        self._estimates: dict = {}    # bucket key -> EWMA execute seconds
        self._global: float | None = None   # cross-bucket EWMA (cold seed)

    # --- admission ------------------------------------------------------------

    def enqueue(self, key, item, deadline: float | None = None) -> int:
        """Queue one work item under its bucket key; returns the bucket's
        occupancy after the enqueue."""
        q = self._queues.setdefault(key, [])
        q.append(_Entry(item=item,
                        deadline=None if deadline is None else float(deadline),
                        enqueued_at=self.clock.now()))
        return len(q)

    def depth(self) -> int:
        """Total queued items across every bucket."""
        return sum(len(q) for q in self._queues.values())

    def depths(self) -> dict:
        return {k: len(q) for k, q in self._queues.items() if q}

    # --- flush decisions ------------------------------------------------------

    def full(self) -> list:
        """Bucket keys at (or beyond — a single request can expand past the
        capacity) their batch capacity."""
        return [k for k, q in self._queues.items() if len(q) >= self.capacity]

    def earliest_deadline(self, key) -> float | None:
        ds = [e.deadline for e in self._queues.get(key, ())
              if e.deadline is not None]
        return min(ds) if ds else None

    def flush_at(self, key) -> float | None:
        """Latest time the bucket can still flush without missing its
        earliest deadline: deadline minus the measured execute estimate."""
        d = self.earliest_deadline(key)
        return None if d is None else d - self.estimate(key)

    def slack(self, key) -> float | None:
        """Seconds until the bucket must flush (negative when overdue):
        `earliest_deadline - estimate - now`.  None without a deadline."""
        t = self.flush_at(key)
        return None if t is None else t - self.clock.now()

    def due(self) -> list:
        """Bucket keys whose earliest deadline would be missed by waiting
        any longer, ordered by deadline slack — most overdue first (stable,
        so equal-slack buckets keep insertion order and the schedule stays
        deterministic on a `VirtualClock`)."""
        now = self.clock.now()
        out = []
        for k, q in self._queues.items():
            if not q:
                continue
            t = self.flush_at(k)
            if t is not None and now >= t:
                out.append((t, k))
        out.sort(key=lambda pair: pair[0])
        return [k for _, k in out]

    def next_due_time(self) -> float | None:
        """Earliest `flush_at` across buckets (a poll-loop wakeup hint)."""
        times = [t for k in self._queues
                 if (t := self.flush_at(k)) is not None and self._queues[k]]
        return min(times) if times else None

    # --- draining -------------------------------------------------------------

    def pop(self, key) -> list:
        """Remove and return a bucket's queued entries (FIFO order)."""
        return self._queues.pop(key, [])

    def pop_all(self) -> dict:
        """Remove and return every non-empty queue (drain)."""
        out = {k: q for k, q in self._queues.items() if q}
        self._queues = {}
        return out

    # --- load shedding --------------------------------------------------------

    def shed(self, policy: str) -> list:
        """Remove and return `(key, entry)` pairs whose deadline is
        unmeetable under `policy` ("never" sheds nothing; "late" sheds
        already-missed deadlines; "hopeless" also sheds entries the current
        estimate says cannot finish in time).  Deciding what the dropped
        entries *mean* (failing handles, purging siblings) is the engine's
        job, keeping this a pure queue transformation."""
        check_shed_policy(policy)
        if policy == "never":
            return []
        now = self.clock.now()
        out = []
        for k in list(self._queues):
            cut = now if policy == "late" else now + self.estimate(k)
            keep, drop = [], []
            for e in self._queues[k]:
                (drop if e.deadline is not None and cut > e.deadline
                 else keep).append(e)
            if drop:
                out.extend((k, e) for e in drop)
                if keep:
                    self._queues[k] = keep
                else:
                    del self._queues[k]
        return out

    def purge(self, pred) -> list:
        """Remove and return every queued entry whose *item* satisfies
        `pred` (used to drop a shed request's sibling items from other
        buckets so no execution is wasted on them)."""
        out = []
        for k in list(self._queues):
            keep = [e for e in self._queues[k] if not pred(e.item)]
            if len(keep) != len(self._queues[k]):
                out.extend(e for e in self._queues[k] if pred(e.item))
                if keep:
                    self._queues[k] = keep
                else:
                    del self._queues[k]
        return out

    # --- execute-time estimates ----------------------------------------------

    def observe(self, key, seconds: float) -> None:
        """Fold one measured bucket-execution duration into the per-layout
        estimate (EWMA; the first observation replaces the default) and the
        global cross-bucket EWMA that seeds cold buckets."""
        s = float(seconds)
        prev = self._estimates.get(key)
        self._estimates[key] = (s if prev is None else
                                self.ewma * s + (1.0 - self.ewma) * prev)
        self._global = (s if self._global is None else
                        self.ewma * s + (1.0 - self.ewma) * self._global)

    def estimate(self, key) -> float:
        """Expected execute seconds for the bucket: its own EWMA, else the
        global cross-bucket EWMA (a cold bucket on a warm plane behaves
        like its peers), else the conservative cold-start default."""
        est = self._estimates.get(key)
        if est is not None:
            return est
        if self._global is not None:
            return self._global
        return self.default_estimate


__all__ = ["FlushScheduler", "VirtualClock", "MonotonicClock",
           "COLD_START_ESTIMATE", "SHED_POLICIES", "check_shed_policy"]
