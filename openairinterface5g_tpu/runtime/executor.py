"""Slot executor: pipelined per-slot dispatch with deadline tracking.

JAX analog of the reference's L1 threading (C6): the dedicated
L1_rx/L1_tx threads + notified FIFOs (executables/nr-gnb.c:110-288) and
the sl_ahead MAC pipeline become *async dispatch depth*: up to `depth`
slots are in flight on the device before the host blocks on the oldest
result — jax's async runtime is the thread pool.

The per-slot timing ring mirrors rt_L1_profiling (nr-gnb.c:162) and
feeds the same style of jitter statistics the reference prints via
time_meas/print_meas.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import jax


@dataclasses.dataclass
class SlotStats:
    slot: int
    dispatch_us: float      # host time to enqueue the slot's work
    complete_us: float      # wall time from dispatch until results ready
    deadline_miss: bool


class SlotExecutor:
    """Run a per-slot function over a stream of inputs, `depth` slots ahead.

    step_fn(slot_idx, *args) must be a jitted function returning pytrees
    of device arrays; results are surfaced in order.
    """

    def __init__(self, step_fn: Callable[..., Any], depth: int = 2,
                 slot_duration_s: float | None = None):
        self.step_fn = step_fn
        self.depth = depth
        self.slot_duration_s = slot_duration_s
        self.stats: list[SlotStats] = []

    def run(self, inputs: list[tuple], collect: bool = True):
        """Process all slots; returns list of (blocked) results in order."""
        inflight: collections.deque = collections.deque()
        results = []
        for i, args in enumerate(inputs):
            t0 = time.perf_counter()
            out = self.step_fn(i, *args)
            t1 = time.perf_counter()
            inflight.append((i, t0, t1, out))
            if len(inflight) > self.depth:
                results.append(self._retire(inflight.popleft()))
        while inflight:
            results.append(self._retire(inflight.popleft()))
        return results if collect else None

    def _retire(self, item):
        i, t0, t1, out = item
        out = jax.block_until_ready(out)
        t2 = time.perf_counter()
        miss = (self.slot_duration_s is not None
                and (t2 - t0) > self.slot_duration_s * (self.depth + 1))
        self.stats.append(SlotStats(
            slot=i, dispatch_us=(t1 - t0) * 1e6, complete_us=(t2 - t0) * 1e6,
            deadline_miss=miss))
        return out

    def percentiles(self) -> dict:
        """Latency distribution of retired slots (us)."""
        lat = sorted(s.complete_us for s in self.stats)
        n = len(lat)
        if not n:
            return {}
        return {
            "n_slots": n,
            "mean_us": sum(lat) / n,
            "p50_us": lat[n // 2],
            "p90_us": lat[min(n - 1, int(n * 0.90))],
            "p99_us": lat[min(n - 1, int(n * 0.99))],
            "max_us": lat[-1],
            "deadline_misses": sum(s.deadline_miss for s in self.stats),
        }

    def report(self) -> str:
        """dump_L1_meas_stats-style block (executables/nr-gnb.c:290): the
        per-slot wall-latency distribution against the slot budget."""
        p = self.percentiles()
        if not p:
            return "no slots executed"
        budget = (f"  budget {self.slot_duration_s*1e6:.0f} us x depth "
                  f"{self.depth}" if self.slot_duration_s else "")
        return (f"L1 slot latency (us): mean {p['mean_us']:.0f}  "
                f"p50 {p['p50_us']:.0f}  p90 {p['p90_us']:.0f}  "
                f"p99 {p['p99_us']:.0f}  max {p['max_us']:.0f}  over "
                f"{p['n_slots']} slots{budget}  deadline misses: "
                f"{p['deadline_misses']}")
