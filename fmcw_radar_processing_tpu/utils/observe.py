"""Observability: stage timers, throughput counters, traces, event log.

The reference's entire observability story is `disp`/`fprintf` progress
lines (radar_processing.m:87,448-449,592; send_json_string_to_blob_
storage.m:32,35) plus Azure-side dashboards (SURVEY §5.1/§5.5). The
framework-native replacement:

  * ``StageTimer``   — wall-clock per pipeline stage, with the critical
    device detail handled: jax dispatch is async, so a stage's arrays are
    ``block_until_ready``-synced before its clock stops. Derives
    throughput (items/s) per stage.
  * ``trace``        — context manager around ``jax.profiler`` emitting a
    TensorBoard/XProf trace directory for kernel-level analysis.
  * ``log_event``    — one structured JSON line per event on stderr; the
    greppable successor of the reference's emoji prints.

All host-side; nothing here runs inside a compiled graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Any, Iterator


def _sync(value: Any) -> None:
    """Block until every jax array in a pytree result is materialized."""
    try:
        import jax
    except Exception:  # pragma: no cover — jax is a hard dep in practice
        return
    for leaf in jax.tree_util.tree_leaves(value):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


@dataclasses.dataclass
class StageRecord:
    seconds: float
    items: int | None = None

    @property
    def items_per_s(self) -> float | None:
        if self.items is None or self.seconds <= 0:
            return None
        return self.items / self.seconds


class StageTimer:
    """Collects per-stage wall times across one or more runs.

    Usage::

        timer = StageTimer()
        with timer.stage("fast_time", items=num_frames):
            out = chain(raw, calib)          # async dispatch…
            timer.observe(out)               # …synced before the stop
    """

    def __init__(self) -> None:
        self.records: dict[str, StageRecord] = {}
        self._pending: Any = None

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None) -> Iterator[None]:
        self._pending = None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._pending is not None:
                _sync(self._pending)
                self._pending = None
            dt = time.perf_counter() - t0
            prev = self.records.get(name)
            if prev is None:
                self.records[name] = StageRecord(dt, items)
            else:  # accumulate across repeated runs of the same stage
                prev.seconds += dt
                if items is not None:
                    prev.items = (prev.items or 0) + items

    def observe(self, value: Any) -> Any:
        """Mark device output(s) to be synced before the stage clock stops."""
        self._pending = value
        return value

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records.values())

    def report(self) -> dict:
        total = self.total_seconds or 1.0
        out = {}
        for name, r in self.records.items():
            row: dict[str, Any] = {
                "seconds": round(r.seconds, 6),
                "share": round(r.seconds / total, 4),
            }
            if r.items_per_s is not None:
                row["items"] = r.items
                row["items_per_s"] = round(r.items_per_s, 2)
            out[name] = row
        return out

    def pretty(self) -> str:
        rows = [f"{'stage':<24}{'seconds':>10}{'share':>8}{'items/s':>14}"]
        for name, row in self.report().items():
            ips = row.get("items_per_s")
            rows.append(
                f"{name:<24}{row['seconds']:>10.4f}{row['share']:>8.1%}"
                f"{(f'{ips:,.0f}' if ips is not None else '—'):>14}"
            )
        rows.append(f"{'total':<24}{self.total_seconds:>10.4f}")
        return "\n".join(rows)


class NullTimer:
    """No-op StageTimer stand-in — lets pipelines take ``timer=None``."""

    records: dict[str, StageRecord] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None) -> Iterator[None]:
        yield

    def observe(self, value: Any) -> Any:
        return value


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Capture a jax profiler trace (TensorBoard `trace_viewer` format).

    Wrap the region of interest; view with
    ``tensorboard --logdir <trace_dir>`` or xprof. Works on GPU and CPU.
    """
    import os

    import jax

    os.makedirs(trace_dir, exist_ok=True)  # jax NOT_FOUNDs on a missing dir
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_event(event: str, *, stream=None, **fields: Any) -> dict:
    """Emit one structured JSON event line (stderr by default).

    The reference's `disp('✅ …')` equivalent, machine-parseable. Returns
    the record (handy for tests and for request audit trails).
    """
    record = {"ts": round(time.time(), 3), "event": event, **fields}
    print(json.dumps(record, default=str), file=stream or sys.stderr)
    return record
