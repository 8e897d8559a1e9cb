"""In-process resilience event log (capped ring buffer).

A tiny keep-latest registry the degradation machinery writes to and the
chaos gate asserts on: planner downgrades (`repro_torch.fft.plan(...,
fallback="degrade")`), simulated device loss/restore (`meshstate`),
service degradation (`repro_torch.serve.fft_service`). Kept separate from
Python logging so tests and benchmarks can make *structural* assertions
("exactly one downgrade event, from distributed to local") instead of
grepping log text; every record is also mirrored to the
``repro_torch.resilience`` logger at WARNING for human eyes.

The buffer is bounded (default 4096 events, `set_capacity` to resize):
a long-running service emitting degrade/retry events forever must not
leak memory, so the oldest events are evicted keep-latest and counted in
`dropped()` — an assertion that needs the full history should either
raise the capacity or snapshot via `events()` as it goes.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

log = logging.getLogger("repro_torch.resilience")

DEFAULT_CAPACITY = 4096

_LOCK = threading.Lock()
_EVENTS: deque[dict] = deque(maxlen=DEFAULT_CAPACITY)
_DROPPED = 0


def record_event(kind: str, **fields) -> dict:
    """Append one event ``{"kind": kind, "t": wall_time, **fields}``.

    When the ring is full the OLDEST event is evicted (keep-latest) and
    the drop counter advances; recording never blocks or grows memory.
    """
    global _DROPPED
    ev = {"kind": kind, "t": time.time(), **fields}
    with _LOCK:
        if len(_EVENTS) == _EVENTS.maxlen:
            _DROPPED += 1
        _EVENTS.append(ev)
    log.warning("resilience event: %s %s", kind, fields)
    return ev


def events(kind: str | None = None) -> list[dict]:
    """Snapshot of retained events (oldest first), optionally filtered."""
    with _LOCK:
        snap = list(_EVENTS)
    return snap if kind is None else [e for e in snap if e["kind"] == kind]


def dropped() -> int:
    """Events evicted from the ring since the last `clear_events()`."""
    with _LOCK:
        return _DROPPED


def capacity() -> int:
    """Current ring size (events retained before keep-latest eviction)."""
    with _LOCK:
        return _EVENTS.maxlen


def set_capacity(size: int) -> None:
    """Resize the ring, keeping the newest events that still fit (evicted
    ones count as dropped)."""
    global _EVENTS, _DROPPED
    if size < 1:
        raise ValueError(f"event-log capacity must be >= 1, got {size}")
    with _LOCK:
        kept = deque(_EVENTS, maxlen=size)
        _DROPPED += len(_EVENTS) - len(kept)
        _EVENTS = kept


def stats() -> dict:
    """``{"retained", "capacity", "dropped"}`` counters for reports."""
    with _LOCK:
        return {"retained": len(_EVENTS), "capacity": _EVENTS.maxlen,
                "dropped": _DROPPED}


def clear_events() -> None:
    """Reset the log and drop counter (test/benchmark isolation)."""
    global _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _DROPPED = 0
