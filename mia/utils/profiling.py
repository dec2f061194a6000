"""Phase timers, counters and device-trace hooks.

The reference has no observability beyond stderr dots (SURVEY §5); this is
the framework-level replacement:

* :func:`phase` — context manager accumulating wall time per named phase
  (nested phases attribute to the innermost name only when exclusive=True).
* :func:`count` — named counters (reads aligned, batches dispatched, host
  fallbacks, device entries...).
* :func:`report` — one JSON object with phases, counters and totals; the
  mia CLI prints it to stderr under ``--profile``.
* :func:`device_trace` — wraps a region in ``jax.profiler`` trace collection
  when MIA_TRACE_DIR is set (inspect with TensorBoard/xprof).

Zero overhead when disabled: ``enable()`` must be called first; every hook
checks one module flag.
"""
from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager

_enabled = False
_phases: dict[str, float] = {}
_counts: dict[str, int] = {}
_t0 = 0.0


def enable() -> None:
    global _enabled, _t0
    _enabled = True
    _t0 = time.time()
    _phases.clear()
    _counts.clear()


def enabled() -> bool:
    return _enabled


@contextmanager
def phase(name: str):
    """Accumulate wall time under ``name`` (no-op when disabled)."""
    if not _enabled:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        _phases[name] = _phases.get(name, 0.0) + (time.time() - t0)


def add_time(name: str, seconds: float) -> None:
    """Accumulate an externally measured duration (no-op when disabled)."""
    if _enabled:
        _phases[name] = _phases.get(name, 0.0) + seconds


def count(name: str, n: int = 1) -> None:
    if _enabled:
        _counts[name] = _counts.get(name, 0) + n


@contextmanager
def device_trace():
    """Collect a jax profiler trace for the wrapped region when
    MIA_TRACE_DIR is set (works on any backend)."""
    trace_dir = os.environ.get("MIA_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def report(out=None) -> dict:
    """Emit the collected profile as one JSON line (stderr by default)."""
    rep = {
        "total_s": round(time.time() - _t0, 3),
        "phases_s": {k: round(v, 3) for k, v in sorted(_phases.items())},
        "counters": dict(sorted(_counts.items())),
        # False proves this process never initialised a JAX backend (a
        # client of the resident server must not open the card)
        "jax_imported": "jax" in sys.modules,
    }
    if _enabled:
        print("MIA_PROFILE " + json.dumps(rep), file=out or sys.stderr)
    return rep
