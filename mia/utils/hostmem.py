"""Host allocator tuning: keep large numpy/FFI buffers in the reusable heap.

On the deployment VMs, first-touch page faults on freshly mmapped memory
cost ~30 us/page — an order of magnitude more than the numpy compute that
touches them (measured: an identical 6M-element index-build loop runs 11 s
on first touch, 1.4 s from warm pages).  glibc serves any allocation above
the mmap threshold (dynamic, capped at 32 MB) via a fresh mmap and returns
it to the OS on free, so EVERY consensus/merge pass over a 100k-read
assembly re-faults hundreds of MB.

``tune_malloc`` raises the mmap/trim thresholds so large blocks come from
the main arena and stay resident across calls: the faults are paid once per
process instead of once per phase.  Memory high-water stays at peak working
set, which is the right trade for a throughput framework.

Reference analogue: none (the reference's working set is a few MB and never
leaves the heap).  Opt out with MIA_MALLOC_TUNE=0.
"""
from __future__ import annotations

import ctypes
import os

_done = False

# glibc mallopt param numbers (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4


def tune_malloc() -> bool:
    """Idempotent; returns True when the tuning was applied."""
    global _done
    if _done:
        return True
    if os.environ.get("MIA_MALLOC_TUNE", "1") == "0":
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
        mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        mallopt.restype = ctypes.c_int
        ok = mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        ok &= mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        _done = bool(ok)
        return _done
    except (OSError, AttributeError):
        return False
