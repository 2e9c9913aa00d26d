"""Shared monotonic integer-µs clock for every telemetry stream
(counterpart of ``deepspeed_tpu/telemetry/clock.py``).

* :func:`monotonic_us` — the one ordering axis: integer microseconds on
  the process monotonic clock (``time.monotonic_ns() // 1000``), integer
  so equality and order survive a JSON round trip. The run chronicle
  orders every event on it.
* :func:`to_unix_us` / :func:`unix_us` — rendering only: one
  ``(monotonic, unix)`` anchor pair is sampled at import, so any
  monotonic stamp converts to an approximate wall time through the same
  fixed offset. Joins and ordering always use the monotonic stamps.

Host-only, stdlib-only.
"""

import time

# one anchor pair for the whole process, sampled back to back at import:
# every renderer maps monotonic -> wall through the same offset
_ANCHOR_MONO_US = time.monotonic_ns() // 1000
_ANCHOR_UNIX_US = time.time_ns() // 1000


def monotonic_us():
    """Integer microseconds on the process monotonic clock."""
    return time.monotonic_ns() // 1000


def monotonic_s():
    """The same clock as :func:`monotonic_us`, in float seconds."""
    return time.monotonic_ns() / 1e9


def to_unix_us(t_us):
    """Render a :func:`monotonic_us` stamp as approximate unix µs (fixed
    process-wide offset; rendering only, never ordering)."""
    return int(t_us) - _ANCHOR_MONO_US + _ANCHOR_UNIX_US


def unix_us():
    """Approximate unix µs of *now*, through the same anchor."""
    return to_unix_us(monotonic_us())


def from_unix_us(u_us):
    """Inverse of :func:`to_unix_us`: map a unix-µs stamp back onto this
    process's monotonic axis through the same anchor pair (how another
    process's events, which carry ``unix_us``, join this one's axis)."""
    return int(u_us) - _ANCHOR_UNIX_US + _ANCHOR_MONO_US
