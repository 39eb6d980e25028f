"""Request deadline propagation (the search part of
opensearch_tpu/utils/deadline.py).

A search request's `timeout` becomes one budget, fixed where the REST
call accepts the body, that the executor checks between segments: one
segment is one device program, the natural cancellation point. The
budget is a duration anchored to `time.monotonic()`, and the active
deadline rides a context variable, so the executor consults it without a
parameter through every signature; `scope()` owns set and reset, so a
`timeout` in one body never leaks into the next.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Optional


class PartialResultsUnacceptable(Exception):
    """`allow_partial_search_results: false` and the request timed out:
    the whole request fails instead of serving a partial page (the REST
    client's 503 `search_phase_execution_exception`)."""


def parse_timeout_s(spec) -> Optional[float]:
    """A search `timeout` value in seconds. Time-value strings ("500ms",
    "2s", "1m", "1h", "250micros", "10nanos") and bare numbers, which are
    milliseconds. None or False: no deadline; a negative value is the
    "no timeout" sentinel (-1); zero is a budget spent at once. Raises
    ValueError on anything else."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, bool):
        raise ValueError(f"failed to parse timeout [{spec}]")
    if isinstance(spec, (int, float)):
        v = float(spec) / 1000.0
        return None if v < 0 else v
    s = str(spec).strip().lower()
    units = (("nanos", 1e-9), ("micros", 1e-6), ("ms", 1e-3),
             ("s", 1.0), ("m", 60.0), ("h", 3600.0), ("d", 86400.0))
    try:
        v = None
        for suffix, mult in units:
            if s.endswith(suffix):
                v = float(s[: -len(suffix)]) * mult
                break
        if v is None:
            v = float(s) / 1000.0
    except ValueError:
        raise ValueError(f"failed to parse timeout [{spec}]")
    return None if v < 0 else v


class Deadline:
    """A fixed budget anchored at creation."""

    __slots__ = ("budget_s", "_t0")

    def __init__(self, budget_s: float, _t0: Optional[float] = None):
        self.budget_s = float(budget_s)
        self._t0 = time.monotonic() if _t0 is None else _t0

    @classmethod
    def from_body(cls, body) -> Optional["Deadline"]:
        """The deadline of a search body's `timeout` (None without one).
        Raises ValueError on a malformed value."""
        if not isinstance(body, dict):
            return None
        budget = parse_timeout_s(body.get("timeout"))
        return cls(budget) if budget is not None else None

    def remaining_s(self) -> float:
        return self.budget_s - (time.monotonic() - self._t0)

    def exhausted(self) -> bool:
        return self.remaining_s() <= 0.0


_current: contextvars.ContextVar = contextvars.ContextVar(
    "opensearch_tpu_torch_deadline", default=None)


def current() -> Optional[Deadline]:
    return _current.get()


def set_current(dl: Optional[Deadline]):
    return _current.set(dl)


def reset_current(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def scope(dl: Optional[Deadline]):
    """Install `dl` as the ambient deadline for the duration (a no-op for
    None)."""
    if dl is None:
        yield None
        return
    token = set_current(dl)
    try:
        yield dl
    finally:
        reset_current(token)
