"""Hierarchical wall-clock profiler.

Host-side analog of the reference's RAII `Timer`/`Stopwatch`/`ProfileEntry`
profiler (`altro/common/timer.hpp:41-95`, `timer.cpp:10-134`,
`profile_entry.hpp:20-36`): nested named scopes accumulate microseconds into
"al/ilqr/forward_pass/cost"-style paths, and `print_summary` reconstructs the
call tree with time / %total / %parent columns like
`perf/profiler_unicycle.out`.

On an accelerator the device work is asynchronous, so scopes that wrap jitted calls
measure dispatch unless you block; pass `block=True` (or use
`jax.profiler.trace` for device-side timelines — `trace_context` wraps both).
Inactive timers cost one dict lookup (~the reference's "free when off",
`timer.hpp:27-29`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


class Timer:
    """Hierarchical profiler with named scopes."""

    def __init__(self, active: bool = False):
        self.active = active
        self._stack: list[str] = []
        self._times_us: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def activate(self) -> None:
        self.active = True

    def deactivate(self) -> None:
        self.active = False

    def reset(self) -> None:
        self._times_us.clear()
        self._counts.clear()
        self._stack.clear()

    @contextlib.contextmanager
    def scope(self, name: str, block: bool = False):
        """Time a named scope; keys concatenate along the live stack
        (`timer.cpp:96-106`)."""
        if not self.active:
            yield
            return
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                # drain device queue so the scope includes device time
                jax.effects_barrier()
            dt_us = (time.perf_counter() - t0) * 1e6
            self._times_us[key] = self._times_us.get(key, 0.0) + dt_us
            self._counts[key] = self._counts.get(key, 0) + 1
            self._stack.pop()

    @contextlib.contextmanager
    def trace_context(self, name: str):
        """Host scope + jax.profiler.TraceAnnotation for device timelines."""
        with self.scope(name):
            with jax.profiler.TraceAnnotation(name):
                yield

    def get_us(self, key: str) -> float:
        return self._times_us.get(key, 0.0)

    def summary(self) -> str:
        """Indented call-tree table (`timer.cpp:24-94`,
        format of `perf/profiler_unicycle.out`)."""
        if not self._times_us:
            return "(no profile data)\n"
        keys = sorted(self._times_us)
        roots = [k for k in keys if "/" not in k]
        total = sum(self._times_us[k] for k in roots)
        lines = [f"{'scope':<40}{'time (ms)':>12}{'%total':>9}{'%parent':>9}{'count':>8}"]

        def emit(key: str, depth: int):
            t = self._times_us[key]
            parent = key.rsplit("/", 1)[0] if "/" in key else None
            pt = self._times_us.get(parent, total) if parent else total
            name = "  " * depth + key.rsplit("/", 1)[-1]
            lines.append(
                f"{name:<40}{t / 1000:>12.3f}"
                f"{100 * t / total if total else 0:>8.1f}%"
                f"{100 * t / pt if pt else 0:>8.1f}%"
                f"{self._counts.get(key, 0):>8d}"
            )
            children = [
                k
                for k in keys
                if k.startswith(key + "/") and "/" not in k[len(key) + 1 :]
            ]
            for c in children:
                emit(c, depth + 1)

        for r in roots:
            emit(r, 0)
        return "\n".join(lines) + "\n"

    def print_summary(self, file=None) -> None:
        print(self.summary(), file=file, end="")
