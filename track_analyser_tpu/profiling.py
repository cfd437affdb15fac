"""Observability: per-stage timings and device traces.

The reference's only observability hook is the progress callback
(pipeline.py:38, 58-99). This module keeps that contract and adds the
device-side layer (SURVEY.md section 5): wall-clock stage timers that
can wrap any progress callback, and a ``jax.profiler`` trace context for
device-level inspection.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

__all__ = ["StageTimer", "device_trace"]


@dataclass
class StageTimer:
    """Records wall-clock time between progress-callback stages.

    Usage::

        timer = StageTimer()
        analyse_track(path, progress_callback=timer.callback(user_cb))
        print(timer.report())
    """

    stages: List[str] = field(default_factory=list)
    durations: Dict[str, float] = field(default_factory=dict)
    _last: float = field(default_factory=time.perf_counter)

    def callback(
        self, inner: Optional[Callable[[str], None]] = None
    ) -> Callable[[str], None]:
        self._last = time.perf_counter()

        def _cb(stage: str) -> None:
            now = time.perf_counter()
            self.stages.append(stage)
            self.durations[stage] = self.durations.get(stage, 0.0) + (now - self._last)
            self._last = now
            if inner is not None:
                inner(stage)

        return _cb

    @property
    def total(self) -> float:
        return sum(self.durations.values())

    def report(self) -> str:
        lines = [f"{'stage':<12} {'ms':>9} {'share':>7}"]
        total = self.total or 1.0
        for stage in self.stages:
            d = self.durations.get(stage, 0.0)
            lines.append(f"{stage:<12} {d * 1e3:>9.1f} {d / total:>6.1%}")
        lines.append(f"{'total':<12} {total * 1e3:>9.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace (open with TensorBoard/XProf)."""

    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
