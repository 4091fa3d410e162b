"""Tracing / profiling subsystem (SURVEY.md §5.1).

The reference has no profiling beyond wall-clock prints
(/root/reference/nl-partsol/src/InOutFun/print_ScreenMessage.c:24-60);
this package provides:

* :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard/XProf trace directory (device timelines, HLO op breakdown,
  memory viewer).
* :class:`StageTimer` — coarse per-stage wall timers with device sync at
  the boundaries, for host-side stage breakdowns (the tool behind PERF.md's
  tables; use for driver-loop granularity, the profiler trace for kernels).
* :func:`annotate` — named ``TraceAnnotation`` context so custom stages
  show up on the device timeline inside a :func:`trace` capture.
* :func:`throughput` — nnz/s + step/s summary dict from counters.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """Capture a profiler trace into ``log_dir`` (view with TensorBoard's
    profile plugin / XProf)."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region on the device timeline (inside a :func:`trace`)."""
    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Accumulating per-stage wall timers with device synchronisation.

    >>> st = StageTimer()
    >>> with st("p2g"):
    ...     out = step(...)            # any jax computation
    >>> st.summary()                   # {'p2g': {'total_s': ..., 'calls': N}}

    Each region blocks on device completion at exit, so stage times are
    honest on an async backend — use at driver granularity (per step /
    per output interval), not around individual ops inside jit.
    """

    def __init__(self):
        self.totals: dict = {}
        self.calls: dict = {}
        self._sync_out = None

    @contextlib.contextmanager
    def __call__(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: dict(total_s=self.totals[k], calls=self.calls[k],
                    mean_s=self.totals[k] / max(self.calls[k], 1))
            for k in self.totals
        }

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'stage':<28}{'total s':>10}{'calls':>8}{'mean ms':>10}{'%':>6}"]
        for k, v in rows:
            n = self.calls[k]
            lines.append(
                f"{k:<28}{v:>10.3f}{n:>8}{1e3 * v / max(n, 1):>10.2f}"
                f"{100 * v / total:>6.1f}"
            )
        return "\n".join(lines)


def throughput(nnz_total: int, steps: int, wall_s: float) -> dict:
    """nnz/s + step-rate summary (BASELINE.md metric #1 accounting)."""
    return dict(
        nnz=int(nnz_total),
        steps=int(steps),
        wall_s=float(wall_s),
        nnz_per_s=float(nnz_total) / max(wall_s, 1e-12),
        steps_per_s=float(steps) / max(wall_s, 1e-12),
    )
