"""Profiling & progress utilities, counterpart of gdpt_tpu/utils/profiling.py.

The reference's observability is a wall-clock Timer and a mutex-guarded
percent-done ProgressReporter (reference: src/timer.h, src/progress_reporter.h).
Here: a timer context, a host progress reporter driven from the render
driver's batch loop, and a torch.profiler device trace written as a
Chrome trace.
"""

import contextlib
import os
import sys
import time


@contextlib.contextmanager
def timer():
    """with timer() as t: ...; t() -> elapsed seconds."""
    start = time.perf_counter()
    done = [None]

    def elapsed():
        return done[0] if done[0] is not None else time.perf_counter() - start

    yield elapsed
    done[0] = time.perf_counter() - start


class ProgressReporter:
    """Percent-done reporting (reference: src/progress_reporter.h) — no
    mutex needed: the host batch loop is single threaded by design."""

    def __init__(self, total, stream=sys.stderr, enabled=True):
        self.total = max(total, 1)
        self.done = 0
        self.stream = stream
        self.enabled = enabled
        self._start = time.perf_counter()

    def update(self, n=1):
        self.done += n
        if self.enabled:
            pct = 100.0 * self.done / self.total
            dt = time.perf_counter() - self._start
            self.stream.write(f"\r{pct:5.1f}% ({dt:.1f}s)")
            self.stream.flush()

    def finish(self):
        if self.enabled:
            self.stream.write("\n")
            self.stream.flush()


@contextlib.contextmanager
def device_trace(logdir):
    """Record the host's operations and, where CUDA is available, the
    device's kernels with torch.profiler; the trace is written to
    `logdir`/trace.json (Chrome trace format) when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
