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


# The hand-written ray-casting kernels, by a part of each kernel's name as
# the profiler records it: K1, K2 (accel/brute_kernels.py), K3 and K4
# (accel/packet_kernels.py).
HAND_KERNELS = ("intersect_brute_kernel", "occluded_brute_kernel", "packet_trace_kernel",
                "packet_trace_dual_kernel")


def _hand_launches():
    from gdpt_tpu_torch.accel import brute_kernels, packet_kernels

    return sum(brute_kernels.LAUNCHES.values()) + sum(packet_kernels.LAUNCHES.values())


# The CUDA API calls that put an operation on the device.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def device_stats(prof):
    """From a torch.profiler run: the device operations launched
    (`launches`: kernel launches, copies and fills, counted from the
    host's runtime calls), the device operations the profiler recorded
    (`device_ops`), their summed device time (`device_ms`) and the hand
    kernels' share of it (`hand_ms`). The profiler can lose some or all
    of a run's device records while its host records stay whole:
    device_ops < launches says so."""
    import torch

    averages = prof.key_averages()
    # A scheduled profiler also puts its step on the device's timeline as
    # an annotation spanning the step's kernels ("ProfilerStep#n"): not
    # an operation.
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")
              and not getattr(e, "is_user_annotation", False)]
    dev_us = [(e.key, getattr(e, "self_device_time_total", 0), e.count) for e in events]
    return {
        "launches": sum(e.count for e in averages
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and any(e.key.startswith(c) for c in LAUNCH_CALLS)),
        "device_ops": sum(count for _, _, count in dev_us),
        "device_ms": sum(us for _, us, _ in dev_us) / 1e3,
        "hand_ms": sum(us for key, us, _ in dev_us
                       if any(name in key for name in HAND_KERNELS)) / 1e3,
    }


# The sleep kernel that a stage's CUDA-event timing is queued behind, in
# clock cycles: about half a millisecond, long enough for the host to
# queue a stage of a few launches before the start event fires.
SLEEP_CYCLES = 1_000_000


def event_span_ms(fn, call_args, reps=3):
    """Least ms, over `reps` calls, between CUDA events recorded around
    one call of fn(*call_args()), each call queued behind a sleep kernel
    so that the span starts with the call's first operation on the device
    rather than with the host's first launch: for a stage of one or a few
    launches, its device time; for a longer one, an upper bound on it
    (the span also holds the device's gaps between launches)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        a = call_args()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(*a)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def stage_profile(fn, *args, device, reps=3, setup=None):
    """Time one stage as the reference's tools time a jitted stage: a
    warm call, then the least wall of `reps` calls, each between
    synchronizes. Returns (the last call's output, row), row holding
    `wall_ms` and, on the card:
    - `event_ms`: event_span_ms of the stage;
    - from one more call under torch.profiler (the active step of a
      profiler run whose warm-up step makes one call too): `launches`,
      `device_ops`, `device_ms`, `hand_ms` (device_stats) and
      `hand_launches` (the K1-K4 wrappers' LAUNCHES counted in that
      call), and `whole`: whether the profiler recorded a device
      operation for every launch. A run that lost records is taken again,
      up to four times; where none was whole, `device_ms` and `hand_ms`
      are None, not a sum over what was kept.
    On the CPU all but `wall_ms` are None. In the eager port a stage's
    wall is mostly host launches, so the device time is the stage's own
    split.

    setup: a function returning the call's arguments, called before every
    call outside its timing (a stage that updates its inputs in place
    gets fresh copies); else `args` are passed to every call."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def call_args():
        return setup() if setup is not None else args

    out = fn(*call_args())
    best = float("inf")
    for _ in range(reps):
        a = call_args()
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        best = min(best, time.perf_counter() - t0)
    row = {"wall_ms": best * 1e3, "event_ms": None, "launches": None, "device_ops": None,
           "device_ms": None, "hand_ms": None, "hand_launches": None, "whole": None}
    if cuda:
        from torch.profiler import ProfilerActivity, profile, schedule

        with torch.cuda.device(dev):
            row["event_ms"] = event_span_ms(fn, call_args, reps)
        # The call is profiled in the active step of a profiler run whose
        # warm-up step (a warm call, and the arguments' setup) runs while
        # CUPTI starts. The most complete of up to five runs is kept.
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                fn(*call_args())
                a = call_args()
                sync()
                before = _hand_launches()
                prof.step()
                fn(*a)
                sync()
                hand = _hand_launches() - before
                prof.step()
            stats = device_stats(prof)
            if row["device_ops"] is None or stats["device_ops"] > row["device_ops"]:
                row.update(stats, hand_launches=hand)
            if stats["device_ops"] >= stats["launches"]:
                break
        row["whole"] = row["device_ops"] >= row["launches"]
        if not row["whole"]:
            row["device_ms"] = row["hand_ms"] = None
    return out, row


def device_note(row, hand="K1-K4"):
    """A stage row's device split as the tools print it: its launches, the
    device time the profiler recorded (or that it lost some of the
    records), the hand kernels' share and the CUDA-event span; "" where
    the row has none (the CPU)."""
    if row.get("launches") is None:
        return ""
    if row["device_ms"] is None:
        dev = f"device not recorded whole ({row['device_ops']} ops)"
    else:
        dev = (f"device {row['device_ms']:.3f} ms, {hand} {row['hand_ms']:.3f} ms in "
               f"{row['hand_launches']}")
    return f"{row['launches']} launches, {dev}, events {row['event_ms']:.3f} ms"
