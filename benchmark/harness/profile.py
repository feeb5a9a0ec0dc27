"""One torch.profiler session over a stretch of whole frames, reduced to
what the per-layer metrics read.

The session records the host's operations (aten ops and the CUDA runtime
calls) and the device's operations (kernels, copies, fills). It is read
through the profiler's raw event list: the profiler's own tree of
FunctionEvents takes minutes for the hundreds of thousands of launches a
stretch of frames makes.

Launches are counted from the host's runtime calls that put an
operation on the device, and the stretch is valid only where the device
recorded an operation for every launch (the profiler can lose device
records). The hand-written ray-casting kernels K1-K4 are matched by a
part of their names.
"""

import bisect
import json
import os
from dataclasses import dataclass, field

# The CUDA API calls that put an operation on the device.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
# K1, K2 (brute force), K3 and K4 (the packet-table walks), by name.
HAND_KERNELS = ("intersect_brute_kernel", "occluded_brute_kernel", "packet_trace_kernel",
                "packet_trace_dual_kernel")
TRACE_EVENTS_MAX = 200_000


@dataclass
class Profile:
    wall_s: float                 # the profiled frames' wall
    samples: int                  # pixel samples of those frames
    rays: float                   # rays the program counted in them
    launches: int = 0
    device_ops: int = 0
    busy_s: float = 0.0           # union of device-operation intervals
    device_s: float = 0.0         # summed device-operation time
    hand_s: float = 0.0           # K1-K4's summed device time
    top_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def whole(self):
        return self.device_ops >= self.launches > 0


class Session:
    """start() before the first profiled frame, stop() after the last one
    has synchronised; reduce() once the window has closed."""

    def __init__(self, cuda=True):
        import torch
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd.profiler import ProfilerConfig, ProfilerState

        self._torch = torch
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                     _ExperimentalConfig())
        self.activities = {ProfilerActivity.CPU}
        if cuda:
            self.activities.add(ProfilerActivity.CUDA)
        self.result = None

    def start(self):
        from torch.autograd.profiler import _enable_profiler, _prepare_profiler

        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities)

    def stop(self):
        from torch.autograd.profiler import _disable_profiler

        self.result = _disable_profiler()

    def reduce(self, prof: Profile, trace_path=None):
        """Fill prof from the recorded events; write a Chrome trace of at
        most TRACE_EVENTS_MAX events to trace_path where given."""
        cuda_type = self._torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self.result.events():
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda_type:
                dev.append((start, start + dur, name))
            else:
                if name.startswith(LAUNCH_CALLS):
                    prof.launches += 1
                host.append((start, start + dur, name))
        dev.sort()
        host.sort()
        prof.device_ops = len(dev)
        by_name = {}
        busy, cur_lo, cur_hi = 0, None, None
        gaps = []
        for lo, hi, name in dev:
            by_name[name] = by_name.get(name, 0) + (hi - lo)
            prof.device_s += (hi - lo) / 1e9
            if any(k in name for k in HAND_KERNELS):
                prof.hand_s += (hi - lo) / 1e9
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    busy += cur_hi - cur_lo
                    gaps.append((lo - cur_hi, cur_hi, lo))
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            busy += cur_hi - cur_lo
        prof.busy_s = busy / 1e9
        prof.top_ops = [[n, t / 1e9] for n, t in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        prof.idle_gaps = [[_host_op(host, (a + b) // 2), g / 1e9]
                          for g, a, b in sorted(gaps, reverse=True)[:10]]
        if trace_path is not None:
            _write_trace(trace_path, host, dev)
        self.result = None


def _host_op(host, t):
    """The innermost host operation other than a CUDA runtime call running
    at time t (the latest-started one that has not ended), or "host,
    between operations"."""
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for lo, hi, name in reversed(host[max(0, i - 64):i]):
        if lo <= t < hi and not name.startswith("cu"):
            return name
    return "host, between operations"


def _write_trace(path, host, dev):
    """A Chrome trace (chrome://tracing, Perfetto) of the first events in
    time, host on one row and device on another."""
    events = sorted([(lo, hi, n, 0) for lo, hi, n in host] + [(lo, hi, n, 1) for lo, hi, n in dev])
    events = events[:TRACE_EVENTS_MAX]
    t0 = events[0][0] if events else 0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": [
            {"name": n, "ph": "X", "pid": 0, "tid": row, "ts": (lo - t0) / 1e3,
             "dur": (hi - lo) / 1e3} for lo, hi, n, row in events]}, f)
