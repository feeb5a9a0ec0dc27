"""The port's program spans and counter registry (utils/profiling).

On the CPU: the registry's sums and buckets with and without a profiler
session, the spans as host-only profiler events on the clock the
profiler aligns the device's records to, and a small brute-force `path`
render that opens every span of the banded loop. On the card (`gpu`):
a profiled cbox render puts nothing of the spans on the device's
timeline.
"""

import time

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import native_build
from gdpt_tpu_torch.integrators import render
from gdpt_tpu_torch.scene import presets
from gdpt_tpu_torch.utils import profiling

# The spans of the banded `path` loop, and their calls in one frame of
# depth 6 at one sample a pixel (one pass, five bounces).
FRAME_SPANS = {
    "render.frame": 1, "render.scene": 2, "render.lanes": 2, "render.pass": 1,
    "render.wait": 1, "render.readback": 2, "render.image": 2, "path.primary": 1, "path.shade": 6,
    "path.nee": 5, "path.bsdf": 10, "path.mis": 6, "path.update": 10,
    "cast.closest": 6, "cast.shadow": 5,
}


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry for the test, the process's own put back after."""
    reg = profiling._Registry()
    reg.counters = profiling._REG.counters
    monkeypatch.setattr(profiling, "_REG", reg)
    return reg


def _kineto(activities):
    """Start a Kineto session through the profiler's own entry points;
    returns the function that stops it and gives its events."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd.profiler import (ProfilerConfig, ProfilerState, _disable_profiler,
                                         _enable_profiler, _prepare_profiler)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities)
    return lambda: _disable_profiler().events()


def test_registry_counts_and_times_without_a_profiler(registry, monkeypatch):
    """Calls and perf_counter durations add up by name; the first
    render.frame and what runs in it fill the warm bucket; no profiler
    event is made while none is enabled."""
    made = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast", lambda name: made.append(name))
    with profiling.span("render.lanes"):
        pass
    for _ in range(3):
        with profiling.span(profiling.FRAME):
            with profiling.span("path.shade"):
                time.sleep(0.002)
            with profiling.span("path.shade"):
                pass
    assert made == []
    shade = profiling.span_stats("path.shade")
    assert shade["calls"] == 6 and shade["ns"] >= 3 * 2_000_000
    assert shade["warm_calls"] == 2 and 2_000_000 <= shade["warm_ns"] < shade["ns"]
    assert shade["traced_calls"] == 0 and shade["untraced_calls"] == 4
    assert shade["untraced_ns"] == shade["ns"] - shade["warm_ns"]
    frame = profiling.span_stats(profiling.FRAME)
    assert (frame["calls"], frame["warm_calls"], frame["untraced_calls"]) == (3, 1, 2)
    assert frame["warm_ns"] >= shade["warm_ns"]
    # Before any frame: neither warm nor traced.
    assert profiling.span_stats("render.lanes")["untraced_calls"] == 1
    assert profiling.span_stats("never.run") == dict.fromkeys(profiling._BUCKETS, 0)
    assert registry.depth == 0 and registry.frames == 3


def test_spans_are_host_events_on_the_profilers_clock(registry):
    """Under a Kineto CPU session each span is one host event of its
    name, not a user annotation (so Kineto mirrors nothing of it on a
    device's timeline), with times on time.time_ns()'s clock."""
    from torch._C._profiler import ProfilerActivity

    stop = _kineto({ProfilerActivity.CPU})
    t0 = time.time_ns()
    with profiling.span(profiling.FRAME):
        with profiling.span("path.nee"):
            torch.ones(4).sum()
        with profiling.span("cast.shadow"):
            time.sleep(0.001)
    t1 = time.time_ns()
    events = stop()
    ours = {e.name(): e for e in events if e.name() in (profiling.FRAME, "path.nee",
                                                        "cast.shadow")}
    assert set(ours) == {profiling.FRAME, "path.nee", "cast.shadow"}
    assert sum(e.name() in ours for e in events) == 3
    for e in ours.values():
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()
        assert t0 <= e.start_ns() <= e.start_ns() + e.duration_ns() <= t1
    frame, nee, shadow = (ours[n] for n in (profiling.FRAME, "path.nee", "cast.shadow"))
    assert frame.start_ns() <= nee.start_ns() < shadow.start_ns()
    assert shadow.duration_ns() >= 1_000_000
    assert profiling.span_stats("cast.shadow")["traced_calls"] == 1


def test_nested_warm_traced_and_untraced_calls(registry):
    """The warm frame, a frame under a profiler session and plain frames
    fall in their buckets; untraced() sums only the plain calls, and a
    span that raises is counted and lets the error through."""
    from torch._C._profiler import ProfilerActivity

    @profiling.span("cast.closest")
    def cast(x):
        return x + 1

    def frame():
        with profiling.span(profiling.FRAME):
            with profiling.span("render.pass"):
                assert cast(1) == 2
                with profiling.span("render.pass"):  # nested, same name
                    pass

    frame()                                    # warm
    stop = _kineto({ProfilerActivity.CPU})
    frame()                                    # traced
    events = stop()
    frame()
    frame()                                    # untraced, twice
    assert [e.name() for e in events].count("render.pass") == 2
    stats = profiling.span_stats("render.pass")
    assert (stats["calls"], stats["warm_calls"], stats["traced_calls"],
            stats["untraced_calls"]) == (8, 2, 2, 4)
    ns, calls = profiling.untraced(["render.pass", "cast.closest", "never.run"])
    closest = profiling.span_stats("cast.closest")
    assert calls == 4 + 2 and ns == stats["untraced_ns"] + closest["untraced_ns"]
    assert profiling.untraced(["never.run"]) == (0, 0)
    with pytest.raises(ValueError, match="boom"):
        with profiling.span("path.bsdf"):
            raise ValueError("boom")
    assert profiling.span_stats("path.bsdf")["untraced_calls"] == 1
    # The warm frame stays the first one, whatever follows.
    assert profiling.span_stats(profiling.FRAME)["warm_calls"] == 1
    assert registry.depth == 0


def test_a_path_render_opens_every_span(registry):
    """A 16x16 brute-force cbox at depth 6, one sample a pixel: every
    span of the banded loop, as often as its stages run; the pass holds
    the casts and the frame holds the rest. native.load opens where a
    library is loaded (a CPU render loads none)."""
    scene = presets.cornell_box(16, 16, spp=1, max_depth=6)
    assert scene.static.use_brute_force
    for seed in (1, 2):
        img = render.render(scene, spp=1, seed=seed, device="cpu")
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    for name, per_frame in FRAME_SPANS.items():
        stats = profiling.span_stats(name)
        assert stats["calls"] == 2 * per_frame, name
        assert stats["warm_calls"] == per_frame and stats["untraced_calls"] == per_frame, name
    ns = {n: profiling.span_stats(n)["untraced_ns"] for n in FRAME_SPANS}
    assert ns["cast.closest"] + ns["cast.shadow"] < ns["render.pass"]
    fixed = sum(ns[n] for n in ("render.scene", "render.lanes", "render.readback",
                                "render.image"))
    assert fixed + ns["render.pass"] + ns["render.wait"] <= ns["render.frame"]
    builds = dict(native_build.BUILDS)
    native_build.load("bvh_builder.cpp")
    assert profiling.span_stats("native.load")["calls"] == 1
    assert sum(native_build.BUILDS.values()) == sum(builds.values()) + 1


def test_counters_are_the_modules_own_dicts():
    from gdpt_tpu_torch.accel import brute_kernels, packet_kernels, super16, traverse
    from gdpt_tpu_torch.accel import traverse_soa
    from gdpt_tpu_torch.integrators import volpath, volpath_soa

    groups = profiling.counters()
    for name, counts in {
            "brute_kernels.launches": brute_kernels.LAUNCHES,
            "packet_kernels.launches": packet_kernels.LAUNCHES,
            "traverse.host_reads": traverse.HOST_READS,
            "super16.host_reads": super16.HOST_READS,
            "traverse_soa.host_reads": traverse_soa.HOST_READS,
            "volpath.host_reads": volpath.HOST_READS,
            "volpath_soa.host_reads": volpath_soa.HOST_READS,
            "native_build.builds": native_build.BUILDS}.items():
        assert groups[name] is counts, name
    assert all(not name.startswith("cu") for name in groups)


def test_span_names_keep_clear_of_the_runtime_calls():
    """Trace readers skip host events whose names start with "cu" (the
    CUDA runtime's calls); no span may."""
    assert all(not name.startswith("cu") and "." in name
               for name in [*FRAME_SPANS, "native.load"])


@pytest.mark.gpu
def test_spans_leave_the_device_timeline_alone():
    """Under a CPU + CUDA session around a cbox render on the card, the
    spans are host events only: no CUDA-typed event carries a span's
    name, and the device records one operation per launch (a mirrored
    annotation would add one), retried where the profiler lost
    records. The box has unbounded depth, so its banded pass runs
    eagerly and opens every span in every frame (a pass of fixed depth
    replays a captured graph: test_torch_path_graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch._C._profiler import ProfilerActivity

    names = {*FRAME_SPANS, "native.load"}
    cuda_type = torch.autograd.DeviceType.CUDA
    scene = presets.cornell_box(64, 64, spp=1, max_depth=-1)
    render.render(scene, spp=1, seed=1)
    torch.cuda.synchronize()
    for attempt in range(3):
        stop = _kineto({ProfilerActivity.CPU, ProfilerActivity.CUDA})
        render.render(scene, spp=1, seed=2 + attempt)
        torch.cuda.synchronize()
        events = stop()
        device = [e.name() for e in events if e.device_type() == cuda_type]
        host = [e.name() for e in events if e.device_type() != cuda_type]
        launches = sum(n.startswith(profiling.LAUNCH_CALLS) for n in host)
        assert not names & set(device)
        assert names - {"native.load"} <= set(host)
        assert 0 < len(device) <= launches
        if len(device) == launches:
            break
    assert len(device) == launches
