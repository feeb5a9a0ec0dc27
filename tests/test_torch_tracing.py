"""The port's program spans and counter registry (utils/profiling).

On the CPU: the registry's sums and buckets with and without a profiler
session, the spans as host-only profiler events on the clock the
profiler aligns the device's records to, and a small brute-force `path`
render that opens every span of the banded loop, a small `gradpath`
render that opens the gradient-domain spans and counts its work, and the
benchmark's gdpt.* readers on such a render. On the card (`gpu`):
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


# The gradient-domain spans and the banded loop's fixed-work spans of one
# 16x16 gradpath frame at depth 6, one pass of `spp` samples: per sample
# the five primaries and up to seven bounces.
GDPT_SPANS = ("gdpt.primary", "gdpt.bounce", "gdpt.solve", "render.image", "render.lanes",
              "render.scene", "render.readback", "render.pass", "render.wait")


def _gradpath_frame(seed, spp=2):
    scene = presets.cornell_box(16, 16, spp=spp, integrator="gradpath", max_depth=6)
    return render.render(scene, spp=spp, seed=seed, device="cpu", return_stats=True)


def test_a_gradpath_render_opens_its_spans(registry):
    """Two 16x16 gradpath frames of two samples: gdpt.primary once a
    sample, gdpt.bounce as often as gdpt_soa.work counts bounces, one
    solve a frame, the host image's three stretches (the sums, the six
    buffers, the finite filter); the work counter counts every pixel
    sample."""
    from gdpt_tpu_torch.integrators import gdpt_soa

    assert profiling.counters()["gdpt_soa.work"] is gdpt_soa.WORK
    before = dict(gdpt_soa.WORK)
    for seed in (1, 2):
        img, rays = _gradpath_frame(seed)
        assert img.shape == (16, 16, 3) and np.isfinite(img).all() and rays > 0
    work = {k: gdpt_soa.WORK[k] - before[k] for k in before}
    assert work["samples"] == 2 * 2 * 16 * 16
    stats = {n: profiling.span_stats(n) for n in GDPT_SPANS}
    assert stats["gdpt.primary"]["calls"] == 2 * 2
    assert stats["gdpt.bounce"]["calls"] == work["bounces"]
    assert 2 * 2 <= work["bounces"] <= 2 * 2 * 7
    assert stats["gdpt.solve"]["calls"] == 2 and stats["render.image"]["calls"] == 2 * 3
    for name, st in stats.items():
        assert st["warm_calls"] > 0 and st["untraced_calls"] > 0, name
    frame = profiling.span_stats(profiling.FRAME)["untraced_ns"]
    inside = sum(st["untraced_ns"] for n, st in stats.items()
                 if n not in ("gdpt.primary", "gdpt.bounce"))
    assert stats["gdpt.bounce"]["untraced_ns"] < stats["render.pass"]["untraced_ns"]
    assert inside <= frame


def test_a_gradpath_render_is_the_same_under_the_profiler(registry):
    """Under a Kineto CPU session the spans become host events, and the
    image and ray count stay the same, bit for bit."""
    from torch._C._profiler import ProfilerActivity

    img, rays = _gradpath_frame(9)
    stop = _kineto({ProfilerActivity.CPU})
    img_p, rays_p = _gradpath_frame(9)
    names = {e.name() for e in stop()}
    assert {"gdpt.primary", "gdpt.bounce", "gdpt.solve", "render.image"} <= names
    assert rays_p == rays
    np.testing.assert_array_equal(img_p, img)
    assert profiling.span_stats("gdpt.solve")["traced_calls"] == 1


def _gdpt_readers():
    from benchmark.harness import session, spec

    names = ("gdpt.bounce_host_ms_per_msample", "gdpt.solve_ms_per_frame",
             "gdpt.fixed_ms_per_frame", "host.launches_per_msample", "integrator.rays_per_sample")
    return {n: spec.load_module("metrics", n) for n in names}, session


def test_gdpt_readers_read_a_cpu_record(registry):
    """The gradient-domain cell's gdpt.* readers, and the launches and
    rays readers it shares with the path cells, on three gradpath frames
    (a warm one and two plain ones) with a profile of the last: a number
    each, but the launches (no CUDA call on the CPU, so no whole
    profile)."""
    from benchmark.harness import profile

    readers, session = _gdpt_readers()
    rec = session.Record(16, 16, setup_s=1.0, parse_s=0.0)
    for i in range(3):
        t0 = time.perf_counter()
        _, rays = _gradpath_frame(i)
        rec.frames.append(session.Frame(i, i, 2, t0, time.perf_counter(), rays))
    rec.window_s = rec.frames[-1].t1 - rec.frames[1].t0
    rec.profile = profile.Profile(wall_s=rec.frames[-1].seconds, samples=2 * 16 * 16,
                                  rays=rec.frames[-1].rays)
    got = {n: r.read(rec) for n, r in readers.items()}
    assert got.pop("host.launches_per_msample") is None
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["integrator.rays_per_sample"] == rec.frames[-1].rays / (2 * 16 * 16)
    fixed = sum(profiling.span_stats(n)["untraced_ns"] for n in
                ("render.scene", "render.lanes", "render.readback", "render.image"))
    assert got["gdpt.fixed_ms_per_frame"] == fixed / 1e6 / 2


def test_gdpt_span_readers_read_nothing_without_the_spans(registry):
    """A program that opens no gdpt.* span (the parent's, or a `path`
    render) gives the span readers nothing to read; with no profile the
    shared readers read nothing either."""
    readers, session = _gdpt_readers()
    rec = session.Record(16, 16, setup_s=1.0, parse_s=0.0)
    scene = presets.cornell_box(16, 16, spp=1, max_depth=6)
    for i in range(3):
        render.render(scene, spp=1, seed=i, device="cpu")
        rec.frames.append(session.Frame(i, i, 1, 0.0, 0.01, 0.0))
    rec.window_s = 0.02
    for name in readers:
        assert readers[name].read(rec) is None, name


def test_counters_are_the_modules_own_dicts():
    from gdpt_tpu_torch.accel import brute_kernels, packet_kernels, super16, traverse
    from gdpt_tpu_torch.accel import traverse_soa
    from gdpt_tpu_torch.integrators import gdpt_soa, volpath, volpath_soa

    groups = profiling.counters()
    for name, counts in {
            "brute_kernels.launches": brute_kernels.LAUNCHES,
            "packet_kernels.launches": packet_kernels.LAUNCHES,
            "traverse.host_reads": traverse.HOST_READS,
            "super16.host_reads": super16.HOST_READS,
            "traverse_soa.host_reads": traverse_soa.HOST_READS,
            "volpath.host_reads": volpath.HOST_READS,
            "volpath_soa.host_reads": volpath_soa.HOST_READS,
            "gdpt_soa.work": gdpt_soa.WORK,
            "native_build.builds": native_build.BUILDS}.items():
        assert groups[name] is counts, name
    assert all(not name.startswith("cu") for name in groups)


def test_span_names_keep_clear_of_the_runtime_calls():
    """Trace readers skip host events whose names start with "cu" (the
    CUDA runtime's calls); no span may."""
    assert all(not name.startswith("cu") and "." in name
               for name in [*FRAME_SPANS, *GDPT_SPANS, "native.load"])


@pytest.mark.gpu
def test_spans_leave_the_device_timeline_alone():
    """Under a CPU + CUDA session around a cbox render on the card, the
    spans are host events only: no CUDA-typed event carries a span's
    name, and the device records one operation per launch (a mirrored
    annotation would add one), retried where the profiler lost
    records. The box has unbounded depth, so its banded pass runs
    eagerly and opens every span in every frame (a pass of fixed depth
    replays a captured graph: test_torch_path_graph); on the card its
    sample takes the fused stages, whose spans (path_fused.SPANS) stand
    in for trace_paths_soa's path.* spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch._C._profiler import ProfilerActivity

    from gdpt_tpu_torch.integrators import path_fused

    names = {*(n for n in FRAME_SPANS if not n.startswith("path.")), *path_fused.SPANS,
             "native.load"}
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
