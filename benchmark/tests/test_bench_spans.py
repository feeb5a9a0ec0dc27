"""The span metrics (benchmark/metrics: render.fixed_ms_per_frame,
integrator.host_ms_per_msample, setup.first_frame_s) on a synthetic
record and span registry, and the cases in which each reads nothing."""

import pytest

from benchmark.harness import spec
from benchmark.harness.session import Frame, Record

METRICS = ("render.fixed_ms_per_frame", "integrator.host_ms_per_msample",
           "setup.first_frame_s")
MS = 1_000_000  # ns


@pytest.fixture
def profiling(monkeypatch):
    """The program's profiling module with an empty registry of its own."""
    from gdpt_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_REG", profiling._Registry())
    return profiling


def _read(name, rec):
    return spec.load_module("metrics", name).read(rec)


def _record(n_frames=10, spp=1):
    rec = Record(512, 512, setup_s=9.0, parse_s=0.01)
    rec.frames = [Frame(i, i, spp, 0.0, 0.075, 0.0) for i in range(n_frames)]
    return rec


def _fill(profiling, untraced_frames=4):
    """A warm frame of 2 s, two profiled frames and `untraced_frames`
    plain ones: each plain frame 80 ms, of which 10 ms fixed work
    (scene 1, lanes 3, read-back 2, image 4), a 66 ms pass, 3 ms of
    closest casts and 1 ms of shadow casts in it."""
    add = profiling.add
    add("render.frame", 2000 * MS, warm=True)
    add("native.load", 500 * MS, warm=True)
    for _ in range(2):
        add("render.frame", 150 * MS, traced=True)
        add("render.pass", 130 * MS, traced=True)
        add("cast.closest", 9 * MS, traced=True)
    for _ in range(untraced_frames):
        add("render.frame", 80 * MS)
        add("render.scene", 1 * MS)
        add("render.lanes", 3 * MS)
        add("render.readback", 2 * MS)
        add("render.image", 4 * MS)
        add("render.pass", 66 * MS)
        for _ in range(6):
            add("cast.closest", MS // 2)
        for _ in range(5):
            add("cast.shadow", MS // 5)


def test_readers_on_a_synthetic_registry(profiling):
    _fill(profiling)
    rec = _record()
    msample = 512 * 512 / 1e6  # a frame's, at one sample a pixel
    assert _read("render.fixed_ms_per_frame", rec) == pytest.approx(10.0)
    assert _read("integrator.host_ms_per_msample", rec) == pytest.approx(62.0 / msample)
    assert _read("setup.first_frame_s", rec) == pytest.approx(2.0)
    # The fixed work, the pass less its casts and the casts' 4 ms make up
    # the plain frame's 80 ms but the 4 ms outside every span.
    parts = (_read("render.fixed_ms_per_frame", rec)
             + _read("integrator.host_ms_per_msample", rec) * msample + 4.0)
    assert parts == pytest.approx(76.0)


def test_samples_follow_the_frames_samples_per_pixel(profiling):
    _fill(profiling)
    assert _read("integrator.host_ms_per_msample", _record(spp=4)) == pytest.approx(
        62.0 / (4 * 512 * 512 / 1e6))


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_a_frame(profiling, name):
    """No render.frame call (the registry of a run that never rendered)."""
    profiling.add("cast.closest", MS)
    assert _read(name, _record()) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_from_a_program_without_spans(profiling, monkeypatch, name):
    """A program whose profiling module keeps no spans (the version
    before them): every reader returns None and raises nothing."""
    _fill(profiling)
    monkeypatch.delattr(profiling, "untraced")
    monkeypatch.delattr(profiling, "span_stats")
    assert _read(name, _record()) is None


@pytest.mark.parametrize("name", METRICS[:2])
def test_nothing_without_an_untraced_frame(profiling, name):
    """Only the warm frame and profiled ones: the untraced metrics read
    nothing; the first frame's still reads."""
    _fill(profiling, untraced_frames=0)
    assert _read(name, _record()) is None
    assert _read("setup.first_frame_s", _record()) == pytest.approx(2.0)


def test_no_pass_or_no_cast_reads_nothing(profiling):
    """A frame that ran no banded pass (the wavefront, say) has no
    integrator split."""
    profiling.add("render.frame", 2000 * MS, warm=True)
    profiling.add("render.frame", 80 * MS)
    rec = _record()
    assert _read("integrator.host_ms_per_msample", rec) is None
    assert _read("render.fixed_ms_per_frame", rec) == 0.0
    assert _read("integrator.host_ms_per_msample", Record(512, 512, 9.0, 0.01)) is None


def test_every_span_metric_is_declared_for_the_cell():
    b = spec.load_spec()
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in METRICS:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["cbox_512_path.frames_256spp"]
        spec.load_module("metrics", name)
