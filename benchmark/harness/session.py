"""One run of one cell: set-up, the measured window of frames, the
correctness check, the metrics and the result line.

The traffic is a closed loop with one client: a render session that asks
for the next frame when the last has returned. Frame i renders with a
seed derived from the run's seed and i, at the mix's samples per pixel,
through gdpt_tpu_torch.integrators.render.render on the parsed scene,
which stays loaded between frames. A frame's time runs from the call to
the image in host memory. The window runs whole frames until one ends
after `seconds`. With trace, one profiler session covers a stretch of
whole frames inside the window (profile.py).
"""

import gc
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field


from benchmark.harness import profile, spec

_M64 = (1 << 64) - 1
# Top-level module names the run may not hold once the window has closed.
FORBIDDEN = {"jax", "jaxlib", "flax", "gdpt_tpu"}


def frame_seed(seed, i):
    """A 32-bit render seed for frame i of a run (splitmix64 of both)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 1) * 0xD1B54A32D192ED03) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


@dataclass
class Frame:
    index: int
    seed: int
    spp: int
    t0: float
    t1: float
    rays: float

    @property
    def seconds(self):
        return self.t1 - self.t0


@dataclass
class Record:
    """What the metric readers read (benchmark/metrics/<name>.py)."""
    width: int
    height: int
    setup_s: float
    parse_s: float
    window_s: float = 0.0
    frames: list = field(default_factory=list)
    profile: object = None         # profile.Profile of a traced run


def cache_dirs(root):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, "build", "bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    return base


def scene_file(cell, cache, film=None):
    """The config's scene as XML + PLY in the cache, written by the frozen
    builder on first use and keyed by the description's inputs."""
    import hashlib

    from benchmark.scenes import xml_writer

    cfg = dict(cell.config)
    if film is not None:
        cfg["width"], cfg["height"] = film
    module, builder = cfg["scene"].split(".")
    scenes = cell.root / "benchmark" / "scenes"
    src = (scenes / f"{module}.py").read_bytes() + (scenes / "xml_writer.py").read_bytes()
    scene_cfg = {k: v for k, v in cfg.items() if k != "check"}
    key = hashlib.sha256(src + json.dumps(scene_cfg, sort_keys=True).encode()).hexdigest()[:16]
    directory = os.path.join(cache, "scenes", f"{cell.config_name}-{key}")
    desc = None
    path = os.path.join(directory, "scene.xml")
    if not os.path.exists(path):
        desc = describe(cfg, cell.root)
        tmp = f"{directory}.part{os.getpid()}"
        xml_writer.write_scene(tmp, desc)
        try:
            os.rename(tmp, directory)
        except OSError:  # another run wrote it first
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return path, cfg, desc


def describe(cfg, root=spec.ROOT):
    """The scene description of a config (benchmark/scenes/<module>.py,
    function <builder>, as its "scene" key names them)."""
    module, builder = cfg["scene"].split(".")
    return getattr(spec.load_module("scenes", module, root), builder)(cfg)


class Reservoir:
    """A uniform sample of k frames' outputs from a stream of unknown
    length, drawn from the run's seed."""

    def __init__(self, k, seed):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def run(cell, seed, seconds, trace, t_start, device="cuda", film=None, frame_fn=None,
        out=sys.stdout, err=sys.stderr):
    """Run the cell; print its result line to `out` and the compared
    numbers to `err`. Returns the result dict. frame_fn(ctx, spp, seed)
    replaces the program's frame (the checks' controls and faults); ctx
    holds the program's frame as ctx["program"](spp, seed), the config
    and the device."""
    import torch

    root = str(spec.ROOT)
    cache = cache_dirs(root)
    cuda = device == "cuda"
    from gdpt_tpu_torch.integrators import render as R
    from gdpt_tpu_torch.scene import parser

    xml, cfg, desc = scene_file(cell, cache, film)
    t0 = time.perf_counter()
    scene = parser.parse_scene(xml)[0]
    parse_s = time.perf_counter() - t0
    traffic = cell.traffic
    spp = int(traffic["spp_per_frame"])

    def program(k, s):
        return R.render(scene, spp=k, seed=s, device=device, return_stats=True)

    frame = frame_fn or (lambda ctx, k, s: ctx["program"](k, s))
    ctx = {"program": program, "cfg": cfg, "device": device, "root": cell.root}
    frame(ctx, spp, frame_seed(seed, -1))  # warm-up: every shape the window uses
    if cuda:
        torch.cuda.synchronize()
    rec = Record(cfg["width"], cfg["height"], time.perf_counter() - t_start, parse_s)

    checked = Reservoir(int(cfg["check"]["frames"]), frame_seed(seed, -2))
    prof_from = int(traffic["profile_after"])
    prof_to = prof_from + int(traffic["profile_frames"])
    session = profile.Session(cuda) if trace else None
    stop_s = 0.0
    w0 = time.perf_counter()
    i = 0
    while True:
        if session is not None and i == prof_from:
            session.start()
        s = frame_seed(seed, i)
        f0 = time.perf_counter()
        output, rays = frame(ctx, spp, s)
        f1 = time.perf_counter()
        rec.frames.append(Frame(i, s, spp, f0, f1, float(rays)))
        checked.offer((i, s, output))
        if session is not None and i == prof_to - 1:
            if cuda:
                torch.cuda.synchronize()
            # The profiled frames' wall runs from the first one's call to
            # the last one's image; the profiler's stop, which flushes
            # its records, lies outside it and is reported apart.
            done = rec.frames[prof_from:prof_to]
            rec.profile = profile.Profile(
                wall_s=done[-1].t1 - done[0].t0,
                samples=sum(f.spp for f in done) * rec.width * rec.height,
                rays=sum(f.rays for f in done))
            t_stop = time.perf_counter()
            session.stop()
            stop_s = time.perf_counter() - t_stop
        i += 1
        if f1 - w0 >= seconds and (session is None or i >= prof_to):
            break
    rec.window_s = rec.frames[-1].t1 - w0

    # The cards the run used: those on which it allocated memory.
    peaks = ([torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())]
             if cuda else [])
    used = [d for d, peak in enumerate(peaks) if peak > 0]
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(used[0] if used else 0) if cuda else "cpu",
                   "count": len(used) if cuda else 1,
                   "memory_peak_bytes": int(max(peaks, default=0))}
    out_dir = os.path.join(root, "build", "bench_out", f"{cell.name}-{seed}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "frames.json"), "w") as f:
        json.dump([[fr.index, fr.seed, fr.spp, fr.seconds, fr.rays] for fr in rec.frames], f)
    breakdown = None
    t_reduce = time.perf_counter()
    if session is not None:
        session.reduce(rec.profile, os.path.join(out_dir, "trace.json"))
        device_info.update(busy_s=rec.profile.busy_s, window_s=rec.profile.wall_s)
        breakdown = {"device_ops": rec.profile.top_ops, "idle_gaps": rec.profile.idle_gaps}

    # The program's state is freed before the reference runs.
    del ctx, scene, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if desc is None:
        desc = describe(cfg, cell.root)
    compared = cell.check().compare(dict(desc=desc, cfg=cfg, frames=checked.items,
                                         device=device, spp=spp))
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    print(f"benchmark: {cell.name} seed {seed}: set-up {rec.setup_s:.3f} s (parse "
          f"{parse_s:.3f} s), window {rec.window_s:.3f} s, {len(rec.frames)} frames, profiler "
          f"stop {stop_s:.3f} s, trace reduced in {t_check - t_reduce:.3f} s, reference check "
          f"{time.perf_counter() - t_check:.3f} s", file=err)

    metrics = {}
    for m, reader in cell.readers(trace):
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the port must run without JAX "
              "or the JAX package", file=err)
        raise SystemExit(3)

    result = {"correct": bool(correct), "attempted": len(rec.frames), "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result

