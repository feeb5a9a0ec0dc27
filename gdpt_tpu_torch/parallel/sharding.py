"""Data parallelism over devices: the rays of a render split over a mesh.

Counterpart of gdpt_tpu/parallel/sharding.py. As there, the scene is
replicated (each device holds its own copy: scene.build.scene_to,
memoised) and the flat ray batch of each pass is cut into contiguous
shards, one per entry of the mesh's one axis, "rays". There is no
communication inside the bounce loop: each shard's sums are read back
to the host in shard order and joined there, where the reference's only
collective is the gather of the sharded framebuffer.

The shards run one after another in the calling thread. The port's
loops read their loop conditions on the host and launch from Python, so
threads, which run Python one at a time, would overlap little more than
those reads; a process per card is the way to run cards at once, and
waits for the compiled wavefront iteration (ROADMAP.md A.2).

A mesh may name one device more than once: the card's machine has one
H100 and torch one CPU device, so a mesh like [cpu] * 8 or [cuda:0] * 4
is how the split, its padding and the gather are exercised on either.

pass_fn splits a pass over a mesh: integrators/banded.py's loop calls it
for a sharded render, as render_samples_sharded does here.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.core.dtypes import REAL
from gdpt_tpu_torch.ops import intersect as isect
from gdpt_tpu_torch.scene.build import Scene, scene_to
from gdpt_tpu_torch.utils import profiling

# Rays are padded to a multiple of this many lanes per device, as the
# reference pads them (its TPU vector width).
LANE_ALIGN = 128


class Mesh(NamedTuple):
    """An ordered tuple of torch.devices on the one axis "rays"."""

    devices: tuple


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices`, by default every CUDA device. Without a
    CUDA device the default raises RuntimeError: CPU devices are used
    only when the caller names them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8) to shard over others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(tuple(out))


def ray_pad(mesh: Mesh, n, align=LANE_ALIGN):
    """Lanes added to n rays so that every shard has the same whole
    number of `align`-lane groups (the padded lanes trace pixel 0 with
    ray index 0; callers drop their results)."""
    return (-n) % (len(mesh.devices) * align)


def padded(mesh: Mesh, n, align=LANE_ALIGN):
    """n lanes with their ray_pad."""
    return n + ray_pad(mesh, n, align)


def scene_on(scene: Scene, device) -> Scene:
    """`scene` on `device`: itself where it lives there already (so the
    tables memoised for it are reused), else its memoised copy."""
    here = scene.device.camera.sample_to_cam.device
    return scene if here == torch.device(device) else scene_to(scene, device)


def pass_fn(mesh, scene: Scene, cols, view, run, width=None, align=LANE_ALIGN):
    """The pass of a render loop over `mesh`.

    cols: equal-length host arrays, one entry per lane of the render
    (pixel coordinates, ray indices), each of the dtype the pass takes.
    view(scene_d) derives what a pass needs from the scene's copy on a
    device (its SoA view, say), once per device. run(view_d, *cols_d,
    *args) casts the lanes cols_d on that device and returns (outputs,
    rays): (m,)-leading tensors and the ray count. Returns pass_(lo, hi,
    *args), the pass of lanes lo:hi, as (each output as a float64 host
    array of hi - lo rows, the ray count). A run's outputs may be
    buffers that its next run overwrites: each is read back to the host
    before the next run starts.

    The lanes lo:hi, padded with zeros to `width` lanes
    (default hi - lo) and then to whole `align`-lane groups per device
    (ray_pad), are cut into contiguous shards, each run on its device,
    one after another, and joined in shard order on the host. The padded
    lanes' outputs are dropped and the rays they traced counted, as the
    reference counts them.

    Program spans (utils/profiling): the lanes' copies to a device are
    render.lanes, each run render.pass, the wait for the work it queued
    on its device render.wait, its outputs' read-back render.readback
    (host work alone)."""
    views = {}

    def view_on(device):
        if device not in views:
            views[device] = view(scene_on(scene, device))
        return views[device]

    def pass_(lo, hi, *args):
        m = hi - lo
        n = padded(mesh, max(width or m, m), align)
        per = n // len(mesh.devices)
        with profiling.span("render.lanes"):
            lanes = [np.pad(c[lo:hi], (0, n - m)) for c in cols]
        outs, rays = [], 0.0
        for i, device in enumerate(mesh.devices):
            v = view_on(device)
            with profiling.span("render.lanes"):
                part = [torch.as_tensor(a[i * per:(i + 1) * per], device=device)
                        for a in lanes]
            with profiling.span("render.pass"):
                got, nr = run(v, *part, *args)
            with profiling.span("render.wait"):
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
            with profiling.span("render.readback"):
                outs.append([o.cpu().numpy().astype(np.float64) for o in got])
                rays += float(nr)
        return [np.concatenate(parts)[:m] for parts in zip(*outs)], rays
    return pass_


def render_samples_sharded(scene: Scene, trace_fn, mesh: Mesh, spp=None, seed=0,
                           sample_shards=1, return_stats=False, packet_wide=32,
                           packet_dual=False, **cast):
    """Distributed Monte Carlo render of a per-ray integrator (trace_fn
    as render.render_samples takes it). The pixels, padded to a multiple
    of the mesh's size (as the reference pads them), are sharded over its
    axis; a pass takes spp // sample_shards samples of every pixel, summed in f32 in sample order
    (at most render.MAX_RAYS_PER_PASS lanes a launch per shard), the
    passes in float64 on the host. Returns the (h, w, 3) float32 image
    (non-finite pixels 0), with return_stats also the live rays cast,
    padded lanes included. packet_wide, packet_dual and **cast pick a
    BVH scene's table and walk (path_soa.scene_soa_from_aos)."""
    from gdpt_tpu_torch.integrators import path_soa, render

    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n_pix = w * h
    casts = []

    def view(scene_d):
        casts.append(isect.Casts(path_soa.scene_soa_from_aos(
            scene_d, packet_wide, packet_dual, **cast).geom))
        return scene_d, casts[-1]

    def run(v, pix_d, sample0, n_samples):
        scene_d, casts_d = v
        xs, ys = (pix_d % w).to(REAL), (pix_d // w).to(REAL)
        step = max(1, render.MAX_RAYS_PER_PASS // pix_d.shape[0])
        acc = None
        for s in range(0, n_samples, step):
            acc = render._render_pass(scene_d, trace_fn, casts_d, xs, ys, pix_d, sample0 + s,
                                      min(step, n_samples - s), spp, seed, acc=acc)
        return (acc,), 0.0

    # The pixels are padded to a whole number per device only, as the
    # reference pads them here.
    one_pass = pass_fn(mesh, scene, (np.arange(n_pix),), view, run, align=1)
    acc = np.zeros((n_pix, 3), np.float64)
    chunk = max(1, spp // max(sample_shards, 1))
    done = 0
    while done < spp:
        k = min(chunk, spp - done)
        acc += one_pass(0, n_pix, done, k)[0][0]
        done += k
    img = (acc / spp).reshape(h, w, 3)
    img = np.where(np.isfinite(img), img, 0.0).astype(np.float32)
    if return_stats:
        return img, float(sum(float(c.rays) for c in casts))
    return img


# The reference's sharded SoA renders, kept as aliases of the renderers'
# mesh= (the one route; integrators are imported here lazily, as the
# reference does, since they import this module).


def render_soa_sharded(scene: Scene, mesh: Mesh, spp=None, seed=0, **kw):
    """path_soa.render_soa(mesh=mesh)."""
    from gdpt_tpu_torch.integrators import path_soa

    return path_soa.render_soa(scene, spp=spp, seed=seed, mesh=mesh, **kw)


def render_gradpath_soa_sharded(scene: Scene, mesh: Mesh, spp=None, seed=0, **kw):
    """gdpt_soa.render_gradpath_soa(mesh=mesh)."""
    from gdpt_tpu_torch.integrators import gdpt_soa

    return gdpt_soa.render_gradpath_soa(scene, spp=spp, seed=seed, mesh=mesh, **kw)


def render_volpath_soa_sharded(scene: Scene, mesh: Mesh, spp=None, seed=0, **kw):
    """volpath_soa.render_volpath_soa(mesh=mesh)."""
    from gdpt_tpu_torch.integrators import volpath_soa

    return volpath_soa.render_volpath_soa(scene, spp=spp, seed=seed, mesh=mesh, **kw)
