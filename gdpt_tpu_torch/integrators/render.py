"""Render entry point: integrator dispatch (reference: src/render.cpp:374-394).

Counterpart of gdpt_tpu/integrators/render.py. The scene (built on the
host) is carried to `device` — the CUDA card unless the caller passes
device="cpu" — and rendered there. Ported integrators: "path",
"gradpath" (gradient-domain path tracing with the screened-Poisson
reconstruction), "volpath" and the AOV kinds (integrators/aux.py: one
primary cast per pixel), over every material kind, texture slot and
light type of the SoA stack (ops/materials_soa.py, ops/textures_soa.py).
The dispatch is the reference's: "path" and "gradpath" take the SoA
renderers while path_soa.supports_soa / gdpt_soa.supports_soa_gdpt hold
(always, as in the reference), else the per-ray oracles
(integrators/path.py through render_samples, integrators/gdpt.py's
render_gradpath); volpath versions 6 and 0 render through
integrators/volpath_soa.py, versions 1-5 through the per-ray rungs of
integrators/volpath.py, driven by render_samples.
Brute-force scenes go through the banded loops, BVH
scenes (above 128 primitives) through the packet table and the wavefront
renderers; packet_wide and packet_dual choose the table's width and the
walk: the solo kernel K3, or on a 16-wide table the dual kernel K4. The
reference's other GDPT_* ray-casting switches are arguments here too:
two_phase (the two-phase entry traversal), packet_sort (each cast's ray
sort), premerge and entry_k (the table's build), pool_sort (the
wavefront pools' morton sort), and packet and max_table_mb, which take
the reference's XLA walks in plain PyTorch instead of the table
(packet=False: the packed or the per-lane BVH walk; max_table_mb: the
super16 walk when the table is over that many MiB). The reference reads
its switches from the environment, and only on its packet route; here
each is an argument of every renderer. Sharded renders over a mesh of devices
are parallel/sharding.py's.
"""

import numpy as np
import torch

from gdpt_tpu_torch.accel.packet_trace import ENTRY_K
from gdpt_tpu_torch.core import rng
from gdpt_tpu_torch.core.dtypes import REAL, resolve_device
from gdpt_tpu_torch.integrators import aux
from gdpt_tpu_torch.scene.build import Scene, scene_to
from gdpt_tpu_torch.utils import profiling

# Target rays in flight per pass of render_samples (the reference's).
MAX_RAYS_PER_PASS = 1 << 20


def _render_pass(scene: Scene, trace, casts, xs, ys, pix_idx, sample0, n_samples, spp,
                 seed, acc=None):
    """n_samples samples of every pixel as one batch of lanes (sample
    major), each lane's key folded from PRNGKey(seed) by
    pix_idx * spp + sample, as gdpt_tpu/integrators/render.py:_render_pass
    keys its fori_loop's samples; the samples are summed in f32 in sample
    order onto `acc` (zeros if None), as that loop sums them."""
    n_pix = xs.shape[0]
    sample = sample0 + torch.arange(n_samples, dtype=torch.int64, device=xs.device)
    ray_idx = (pix_idx[None, :] * spp + sample[:, None]).reshape(-1)
    key = rng.ray_key(rng.prng_key(seed, ray_idx.shape[0], xs.device), ray_idx)
    out = trace(scene.device, scene.static, casts, xs.repeat(n_samples),
                ys.repeat(n_samples), key).reshape(n_samples, n_pix, 3)
    if acc is None:
        acc = torch.zeros((n_pix, 3), dtype=REAL, device=xs.device)
    for s in range(n_samples):
        acc = acc + out[s]
    return acc


def render_samples(scene: Scene, trace_fn, spp=None, seed=0, start_sample=0, init_acc=None,
                   on_chunk=None, return_stats=False, packet_wide=32, packet_dual=False,
                   **cast):
    """Monte Carlo accumulation of a per-ray integrator over the scene on
    its device; returns an (h, w, 3) float32 numpy image (non-finite
    pixels 0), with return_stats also the live rays cast.

    trace_fn(scene.device, static, casts, xs, ys, key) returns each
    lane's radiance (N, 3). A pass traces up to MAX_RAYS_PER_PASS rays
    (whole samples of every pixel) at once; its samples are summed in f32
    on the device and the passes accumulated in float64 on the host.
    start_sample/init_acc resume an interrupted accumulation (init_acc is
    the raw (n_pix, 3) float64 sample-sum array); on_chunk(acc, done)
    fires after every pass. packet_wide, packet_dual and **cast
    (two_phase, packet_sort, premerge, entry_k, packet, max_table_mb)
    pick a BVH scene's table and walk (path_soa.scene_soa_from_aos)."""
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.ops import intersect as isect

    static = scene.static
    w, h = static.width, static.height
    spp = spp if spp is not None else static.options.samples_per_pixel
    n_pix = w * h
    device = scene.device.camera.sample_to_cam.device
    casts = isect.Casts(path_soa.scene_soa_from_aos(scene, packet_wide, packet_dual, **cast).geom)
    pix_idx = torch.arange(n_pix, dtype=torch.int64, device=device)
    xs = (pix_idx % w).to(REAL)
    ys = (pix_idx // w).to(REAL)

    batch = max(1, min(spp, MAX_RAYS_PER_PASS // n_pix))
    acc = (np.zeros((n_pix, 3), np.float64) if init_acc is None
           else np.asarray(init_acc, np.float64).copy())
    done = int(start_sample)
    while done < spp:
        n = min(batch, spp - done)
        out = _render_pass(scene, trace_fn, casts, xs, ys, pix_idx, done, n, spp, seed)
        acc += out.cpu().numpy().astype(np.float64)
        done += n
        if on_chunk is not None:
            on_chunk(acc, done)
    img = (acc / spp).reshape(h, w, 3)
    # NaN filtering as in the reference's volumetric render loop
    # (reference: src/render.cpp:156-159).
    img = np.where(np.isfinite(img), img, 0.0).astype(np.float32)
    if return_stats:
        return img, float(casts.rays)
    return img


@profiling.span(profiling.FRAME)
def render(scene: Scene, spp=None, seed=0, device=None, return_stats=False,
           packet_wide=32, packet_dual=False, two_phase=False, packet_sort=True,
           premerge=False, entry_k=ENTRY_K, pool_sort=False, return_aux=False, packet=True,
           max_table_mb=None, wavefront=True):
    """Render `scene` on `device`; returns an (h, w, 3) float32 numpy
    image (for "gradpath" the reconstruction), with return_aux ("gradpath"
    only) also the dict of its primal, primal_bf, gx and gy images, and
    with return_stats also the number of rays traced.

    The ray-casting switches of a BVH scene, each the argument for one of
    the reference's GDPT_* environment variables and off by default as
    there: packet_wide (16 or 32) and packet_dual (K4 on a 16-wide table;
    with width 32 it raises ValueError), two_phase (casts of 4,096 rays or
    more take the two-phase entry traversal), packet_sort=False (no cast
    sorts its rays), premerge and entry_k (the packet table's build),
    pool_sort (the SoA wavefronts keep their lane pools morton-sorted),
    packet=False (GDPT_PACKET=0: no table; the casts take the packed walk,
    or the per-lane walk where the BVH holds spheres) and max_table_mb
    (GDPT_MAX_TABLE_MB: a table over that many MiB is not built and the
    casts walk super16; None, the default, is no cap). The reference
    reads GDPT_PACKET_WIDE, GDPT_PACKET_DUAL, GDPT_TWO_PHASE and the table
    switches only on its packet route; packet_dual, two_phase, pool_sort
    or packet_sort=False on a BVH scene left without a table raise
    ValueError. wavefront is GDPT_WAVEFRONT: True, the default, lets the
    SoA renderers take the wavefront lane pool for BVH scenes whose work
    queue fits and the banded loop otherwise; False takes the banded loop
    for every scene. An integrator the reference does not know raises
    its ValueError. The call is the program span render.frame, its scene
    copy render.scene (utils/profiling)."""
    device = resolve_device(device)
    integrator = scene.static.options.integrator

    def on_device():
        with profiling.span("render.scene"):
            return scene_to(scene, device)

    wavefront = None if wavefront else False
    walk = dict(packet_wide=packet_wide, packet_dual=packet_dual, two_phase=two_phase,
                packet_sort=packet_sort, premerge=premerge, entry_k=entry_k, packet=packet,
                max_table_mb=max_table_mb)
    if return_aux and integrator != "gradpath":
        raise ValueError(f"return_aux: integrator {integrator!r} has no auxiliary buffers")
    if integrator in aux.AUX_KINDS:
        img = aux.render_aux(on_device(), integrator, **walk)
        return (img, float(scene.static.width * scene.static.height)) if return_stats else img
    if integrator == "path":
        from gdpt_tpu_torch.integrators import path_soa

        if not path_soa.supports_soa(scene):
            from gdpt_tpu_torch.integrators import path

            return render_samples(on_device(), path.trace_path, spp=spp,
                                  seed=seed, return_stats=return_stats, **walk)
        return path_soa.render_soa(on_device(), spp=spp, seed=seed,
                                   return_stats=return_stats, pool_sort=pool_sort,
                                   wavefront=wavefront, **walk)
    if integrator == "gradpath":
        from gdpt_tpu_torch.integrators import gdpt_soa

        if not gdpt_soa.supports_soa_gdpt(scene):
            from gdpt_tpu_torch.integrators import gdpt

            return gdpt.render_gradpath(scene, spp=spp, seed=seed, return_aux=return_aux,
                                        device=device, return_stats=return_stats, **walk)
        return gdpt_soa.render_gradpath_soa(on_device(), spp=spp, seed=seed,
                                            return_aux=return_aux, return_stats=return_stats,
                                            pool_sort=pool_sort, wavefront=wavefront, **walk)
    if integrator == "volpath":
        from gdpt_tpu_torch.integrators import volpath_soa

        if not volpath_soa.supports_soa_volpath(scene):
            from gdpt_tpu_torch.integrators import volpath

            return render_samples(on_device(), volpath.trace_fn(scene.static),
                                  spp=spp, seed=seed, return_stats=return_stats, **walk)
        return volpath_soa.render_volpath_soa(on_device(), spp=spp, seed=seed,
                                              return_stats=return_stats, pool_sort=pool_sort,
                                              wavefront=wavefront, **walk)
    raise ValueError(f"unknown integrator: {integrator}")
