"""The banded render loop of the SoA renderers (path_soa, gdpt_soa,
volpath_soa): passes of whole samples over every pixel's lane, each
summed in f32 on the device, the passes in float64 on the host. Here are
the route rule (route), the pass on one device or split over a mesh
(parallel/sharding.py), the sample replayed as one captured CUDA graph
(sample_pass) and the loop over passes and bands (loop); each
integrator brings its sample, view, lane budget, bands and finish.

Program spans (utils/profiling): the lane columns and their copies to a
device render.lanes, the view render.scene, each pass render.pass, the
wait for its device work render.wait, the read-back and the overflow
check render.readback, the host's sums and image render.image. A pass
that replays a captured sample enters the stage spans (path.*, gdpt.*)
and the casts' (cast.*) only while its key's sample is warmed and
captured, in its first pass.
"""

import functools

import numpy as np
import torch

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.accel import packet_kernels
from gdpt_tpu_torch.core.dtypes import REAL
from gdpt_tpu_torch.parallel import sharding
from gdpt_tpu_torch.scene.build import Scene, SceneMemo
from gdpt_tpu_torch.utils import profiling


def route(wavefront, static, n, spp, start_sample, init_acc, on_chunk, mesh):
    """Whether a render of n pixels at spp samples takes the wavefront
    lane pool (True) or the banded loop (False). A resumed or
    checkpointed render sums whole samples, and a sharded one runs as the
    reference's always does: both take the banded loop, and
    wavefront=True raises ValueError. Otherwise wavefront=None takes the
    pool for BVH scenes whose work queue fits (n * spp < 2^32): it keeps
    the casts at about full occupancy by sample regeneration, where the
    banded loop pays full-width bounces while most lanes are dead."""
    if on_chunk is not None or init_acc is not None or start_sample:
        if wavefront:
            raise ValueError("start_sample / init_acc / on_chunk (checkpointed renders) take "
                             "the banded loop; wavefront=True cannot resume")
        wavefront = False
    if mesh is not None:
        if wavefront:
            raise ValueError("mesh= (a sharded render) takes the banded loop; "
                             "wavefront=True cannot shard")
        wavefront = False
    if wavefront is None:
        wavefront = not static.use_brute_force and n * spp < 2 ** 32
    return wavefront


@functools.lru_cache(maxsize=16)
def film_size(w, h, device):
    """(w, h) as a float32 tensor on `device`, made once: a copy from the
    host waits for the device, and a captured sample may not (its graph
    keeps the tensor it read)."""
    return torch.tensor([w, h], dtype=REAL, device=device)


def graphed(static, xs):
    """Whether a banded pass replays its sample as a CUDA graph: CUDA
    lanes, brute-force casts (K1 and K2, which read nothing back) and a
    fixed trip count (max_depth > 0). The BVH walks, the unbounded
    loop's reads of its condition and CPU lanes run eagerly."""
    return xs.is_cuda and static.use_brute_force and static.options.max_depth > 0


class _SampleGraph:
    """One sample of a banded pass captured as a CUDA graph over static
    lanes, seed and sample index, adding into static sums: add_sample
    (path_soa's _add_sample and _add_fused_sample, gdpt_soa's
    _add_gdpt_sample) adds one sample of its integrator into `rows` f32
    rows of the lanes' count and an f32 0-d ray count; `counts` is the
    integrator's counter group of graphs, and `kernels` that of the
    launches of its own kernels, if it has any (path_fused.LAUNCHES),
    which a replay counts as it counts K1's and K2's. Built on a key's
    first pass: the lanes are copied in, the sample runs once eagerly on
    a side stream (loading the kernels and the memoised constants), then
    is captured. The graph holds K1, K2 and the integrator's kernels as
    nodes.
    It keeps every tensor made before the capture that a replay reads,
    the view, the camera and the film's size among them, so no memo that
    drops one hands its memory to another tensor under the graph."""

    def __init__(self, add_sample, rows, counts, static, camera, sc, xs, ys, ray_idx,
                 kernels=None):
        dev = xs.device
        # id(camera) is in the memo's key too.
        self.held = (sc, camera, film_size(static.width, static.height, dev))
        self.counts = counts
        self.kernels = {} if kernels is None else kernels
        self.lanes = (xs.clone(), ys.clone(), ray_idx.clone())
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.sample = torch.zeros((), dtype=torch.int64, device=dev)
        self.acc = torch.zeros((rows, xs.shape[0]), dtype=REAL, device=dev)
        self.rays = torch.zeros((), dtype=REAL, device=dev)

        def body():
            add_sample(static, camera, sc, self.lanes, self.seed, self.sample, self.acc,
                       self.rays)

        # capture_begin/end, not torch.cuda.graph, which first collects
        # garbage and empties the allocator's cache to make room for a
        # large graph (about 0.13 s of a benchmark process's warm frame).
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
            with bk.capture_tally() as self.launches, \
                    bk.capture_tally(self.kernels) as self.kernel_launches:
                self.graph.capture_begin()
                body()
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        counts["captured"] += 1

    def run(self, xs, ys, ray_idx, seed, sample0, n_samples):
        for dst, src in zip(self.lanes, (xs, ys, ray_idx)):
            dst.copy_(src)
        self.seed.fill_(seed)
        self.acc.zero_()
        self.rays.zero_()
        for i in range(n_samples):
            self.sample.fill_(sample0 + i)
            self.graph.replay()
        bk.count_replays(self.launches, n_samples)
        bk.count_replays(self.kernel_launches, n_samples, self.kernels)
        self.counts["replayed"] += n_samples
        return self.acc, self.rays


# Captured samples, keyed on the view itself (as path_soa memoises
# views), the integrator's sample, the scene's facts, the camera, the
# lane count and the device; a graph and its private memory pool go when
# its entry is dropped.
_GRAPH_MEMO = SceneMemo()


def sample_pass(add_sample, rows, counts, static, camera, sc, xs, ys, ray_idx, seed, sample0,
                n_samples, kernels=None):
    """n_samples samples of an integrator summed in f32 for the whole ray
    batch, add_sample adding each into `rows` f32 rows and a ray count
    in place (_SampleGraph); returns (the (rows, n) sums, the rays as an
    f32 0-d tensor, whether the pass replayed). A graphed pass
    (graphed()) replays its key's captured sample once per sample and
    returns the graph's static sums, which the next pass of the key
    overwrites; any other pass runs the same sample eagerly into sums of
    its own. Both give the same bits. `counts`, the integrator's counter
    group, counts the samples replayed or run eagerly and the graphs
    captured; `kernels` is the counter group of the launches of the
    integrator's own kernels (_SampleGraph)."""
    if graphed(static, xs):
        key = (add_sample, static, id(camera), xs.shape[0], xs.device)
        with torch.cuda.device(xs.device):  # capture and replay on the lanes' card
            g = _GRAPH_MEMO.get(sc, key, lambda: _SampleGraph(
                add_sample, rows, counts, static, camera, sc, xs, ys, ray_idx, kernels))
            return (*g.run(xs, ys, ray_idx, seed, sample0, n_samples), True)
    acc = torch.zeros((rows, xs.shape[0]), dtype=REAL, device=xs.device)
    rays = torch.zeros((), dtype=REAL, device=xs.device)
    for i in range(n_samples):
        add_sample(static, camera, sc, (xs, ys, ray_idx), seed, sample0 + i, acc, rays)
    counts["eager"] += n_samples
    return acc, rays, False


def _device_pass(scene: Scene, cols, view, sample):
    """The loop's pass on the scene's own device, as sharding.pass_fn's
    over a mesh: pass_(lo, hi, *args) runs sample(view, *the lanes lo:hi,
    *args) and returns (its outputs as float64 host arrays, the rays).
    It waits for the device work in render.wait, so render.readback stays
    host work; the outputs (a graph's static sums, which its next pass
    overwrites) are read back before the next pass starts. The view is
    made in the first pass, after the loop has allocated its sums: the
    read-backs' speed on the card rests on the order of the loop's host
    allocations (see loop)."""
    device = scene.device.camera.sample_to_cam.device
    with profiling.span("render.lanes"):
        cols_d = [torch.as_tensor(c, device=device) for c in cols]
    views = []

    def pass_(lo, hi, *args):
        if not views:
            views.append(view(scene))
        with profiling.span("render.pass"):
            out, rays = sample(views[0], *(c[lo:hi] for c in cols_d), *args)
        with profiling.span("render.wait"):
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        with profiling.span("render.readback"):
            return [o.cpu().numpy().astype(np.float64) for o in out], float(rays)
    return pass_


def loop(scene: Scene, spp, view, sample, shape, budget, start_sample, init_acc, on_chunk,
         mesh, finish, bands=None, real_share=False):
    """Samples start_sample..spp of the n pixels of `scene`; returns
    finish(the float64 sums, of shape (*shape, n), the rays traced).
    finish runs while the loop still holds its lane columns and last
    read-backs, so that its host arrays do not take their memory: where
    they did, a 512x512 gradpath frame's read-backs took 60-77 ms on the
    card against 10-15, and the preview's frames ran 1.7x as long.

    view(scene_d) derives what a pass needs from the scene's copy on a
    device, once per device. sample(view_d, xs, ys, ray_idx, sample0,
    n_samples) sums samples of the lanes (pixel coordinates, pixel
    indices) in f32 and returns (the sums' rows, the rays). A pass takes
    budget // n samples (at least one) on a brute-force scene and one on
    a BVH scene, as the reference does, in each of the (lo, hi) pixel
    bands in turn (default one band). init_acc (sums of that shape) and
    start_sample resume a render; on_chunk(sums, done) fires after every
    pass. With a mesh, each band is padded to the first band's width and
    split over the mesh (sharding.pass_fn); its padded lanes' rays are
    counted, or with real_share scaled by its share of real lanes."""
    static = scene.static
    w, h = static.width, static.height
    n = w * h
    bands = bands or [(0, n)]
    width = bands[0][1] - bands[0][0]
    with profiling.span("render.lanes"):
        ys, xs = np.mgrid[0:h, 0:w]
        cols = (xs.ravel().astype(np.float32), ys.ravel().astype(np.float32), np.arange(n))

    def view_in_span(scene_d):
        with profiling.span("render.scene"):
            return view(scene_d)

    if mesh is None:
        one_pass = _device_pass(scene, cols, view_in_span, sample)
    else:
        one_pass = sharding.pass_fn(mesh, scene, cols, view_in_span, sample, width=width)
    # Brute-force scenes are throughput-bound: big sample batches per pass.
    batch = max(1, budget // n) if static.use_brute_force else 1
    acc = (np.zeros((*shape, n), np.float64) if init_acc is None
           else np.asarray(init_acc, np.float64).copy())
    rows = acc.reshape(-1, n)
    total_rays = 0.0
    done = int(start_sample)
    while done < spp:
        k = min(batch, spp - done)
        for lo, hi in bands:
            out, nrays = one_pass(lo, hi, done, k)
            if mesh is not None and real_share:
                nrays = nrays * (hi - lo) / sharding.padded(mesh, width)
            with profiling.span("render.readback"):
                packet_kernels.check_overflow()
            with profiling.span("render.image"):
                for row, buf in zip(rows, out):
                    row[lo:hi] += buf
            total_rays += nrays
        done += k
        if on_chunk is not None:
            on_chunk(acc, done)
    return finish(acc, total_rays)


def image(acc, spp, w, h):
    """The (h, w, 3) float32 image of (3, n) float64 sample sums over spp
    samples, non-finite pixels 0 (render.image)."""
    with profiling.span("render.image"):
        img = (acc / spp).T.reshape(h, w, 3).astype(np.float32)
        return np.where(np.isfinite(img), img, 0.0)
