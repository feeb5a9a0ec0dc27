"""The path integrator's banded sample in fused stages, for brute-force
Lambertian scenes lit by mesh area lights.

trace_paths_fused has trace_paths_soa's contract (integrators/path_soa.py):
one sample for every lane, returning (radiance V3, rays a lane), with the
same RNG streams and the same arithmetic, so the two give the same bits.
It keeps each lane's state in one (31, N) float32 block of rows (ROWS)
and runs the work between two casts as one stage:

- primary: the pixel draws, the filter's warp and the camera ray (K1's
  ray rows);
- after_hit(b): shade_hit on K1's hit; the first hit's emission, or the
  MIS of a BSDF-sampled hit, Russian roulette and the state's updates;
  then, where another bounce follows, the light sample and NEE's terms
  (K2's shadow-ray rows);
- after_shadow(b): NEE's contribution under K2's mask, the BSDF sample,
  its pdf and the bounce ray (K1's ray rows).

The casts stay K1 and K2 (traverse_soa's cast.closest and cast.shadow).
On CUDA lanes each stage is one launch of csrc/path_fused.cu (built at
first use by accel/native_build.py, bound with ctypes, on the current
stream, so a captured sample holds the launches as graph nodes); on CPU
lanes it is its plain PyTorch version below, written over vertex_soa's
and materials_soa's helpers, which the kernels repeat operation for
operation. NEE's terms are computed again after the shadow cast, and the
BSDF's eval and pdf again after the bounce cast, from the unchanged
state: the same operations on the same inputs. The ray differentials
feed only image-texture footprints, which the envelope leaves out, so
neither version carries them. LAUNCHES counts the kernels' launches as
brute_kernels.LAUNCHES counts K1's and K2's: one recorded into a
captured sample counts once per replay (banded._SampleGraph).

supports(static, device) is the envelope; path_soa._soa_pass takes
trace_paths_fused where it holds and trace_paths_soa elsewhere. Program
spans: path.primary, path.hit and path.shadow around the stages.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.accel import native_build
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import vertex_soa as vx
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.scene import filters
from gdpt_tpu_torch.scene import model as M
from gdpt_tpu_torch.utils import profiling

SOURCE = "path_fused.cu"

LAUNCHES = profiling.counter_group("path_fused.launches",
                                   {"primary": 0, "after_hit": 0, "after_shadow": 0})

# The lane state's rows (csrc/path_fused.cu's Row): the first row of each.
ROWS = {
    "pos": 0,      # 3: the vertex's position, the origin of K1's and K2's rays
    "rdir": 3,     # 3: K1's ray direction
    "tfar": 6,     # K1's tfar
    "sdir": 7,     # 3: K2's shadow-ray direction
    "stfar": 10,   # K2's tfar
    "dir": 11,     # 3: the path's direction into the vertex
    "gn": 14,      # 3: the vertex's geometric normal, flipped toward sn
    "sn": 17,      # 3: its shading normal
    "refl": 20,    # 3: its reflectance
    "tp": 23,      # 3: throughput
    "rad": 26,     # 3: radiance
    "rays": 29,    # rays traced
    "active": 30,  # 0/1
}
N_ROWS = 31


def supports(static, device) -> bool:
    """Whether a sample of this scene on lanes of `device` takes the fused
    stages: CUDA lanes, brute-force casts over triangles alone, Lambertian
    materials whose reflectance is a constant or a checkerboard (no image
    slot), mesh area lights and no envmap. Read from the scene's static
    facts only."""
    return (torch.device(device).type == "cuda" and static.use_brute_force
            and static.n_tris > 0 and not static.n_spheres
            and static.used_material_kinds == (M.MAT_LAMBERTIAN,)
            and not static.spec_image_slots[0] and not static.has_envmap
            and static.any_mesh_light and not static.any_sphere_light)


def _v3(st, row):
    return V3(st[row], st[row + 1], st[row + 2])


def _put(st, row, v: V3):
    for k, c in enumerate(v):
        st[row + k].copy_(c)


def _draws(lanes, seed, sample0, b, ctr):
    """uniform2 of the lane at bounce b's counter ctr (path_soa's uni2)."""
    return soa.uniform2(seed, lanes[2], b * vx._CTR_STRIDE + ctr, sample0)


def _lambertian(refl: V3) -> msoa.MatParamsSoA:
    """Every lane's material parameters in the envelope: a Lambertian
    lobe of reflectance refl."""
    zero = torch.zeros_like(refl.x)
    zero3 = V3(zero, zero, zero)
    kind = torch.full(zero.shape, M.MAT_LAMBERTIAN, dtype=INT, device=zero.device)
    return msoa.MatParamsSoA(kind, zero, refl, zero3, zero3, *([zero] * 11))


def _state_vertex(st):
    """The state's vertex as nee_light and the lobe read it."""
    return SimpleNamespace(position=_v3(st, ROWS["pos"]), gn=_v3(st, ROWS["gn"]),
                           frame=soa.coordinate_system(_v3(st, ROWS["sn"])))


def _nee_terms(static, sc, st, lanes, seed, sample0, b):
    """NEE's light sample and terms at the state's vertex for bounce b."""
    lu0, lu1 = _draws(lanes, seed, sample0, b, vx._CTR_LIGHT_UV)
    lw, lsw = _draws(lanes, seed, sample0, b, vx._CTR_LIGHT_W)
    return vx.nee_light(static, sc, _state_vertex(st), _lambertian(_v3(st, ROWS["refl"])),
                        -_v3(st, ROWS["dir"]), static.used_material_kinds, lu0, lu1, lw, lsw,
                        st[ROWS["active"]] > 0)


# ---------------------------------------------------------------------------
# The plain stages (CPU lanes; the kernels' reference)
# ---------------------------------------------------------------------------


def primary_plain(static, camera, sc, st, lanes, seed, sample0):
    """The camera ray of every lane into K1's ray rows."""
    xs, ys, _ = lanes
    u0, u1 = _draws(lanes, seed, sample0, 0, vx._CTR_PIXEL)
    org, d = vx.primary_rays_soa(static, camera, xs, ys, u0, u1)
    _put(st, ROWS["pos"], org)
    _put(st, ROWS["rdir"], d)
    st[ROWS["tfar"]].fill_(BIG)


def after_hit_plain(static, camera, sc, st, lanes, seed, sample0, hit, gn_raw, b, more, rr):
    """The vertex of K1's hit for bounce b (0: the camera ray) into the
    state, with its emission or the MIS of a BSDF-sampled hit, Russian
    roulette (rr) and, where bounce b + 1 follows (more), its shadow ray."""
    r = ROWS
    used = static.used_material_kinds
    org, d_out = _v3(st, r["pos"]), _v3(st, r["rdir"])
    nxt = vx.shade_hit(static, sc, org, d_out, hit, gn_raw)
    refl = msoa.gather_params_soa(sc.mat_tables, used, nxt.material_id, nxt.uv_u, nxt.uv_v,
                                  static.spec_image_slots,
                                  float_tex_slots=static.float_tex_slots, fp=nxt.fp).refl
    nxt_ok = nxt.valid > 0
    zero = torch.zeros_like(hit.t)
    zero3 = V3(zero, zero, zero)
    if b == 0:
        _put(st, r["rad"], soa.where(nxt_ok, vx.emission(sc, nxt, -d_out), zero3))
        st[r["tp"]:r["tp"] + 3].fill_(1.0)
        st[r["rays"]].fill_(1.0)
        active = nxt_ok
        keep = torch.ones_like(nxt_ok)
    else:
        # The BSDF sample's eval and pdf, as after_shadow computed them.
        v = _state_vertex(st)
        d = _v3(st, r["dir"])
        params = _lambertian(_v3(st, r["refl"]))
        f_b = msoa.eval_bsdf_soa(params, -d, d_out, v.gn, v.frame, used)
        pdf_b = msoa.pdf_bsdf_soa(params, -d, d_out, v.gn, v.frame, used)
        active = st[r["active"]] > 0
        throughput = _v3(st, r["tp"])
        # Emissive hit with MIS (trace_paths_soa's path.mis).
        dist2 = soa.length_squared(nxt.position - org)
        g2 = torch.where(nxt_ok,
                         torch.abs(soa.dot(d_out, nxt.gn)) / torch.clamp_min(dist2, 1e-20), 1.0)
        p2a = pdf_b * g2
        hit_light = nxt_ok & (nxt.light_id >= 0) & active
        l_emit = vx.emission(sc, nxt, -1.0 * d_out)
        p1h = vx.hit_light_pdf_soa(static, sc, org, nxt, d_out, dist2)
        w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
        scale = g2 * w2 / torch.clamp_min(p2a, 1e-30)
        contrib = throughput * f_b * l_emit * scale
        _put(st, r["rad"], _v3(st, r["rad"]) + soa.where(hit_light, contrib, zero3))
        # Russian roulette and the updates (path.update); the eta scale of a
        # Lambertian path stays 1, and x / 1 is x.
        active = active & nxt_ok
        new_tp = throughput * f_b * (g2 / torch.clamp_min(p2a, 1e-30))
        rr_prob = zero + 1.0
        if rr:
            u_rr = _draws(lanes, seed, sample0, b, vx._CTR_BSDF_W)[1]
            rr_prob = torch.clamp_max(soa.vmax(new_tp), 0.95)
            active = active & (u_rr <= rr_prob)
        new_tp = new_tp * (1.0 / torch.clamp_min(rr_prob, 1e-20))
        _put(st, r["tp"], soa.where(active, new_tp, throughput))
        keep = active
    for row, new in (("pos", nxt.position), ("gn", nxt.gn), ("sn", nxt.frame.n),
                     ("refl", refl), ("dir", d_out)):
        _put(st, r[row], soa.where(keep, new, _v3(st, r[row])))
    st[r["active"]] = active.to(REAL)
    if more:
        t = _nee_terms(static, sc, st, lanes, seed, sample0, b + 1)
        _put(st, r["sdir"], t.dl)
        st[r["stfar"]] = t.tfar


def after_shadow_plain(static, camera, sc, st, lanes, seed, sample0, blocked, b):
    """NEE's contribution at bounce b under K2's mask `blocked`, then the
    BSDF sample and the bounce ray into K1's ray rows."""
    r = ROWS
    used = static.used_material_kinds
    nee, shadow_mask = vx.nee_finish(_nee_terms(static, sc, st, lanes, seed, sample0, b),
                                     1.0 - blocked)
    _put(st, r["rad"], _v3(st, r["rad"]) + _v3(st, r["tp"]) * nee)
    rays = st[r["rays"]] + shadow_mask
    bu0, bu1 = _draws(lanes, seed, sample0, b, vx._CTR_BSDF_UV)
    w_lobe, _ = _draws(lanes, seed, sample0, b, vx._CTR_BSDF_W)
    v = _state_vertex(st)
    dir_view = -_v3(st, r["dir"])
    params = _lambertian(_v3(st, r["refl"]))
    samp = msoa.sample_bsdf_soa(params, dir_view, v.gn, v.frame, bu0, bu1, w_lobe, used)
    pdf_b = msoa.pdf_bsdf_soa(params, dir_view, samp.dir_out, v.gn, v.frame, used)
    active = (st[r["active"]] > 0) & (samp.valid > 0) & (pdf_b > 0)
    st[r["rays"]] = rays + active.to(REAL)
    st[r["active"]] = active.to(REAL)
    _put(st, r["rdir"], samp.dir_out)
    st[r["tfar"]] = torch.where(active, BIG, -1.0)


# ---------------------------------------------------------------------------
# The kernels (CUDA lanes)
# ---------------------------------------------------------------------------

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = native_build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        common = [p, p, p, p, i, p, p, p]  # tables, ints, floats, state, n, ray_idx, seed, sample
        lib.gdpt_path_primary.argtypes = common + [p, p, p]
        lib.gdpt_path_after_hit.argtypes = common + [p] * 7 + [i, i, i, p]
        lib.gdpt_path_after_shadow.argtypes = common + [p, i, p]
        for fn in (lib.gdpt_path_primary, lib.gdpt_path_after_hit, lib.gdpt_path_after_shadow):
            fn.restype = i
        _lib = lib
    return _lib


def _tables(static, camera, sc):
    """The scene's tables in the order of path_fused.cu's unpack, with the
    dtype each must have."""
    f, i, b = REAL, INT, torch.bool
    mt = sc.mat_tables
    return [
        (sc.geom.tri_soup, f), *((c, f) for c in (*sc.tri_n0, *sc.tri_n1, *sc.tri_n2)),
        *((c, f) for c in (sc.tri_uv0_u, sc.tri_uv0_v, sc.tri_uv1_u, sc.tri_uv1_v,
                           sc.tri_uv2_u, sc.tri_uv2_v)),
        (sc.tri_has_normals, b), (sc.tri_has_uvs, b), (sc.tri_material_id, i),
        (sc.tri_light_id, i), (mt.spec_kind[0], i),
        *((c, f) for c in (*mt.spec_c0[0], *mt.spec_c1[0], *mt.spec_uv[0])),
        (sc.light_cdf, f), (sc.light_pmf, f), (sc.light_shape_id, i),
        *((c, f) for c in sc.light_intensity), (sc.light_tri_cdf, f), (sc.light_tri_first, i),
        (sc.shape_kind, i), (sc.shape_area, f), (camera.sample_to_cam, f),
        (camera.cam_to_world, f),
    ]


def _filter_constant(static):
    """The filter's constant as its plain warp applies it (scene/filters.py):
    half the width for box and tent, the standard deviation for the
    Gaussian, rounded once to float32."""
    if static.filter_kind in (filters.FILTER_BOX, filters.FILTER_TENT):
        return np.float32(static.filter_param / 2.0)
    if static.filter_kind == filters.FILTER_GAUSSIAN:
        return np.float32(static.filter_param)
    raise ValueError(f"unknown filter kind {static.filter_kind}")


def _u32_tensor(x, device):
    """A seed or sample index as the 0-d int64 tensor the kernels read."""
    if isinstance(x, torch.Tensor):
        if x.dim() or x.device != device:
            raise ValueError("a tensor seed or sample index is 0-d on the lanes' device")
        return x.to(torch.int64)
    return torch.full((), int(x) & 0xFFFFFFFF, dtype=torch.int64, device=device)


class _Launch:
    """The arguments every stage launch of one sample shares: the scene's
    tables as pointers, its counts and constants, the state, the lanes
    and the seed and sample index as device tensors."""

    def __init__(self, static, camera, sc, st, lanes, seed, sample0):
        dev = st.device
        tables = _tables(static, camera, sc)
        for t, dtype in tables:
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"path_fused takes contiguous {dtype} tables on {dev}, "
                                 f"got {t.dtype} on {t.device}")
        xs, ys, ray_idx = lanes
        n = xs.shape[0]
        if n >= 2 ** 31:
            raise ValueError("path_fused takes fewer than 2^31 lanes")
        for a, dtype in ((xs, REAL), (ys, REAL), (ray_idx, torch.int64)):
            if a.dtype != dtype or a.shape != (n,) or a.device != dev or not a.is_contiguous():
                raise ValueError("path_fused takes contiguous (N,) float32 xs, ys and int64 "
                                 "ray_idx on one device")
        self.lib = _load()
        self.ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t, _ in tables))
        self.ints = (ctypes.c_int * 9)(
            static.n_tris, sc.mat_tables.spec_kind[0].shape[0], sc.light_pmf.shape[0],
            sc.light_tri_cdf.shape[1], sc.shape_kind.shape[0], static.filter_kind,
            int(static.any_mesh_normals), int(static.any_mesh_uvs), int(soa.threefry()))
        self.floats = (ctypes.c_float * 4)(
            static.width, static.height, _filter_constant(static),
            np.float32(1.0 - static.shadow_epsilon))
        self.seed, self.sample = _u32_tensor(seed, dev), _u32_tensor(sample0, dev)
        self.st, self.n, self.dev, self.lanes = st, n, dev, lanes

    def __call__(self, kind, fn, *args):
        with torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            err = fn(self.ptrs, self.ints, self.floats, self.st.data_ptr(), self.n,
                     self.lanes[2].data_ptr(), self.seed.data_ptr(), self.sample.data_ptr(),
                     *args, ctypes.c_void_p(stream))
        bk.count_launch(kind, LAUNCHES)
        if err != 0:
            raise RuntimeError(f"path_{kind} launch failed: CUDA error {err}")


def primary_kernel(launch: _Launch):
    xs, ys, _ = launch.lanes
    launch("primary", launch.lib.gdpt_path_primary, xs.data_ptr(), ys.data_ptr())


def after_hit_kernel(launch: _Launch, hit, gn_raw, b, more, rr):
    if hit.prim_id.dtype != INT:
        raise ValueError("path_fused takes K1's int32 primitive ids")
    launch("after_hit", launch.lib.gdpt_path_after_hit,
           *(a.data_ptr() for a in (hit.t, hit.prim_id, hit.u, hit.v, *gn_raw)),
           int(b), int(more), int(rr))


def after_shadow_kernel(launch: _Launch, blocked, b):
    launch("after_shadow", launch.lib.gdpt_path_after_shadow, blocked.data_ptr(), int(b))


# ---------------------------------------------------------------------------
# The sample
# ---------------------------------------------------------------------------


# The stages, by the index schedule() gives: their names, plain versions,
# kernels and the program span each runs in.
STAGES = ("primary", "after_hit", "after_shadow")
PLAIN = (primary_plain, after_hit_plain, after_shadow_plain)
KERNELS = (primary_kernel, after_hit_kernel, after_shadow_kernel)
SPANS = ("path.primary", "path.hit", "path.shadow")


def schedule(static, sc, st):
    """The stages of one sample on the lane state st, in order, as (name,
    stage index, the stage's own arguments), with K1's and K2's casts
    between them. The caller runs each stage before the schedule goes
    on: a cast reads the rays the stage before it wrote. max_depth > 0
    runs a fixed trip count; otherwise trace_paths_soa's while loop,
    which stops once every lane is retired (a read of the state)."""
    r = ROWS
    max_depth = static.options.max_depth
    n_iters = vx.HARD_BOUNCE_CAP if max_depth < 0 else max(max_depth - 1, 0)

    def cast(tnear):
        return trs.intersect_soa_gn(static, sc.geom, _v3(st, r["pos"]), _v3(st, r["rdir"]),
                                    tnear, st[r["tfar"]])

    yield "primary", 0, ()
    yield "after_hit 0", 1, (*cast(0.0), 0, n_iters > 0, False)
    bounce = 0
    while bounce < n_iters and (max_depth > 0 or bool((st[r["active"]] > 0).any())):
        b = bounce + 1
        blocked = trs.occluded_soa(static, sc.geom, _v3(st, r["pos"]), _v3(st, r["sdir"]),
                                   static.shadow_epsilon, st[r["stfar"]])
        yield f"after_shadow {b}", 2, (blocked, b)
        yield f"after_hit {b}", 1, (*cast(static.intersection_epsilon), b, b < n_iters,
                                    bounce + 2 >= static.options.rr_depth)
        bounce += 1


def trace_paths_fused(static, camera, sc, xs, ys, ray_idx, seed, sample0):
    """One sample for every lane; returns (radiance V3, rays a lane), the
    bits of path_soa.trace_paths_soa. seed and sample0 are uint32 values,
    as Python ints or as 0-d int64 tensors on the lanes' device. CUDA
    lanes launch the kernels (or raise), CPU lanes run the plain stages."""
    dev = xs.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"path_fused runs on cuda or cpu lanes, not {dev}")
    lanes = (xs, ys, ray_idx)
    st = torch.empty((N_ROWS, xs.shape[0]), dtype=REAL, device=dev)
    if dev.type == "cuda":
        args, stages = (_Launch(static, camera, sc, st, lanes, seed, sample0),), KERNELS
    else:
        args, stages = (static, camera, sc, st, lanes, seed, sample0), PLAIN
    for _, k, stage_args in schedule(static, sc, st):
        with profiling.span(SPANS[k]):
            stages[k](*args, *stage_args)
    return _v3(st, ROWS["rad"]), st[ROWS["rays"]]
