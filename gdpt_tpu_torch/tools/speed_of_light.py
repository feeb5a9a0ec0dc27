"""Per-config ray-casting speed of light on the card -> SOL_cuda.json.

Counterpart of tools/speed_of_light.py. Defines the utilization model that
gdpt_tpu_torch/bench.py reports as `mfu_est`:

  sol_kernel_pool_mrays: packet configs: the cast on captured steady-state
      wavefront pool rays (mixed bounce depths, per-lane tnear), the
      population the render's extension cast dispatches;
      sol_kernel_shadow_pool_mrays the NEE shadow rays built from them, and
      sol_mix_ceiling_mrays the two classes' harmonic mix by live rays, the
      bench's ceiling for packet configs;
  sol_kernel_inc_mrays / _coh_mrays: the scene's own cast (K1 brute force or
      the packet walk K3, with its sort and hit attributes) on 2^20
      incoherent bbox-random rays / coherent camera rays;
  sol_kernel_bounce_mrays / _shadow_mrays: on harvested bounce-1 scatter
      rays (closest hit) and NEE shadow rays (any hit, K2 or K3);
  sol_flop_floor_mrays: brute-force configs: the card's measured f32 FMA
      peak (tools/fma_peak.py, fma_peak_gflops) over the intersection
      flops of a ray (flops_per_ray).

Each timing is SOL_CHAIN_K = 8 casts captured as one CUDA graph, replayed
three times and timed by CUDA events, the least kept: no host launch sits
between the casts. (The reference chains its casts inside one jitted loop
with a carry-dependent perturbation of the origins, so that XLA does not
hoist the cast out of the loop; no compiler hoists a kernel out of a graph,
so the casts here are the same cast eight times.)

Visit floors (the `visits` mode, packet configs), a model that differs from
the reference's: the reference prices the union visits of the TPU's
1,024-lane packets at the TPU's measured 0.36 us a visit. The port's walk
K3 runs a lane group per ray, so here a ray's own super and leaf visits are
counted by K3's counting instance (packet_trace_kernel<W, ANY, true>) on
the same incoherent and bounce rays, and priced at the ns per visit per ray
that the visit microbenchmark K5 measures in the same process for the
table's own visits (super32 and leaf24 on the 32-wide table, super and leaf
on the 16-wide): visits_per_ray_*, visit_floor_*_mrays =
1e3 / (super visits x ns_super + leaf visits x ns_leaf), and
kernel_floor_frac = sol_kernel_bounce_mrays (else _inc) over its floor.

Every row carries the card's name and power limit (nvidia-smi). Usage, on
the card:

  python -m gdpt_tpu_torch.tools.speed_of_light kernel [--only=a,b] [--scenes DIR]
  python -m gdpt_tpu_torch.tools.speed_of_light visits [--only=a,b] [--scenes DIR]

Both merge their rows into gdpt_tpu_torch/SOL_cuda.json. Configs whose
scene file is missing are reported and skipped.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gdpt_tpu_torch import bench
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, REAL
from gdpt_tpu_torch.core.soa import V3

SOL_PATH = bench.SOL_PATH
SOL_CHAIN_K = 8
# Intersection flops per (primitive, ray) pair, the reference's counts of
# traverse_soa._tri_test_rows (Moeller-Trumbore) and _sphere_test_rows: only
# the geometric test, so peak / flops_per_ray is a brute-force cast's
# speed of light.
TRI_TEST_FLOPS = 53
SPH_TEST_FLOPS = 45
HARVEST_QUANTUM = 1024
METHODOLOGY = ("8 chained casts in one CUDA graph, CUDA events, least of 3 replays; "
               "untiled harvests; pool rays for packet configs")


def card():
    """(name, power limit in W) of the card, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit.strip().split()[0])


def _rays(o, d, device):
    """(V3 origins, V3 directions) on `device` from (m, 3) numpy arrays."""
    return (V3(*(torch.from_numpy(np.ascontiguousarray(o[:, i])).to(device) for i in range(3))),
            V3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])).to(device) for i in range(3))))


def _ray_batches_primary(scene, m):
    """Coherent camera-primary rays, the image's rays tiled to m."""
    from gdpt_tpu_torch.integrators import path_soa as ps

    static = scene.static
    device = scene.device.camera.sample_to_cam.device
    n = static.width * static.height
    u0, u1 = soa.uniform2(0, torch.arange(n, dtype=torch.int64, device=device), 0, 0)
    ys, xs = np.mgrid[0:static.height, 0:static.width]
    org, d = ps.primary_rays_soa(
        static, scene.device.camera, torch.from_numpy(xs.ravel().astype(np.float32)).to(device),
        torch.from_numpy(ys.ravel().astype(np.float32)).to(device), u0, u1)
    reps = -(-m // n)
    coh = (V3(*(c.repeat(reps)[:m] for c in org)), V3(*(c.repeat(reps)[:m] for c in d)))
    return coh, n


def _ray_batches(scene, sc, m=1 << 20):
    """(coherent camera-primary, incoherent bbox-random) ray batches: the
    second's origins uniform in the geometry's box, directions uniform,
    from numpy's RandomState(0)."""
    coh, _ = _ray_batches_primary(scene, m)
    geom = scene.device.geom
    g = geom.tri_v0.cpu().numpy()
    if g.size:
        e1, e2 = geom.tri_e1.cpu().numpy(), geom.tri_e2.cpu().numpy()
        vs = np.concatenate([g, g + e1, g + e2])
        lo, hi = vs.min(axis=0), vs.max(axis=0)
    else:
        c = geom.sph_center.cpu().numpy().reshape(-1, 3)
        r = geom.sph_radius.cpu().numpy().reshape(-1, 1)
        lo, hi = (c - r).min(axis=0), (c + r).max(axis=0)
    rng = np.random.RandomState(0)
    o = (lo + rng.rand(m, 3) * (hi - lo)).astype(np.float32)
    dd = rng.randn(m, 3).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    return coh, _rays(o, dd, geom.tri_v0.device)


def _harvest_rays(scene, sc, m=1 << 20, seed=9, out=print):
    """In-render ray distributions: bounce-1 scatter rays and NEE shadow
    rays from camera primaries, through the render's own cast, shading,
    BSDF sampling and light sampling (streams 11-14 of seed 9). No ray is
    repeated: the survivors are cut to whole multiples of 1,024 (at most
    m); fewer than 1,024 survivors raise ValueError."""
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.integrators import path_soa as ps
    from gdpt_tpu_torch.integrators import vertex_soa as vx
    from gdpt_tpu_torch.ops import materials_soa as msoa

    static = scene.static
    coh, _ = _ray_batches_primary(scene, m=m)
    org, d = coh
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, 0.0, BIG)
    v = ps.shade_hit(static, sc, org, d, hit, gn_raw)
    ok = v.valid > 0
    used = static.used_material_kinds
    params = msoa.gather_params_soa(
        sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v, static.spec_image_slots,
        float_tex_slots=static.float_tex_slots)
    idx = torch.arange(org.x.shape[0], dtype=torch.int64, device=org.x.device)
    bu0, bu1 = soa.uniform2(seed, idx, 11, 0)
    wl, _ = soa.uniform2(seed, idx, 12, 0)
    samp = msoa.sample_bsdf_soa(params, -1.0 * d, v.gn, v.frame, bu0, bu1, wl, used)
    good = ok & (samp.valid > 0)
    lu0, lu1 = soa.uniform2(seed, idx, 13, 0)
    lw, lsw = soa.uniform2(seed, idx, 14, 0)
    _, p_l, _, _, _ = vx.sample_light_point(static, sc, v.position, lu0, lu1, lw, lsw)
    sdir = soa.normalize(p_l - v.position)

    def pick(o3, d3, mask, what):
        o3 = V3(*(c[mask] for c in o3))
        d3 = V3(*(c[mask] for c in d3))
        n_ok = o3.x.shape[0]
        if n_ok < HARVEST_QUANTUM:
            raise ValueError(f"_harvest_rays: only {n_ok} {what} survivors (< "
                             f"{HARVEST_QUANTUM}); harvested SOL would be meaningless")
        keep = min(m, (n_ok // HARVEST_QUANTUM) * HARVEST_QUANTUM)
        out(f"harvest {what}: {n_ok} survivors, using {keep}")
        return V3(*(c[:keep] for c in o3)), V3(*(c[:keep] for c in d3))

    return pick(v.position, samp.dir_out, good, "bounce"), pick(v.position, sdir, ok, "shadow")


def _pool_shadow_rays(scene, sc, org, d, alive, tnear):
    """The render's other traced population: NEE shadow rays from the
    captured pool rays' hits (cast, shade, sample a light point), thinned
    as nee_soa thins them (no ray where the contribution is zero). Returns
    (origins, directions, tfar, live count); a thinned lane has tfar -1."""
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.integrators import path_soa as ps
    from gdpt_tpu_torch.integrators import vertex_soa as vx
    from gdpt_tpu_torch.ops import materials_soa as msoa
    from gdpt_tpu_torch.ops import textures_soa as tsoa

    static = scene.static
    n = org.x.shape[0]
    tfar_ext = torch.where(alive, BIG, -1.0)
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, tnear, tfar_ext)
    v = ps.shade_hit(static, sc, org, d, hit, gn_raw)
    used = static.used_material_kinds
    params = msoa.gather_params_soa(
        sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v, static.spec_image_slots,
        float_tex_slots=static.float_tex_slots, fp=v.fp)
    idx = torch.arange(n, dtype=torch.int64, device=org.x.device)
    lu0, lu1 = soa.uniform2(7, idx, 3, 0)
    lw, lsw = soa.uniform2(7, idx, 4, 0)
    light_id, p_l, n_l, pdf_pt, is_env = vx.sample_light_point(
        static, sc, v.position, lu0, lu1, lw, lsw)
    to_l = p_l - v.position
    dist = soa.length(to_l)
    dl = soa.where(is_env, -1.0 * n_l, to_l * (1.0 / torch.clamp_min(dist, 1e-20)))
    g_area = (torch.clamp_min(-soa.dot(dl, n_l), 0.0) / torch.clamp_min(dist * dist, 1e-20))
    g_geo = torch.where(is_env, 1.0, g_area)
    p1 = soa.take(sc.light_pmf, light_id) * pdf_pt
    f_nee = msoa.eval_bsdf_soa(params, -1.0 * d, dl, v.gn, v.frame, used)
    zero = torch.zeros(n, dtype=REAL, device=org.x.device)
    zero3 = V3(zero, zero, zero)
    env_nee = (tsoa.envmap_emission_soa(ps._env_view(static, sc), sc.mat_tables.pool3, dl)
               if static.has_envmap else zero3)
    l_emit = soa.where(is_env, env_nee,
                       soa.where(soa.dot(n_l, -1.0 * dl) > 0,
                                 soa.gather(sc.light_intensity, light_id), zero3))
    need = (alive & (v.valid > 0) & (g_geo > 0) & (p1 > 0)
            & (soa.vmax(f_nee) > 0) & (soa.vmax(l_emit) > 0))
    tfar = torch.where(is_env, BIG, (1.0 - static.shadow_epsilon) * dist)
    tfar = torch.where(need, tfar, -1.0)
    return v.position, dl, tfar, int(need.sum())


def chained_ms(cast, reps=3, k=SOL_CHAIN_K):
    """Least ms of k (SOL_CHAIN_K) casts captured as one CUDA graph, over
    `reps` replays each timed by CUDA events, and the graph's last cast's
    output (from the last replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):  # builds, allocator warm-up outside the capture
            cast()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            last = cast()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, last


def _closest(static, g, org, d, tnear, tfar, sort_hint=None):
    from gdpt_tpu_torch.accel import traverse_soa as trs

    def cast():
        hit, _ = trs.intersect_soa_gn(static, g, org, d, tnear, tfar, sort_hint=sort_hint)
        return hit.t, hit.prim_id
    return cast


def _any(static, g, org, d, tnear, tfar):
    from gdpt_tpu_torch.accel import traverse_soa as trs

    return lambda: (trs.occluded_soa(static, g, org, d, tnear, tfar),)


def _timed_mrays(static, g, org, d, tnear=1e-4, tfar=None, sort_hint=None, live=None,
                 keep=None):
    """Mrays/s of the closest-hit cast over these rays (live of them
    counted, all by default), SOL_CHAIN_K casts a graph replay. keep: a
    list that gets (the chained cast's (t, prim), the cast)."""
    cast = _closest(static, g, org, d, tnear, BIG if tfar is None else tfar, sort_hint)
    ms, last = chained_ms(cast)
    if keep is not None:
        keep.append((last, cast))
    counted = org.x.shape[0] if live is None else live
    return counted * SOL_CHAIN_K / (ms * 1e-3) / 1e6


def _timed_occluded_mrays(static, g, org, d, tfar=None, live=None, keep=None):
    """Mrays/s of the any-hit cast (tnear 1e-4), as _timed_mrays."""
    n = org.x.shape[0]
    tf = torch.full((n,), BIG, dtype=REAL, device=org.x.device) if tfar is None else tfar
    cast = _any(static, g, org, d, 1e-4, tf)
    ms, last = chained_ms(cast)
    if keep is not None:
        keep.append((last, cast))
    counted = n if live is None else live
    return counted * SOL_CHAIN_K / (ms * 1e-3) / 1e6


def _backend(scene, sc):
    if scene.static.use_brute_force:
        return "brute"
    return "packet" if sc.geom.packet is not None else "super16"


def _configs(only, scenes, out=print):
    """(config, host scene) of every config asked for whose scene exists."""
    for cfg in bench.CONFIGS:
        if only and cfg.name not in only:
            continue
        err = bench.missing_scene(cfg, scenes)
        if err is not None:
            out(json.dumps({"config": cfg.name, "error": err[:200]}))
            continue
        yield cfg, bench.make_scene(cfg, scenes)


def kernel_row(scene, peak_gflops, m=1 << 20, keep=None, out=print):
    """One config's row of measure_kernels, for a scene on the card. keep:
    a list that gets (label, chained output, cast) of every timed cast."""
    from gdpt_tpu_torch.integrators import path_soa as ps
    from gdpt_tpu_torch.tools.wavefront_visits import capture_pool_rays

    static = scene.static
    sc = ps.scene_soa_from_aos(scene)
    coh, inc = _ray_batches(scene, sc, m)
    bounce, shadow = _harvest_rays(scene, sc, m, out=out)
    kept = []
    row = {
        "backend": _backend(scene, sc),
        "platform": "gpu",
        "methodology": METHODOLOGY,
        "sol_kernel_coh_mrays": round(_timed_mrays(static, sc.geom, *coh, keep=kept), 2),
        "sol_kernel_inc_mrays": round(_timed_mrays(static, sc.geom, *inc, keep=kept), 2),
        "sol_kernel_bounce_mrays": round(_timed_mrays(static, sc.geom, *bounce, keep=kept), 2),
        "sol_kernel_shadow_mrays": round(
            _timed_occluded_mrays(static, sc.geom, *shadow, keep=kept), 2),
    }
    labels = ["coherent", "incoherent", "bounce", "shadow"]
    if row["backend"] == "packet":
        device = coh[0].x.device
        rays = capture_pool_rays(scene, warm_chunks=3, pool=1 << 18)
        porg, pd = _rays(np.stack([rays[k] for k in ("ox", "oy", "oz")], 1),
                         np.stack([rays[k] for k in ("dx", "dy", "dz")], 1), device)
        pb = torch.from_numpy(rays["bounce"]).to(device)
        palive = torch.from_numpy(rays["alive"]).to(device)
        ptn = torch.where(pb == 0, 0.0, static.intersection_epsilon)
        # Dead lanes ride as dead rays (tfar < tnear), as in the render's
        # extension cast; only live rays count.
        ptf = torch.where(palive, 3e37, -1.0)
        live_ext = int(palive.sum())
        row["sol_kernel_pool_mrays"] = round(_timed_mrays(
            static, sc.geom, porg, pd, tnear=ptn, tfar=ptf, live=live_ext, keep=kept), 2)
        labels.append("pool")
        sorg, sdl, stf, live_sh = _pool_shadow_rays(scene, sc, porg, pd, palive, ptn)
        row["pool_live_ext"] = live_ext
        row["pool_live_shadow"] = live_sh
        if live_sh > 0:
            row["sol_kernel_shadow_pool_mrays"] = round(_timed_occluded_mrays(
                static, sc.geom, sorg, sdl, tfar=stf, live=live_sh, keep=kept), 2)
            labels.append("pool shadow")
            row["sol_mix_ceiling_mrays"] = round((live_ext + live_sh) / (
                live_ext / row["sol_kernel_pool_mrays"]
                + live_sh / row["sol_kernel_shadow_pool_mrays"]), 2)
    if row["backend"] == "brute":
        fpr = static.n_tris * TRI_TEST_FLOPS + static.n_spheres * SPH_TEST_FLOPS
        row["flops_per_ray"] = fpr
        row["fma_peak_gflops"] = round(peak_gflops, 1)
        row["sol_flop_floor_mrays"] = round(peak_gflops * 1e3 / fpr, 2)
    if keep is not None:
        keep.extend((label, last, cast) for label, (last, cast) in zip(labels, kept))
    return row


def measure_kernels(only=None, m=1 << 20, scenes="scenes", keep=None, out=print):
    """{config: row} for every config asked for, on the card."""
    from gdpt_tpu_torch.core.dtypes import resolve_device
    from gdpt_tpu_torch.scene.build import scene_to
    from gdpt_tpu_torch.tools import fma_peak

    device = resolve_device(None)
    name, limit = card()
    peak = fma_peak.measure_fma_peak(device=device)
    out(json.dumps({"fma_peak_gflops": round(peak, 1),
                    "published_gflops": fma_peak.PUBLISHED_GFLOPS, "card": name,
                    "power_limit_w": limit}))
    rows = {}
    for cfg, scene in _configs(only, scenes, out):
        row = kernel_row(scene_to(scene, device), peak, m, keep=keep, out=out)
        rows[cfg.name] = dict(row, card=name, power_limit_w=limit)
        out(json.dumps({"config": cfg.name, **rows[cfg.name]}))
    return rows


def visit_prices(tab, n_rays=262_144, n_visits=2048, out=print):
    """(ns per super visit per ray, ns per leaf visit per ray) of the
    table's own visits, measured by K5 (tools/visit_microbench.run)."""
    from gdpt_tpu_torch.tools import visit_microbench as vm

    modes = ("super32", "leaf24") if tab.width == 32 else ("super", "leaf")
    timed = vm.run(tab, n_rays, n_visits, modes=modes, out=out)
    return timed[modes[0]][1], timed[modes[1]][1]


def visits_per_ray(static, tab, org, d, tnear=1e-4):
    """Mean super and leaf visits a ray, counted by K3's counting
    instance (closest hit, tfar 3e37)."""
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import traverse_soa as trs

    n = org.x.shape[0]
    dev = org.x.device
    rays = (*(c.contiguous() for c in org), *(c.contiguous() for c in d),
            torch.full((n,), tnear, dtype=REAL, device=dev),
            torch.full((n,), 3e37, dtype=REAL, device=dev))
    _, _, cnt = pk.trace_packets(tab, *rays, n_tris=trs._table_n_tris(static), counts=True)
    cnt = cnt.double().mean(dim=0)
    return float(cnt[0]), float(cnt[1])


def visit_row(scene, m=1 << 17, out=print):
    """One packet config's visit-floor row, for a scene on the card; None
    for a config without a packet table."""
    from gdpt_tpu_torch.integrators import path_soa as ps

    if scene.static.use_brute_force:
        return None
    sc = ps.scene_soa_from_aos(scene)
    tab = sc.geom.packet
    if tab is None:
        return None
    ns_super, ns_leaf = visit_prices(tab, out=out)
    _, inc = _ray_batches(scene, sc, m)
    bounce, _ = _harvest_rays(scene, sc, m, out=out)
    row = {"visit_ns_super": ns_super, "visit_ns_leaf": ns_leaf}
    for label, rays in (("inc", inc), ("bounce", bounce)):
        sv, lv = visits_per_ray(scene.static, tab, *rays)
        row[f"visits_per_ray_{label}"] = round(sv + lv, 2)
        row[f"super_visits_per_ray_{label}"] = round(sv, 2)
        row[f"leaf_visits_per_ray_{label}"] = round(lv, 2)
        row[f"visit_floor_{label}_mrays"] = round(1e3 / (sv * ns_super + lv * ns_leaf), 2)
    return row


def measure_visit_floors(only=None, m=1 << 17, scenes="scenes", out=print):
    """{config: visit-floor row} for every packet config asked for, on the
    card."""
    from gdpt_tpu_torch.core.dtypes import resolve_device
    from gdpt_tpu_torch.scene.build import scene_to

    device = resolve_device(None)
    name, limit = card()
    rows = {}
    for cfg, scene in _configs(only, scenes, out):
        row = visit_row(scene_to(scene, device), m, out=out)
        if row is None:
            continue
        rows[cfg.name] = dict(row, card=name, power_limit_w=limit)
        out(json.dumps({"config": cfg.name, **rows[cfg.name]}))
    return rows


def merge(sol, rows):
    """Merge rows into the SOL dict: a config's row measured on another
    card is replaced whole; kernel_floor_frac from the kernel and the
    floor of the same rays (bounce, else incoherent)."""
    for name, row in rows.items():
        if sol.get(name, {}).get("card") != row["card"]:
            sol[name] = {}
        sol[name].update(row)
        for suffix in ("bounce", "inc"):
            k, f = f"sol_kernel_{suffix}_mrays", f"visit_floor_{suffix}_mrays"
            if k in sol[name] and f in sol[name]:
                sol[name]["kernel_floor_frac"] = round(sol[name][k] / sol[name][f], 3)
                break
    return sol


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "kernel"
    if mode not in ("kernel", "visits"):
        raise SystemExit(f"mode must be kernel or visits, got {mode!r}")
    only, scenes = None, "scenes"
    rest = list(argv[1:])
    while rest:
        a = rest.pop(0)
        if a.startswith("--only="):
            only = set(a[len("--only="):].split(","))
        elif a == "--scenes":
            scenes = rest.pop(0)
        elif a.startswith("--scenes="):
            scenes = a[len("--scenes="):]
        else:
            raise SystemExit(f"unknown argument {a!r}")
    t0 = time.perf_counter()
    rows = (measure_kernels(only=only, scenes=scenes) if mode == "kernel"
            else measure_visit_floors(only=only, scenes=scenes))
    sol = {}
    if SOL_PATH.exists():
        with open(SOL_PATH) as f:
            sol = json.load(f)
    merge(sol, rows)
    with open(SOL_PATH, "w") as f:
        json.dump(sol, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {SOL_PATH} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
