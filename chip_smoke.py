#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gdpt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card and its power limit; build the native sources of
     gdpt_tpu_torch/csrc (two CUDA files, one C++ file; one compiler
     process each, started together; timed);
  2. hold K1 (closest hit) and K2 (any hit) against their plain PyTorch
     versions at the 512x512 cbox's ray count: camera rays, random
     bounce rays from the camera hits, and shadow rays toward the light;
  3. the brute-force main path: render.render(cornell_box(512, 512,
     spp=4)) on cuda, with the kernel launch counters zeroed just before
     and read just after; the image must be finite and not black, and
     both kernels must have been launched;
  4. render cornell_box(32, 32, spp=2, max_depth=3) on cuda and on the
     CPU (plain versions) and hold the two images together;
  5. time K1 and K2 and their plain versions with CUDA events over CUDA
     graph replays (no host launch overhead between calls), beside their
     bound (the larger of bytes over 3.35 TB/s and operations over 67
     TFLOP/s f32, the H100 SXM's published peaks);
  6. profile one 512x512 cbox sample: device time by kernel, the device's
     busy share, and the kernels' share of device time;
  7. build the BVH scene: the Cornell box's walls, light and camera with
     the two boxes replaced by subdivided icospheres (levels 7 and 6,
     409,612 triangles): host BVH, packet table (timed);
  8. hold K3 (the BVH walk, closest hit and any hit) against its plain
     version on 262,144 camera, bounce and shadow rays of that scene, on
     a small 16-wide table and on a table with in-table spheres, and
     against brute force over every triangle on a 16,384-ray sample
     (grazing rays the walk's box test drops are counted and printed);
  9. the BVH main path: render.render(scene, spp=4) on cuda (packet
     table, kept from phase 7 -> K3 -> wavefront renderer), counters
     zeroed just before and read just after; image finite and not black, both K3 modes launched;
 10. render a small BVH scene (a level-3 icosphere in the box, 32x32,
     2 spp) on cuda and on the CPU and hold the two images together;
 11. time K3 (closest and any hit, rays morton-sorted and unsorted) by
     CUDA graph replay, beside its plain version and its bound, whose
     operations and table rows are counted from these rays' own visits;
 12. profile one wavefront chunk (8 iterations) of the BVH render.

Prints one "kernels" JSON line, then the card's name and power limit, and
last {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device or without the gdpt_tpu_torch package beside it.
"""

import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
OPS_PER_TRI_PAIR = 52       # 46 f32 add/sub/mul/div + 6 compares
OPS_PER_SPH_PAIR = 40       # 34 f32 add/sub/mul/div/max/sqrt + 6 compares
OPS_PER_BOX = 25            # slab test: 6 mul, 6 sub, 12 min/max, 1 compare
SPP_MAIN = 4                # brute-force main path
SPP_BVH = 4                 # BVH main path
N_BRUTE_SAMPLE = 16384      # rays held against brute force over all triangles


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, n):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _time_ms(fn, calls, reps=5):
    """(device ms per call, host-bound ms per call). The first replays a
    CUDA graph of `calls` calls `reps` times, so no host launch overhead
    sits between them; the second times eager calls back to back."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm the allocator outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()

    def replay():
        for _ in range(reps):
            graph.replay()

    def eager():
        for _ in range(calls):
            fn()

    return _events_ms(replay, calls * reps), _events_ms(eager, calls)


def _compare_k1(got, ref, label):
    """Max abs error of K1's outputs and the prim mismatch count; fails
    unless prims agree on all but 0.01% of rays (ties only) and values
    agree to 1e-5 relative where they do."""
    import torch

    t, prim, *rest = got
    rt, rprim, *rrest = ref
    same = prim == rprim
    mism = int((~same).sum())
    errs = [float((a - b).abs().max()) for a, b in zip([t, *rest], [rt, *rrest])]
    rel = max(float(((a - b).abs() / (1.0 + b.abs()))[same].max())
              for a, b in zip([t, *rest], [rt, *rrest]))
    print(f"  K1 {label}: prim mismatches {mism} of {prim.numel()}, "
          f"max abs err {max(errs):.3g} (t {errs[0]:.3g}, u {errs[1]:.3g}, "
          f"v {errs[2]:.3g}, gn {max(errs[3:]):.3g}), max rel err {rel:.3g}, "
          f"hits {float((rprim >= 0).float().mean()):.4f}")
    if mism > prim.numel() // 10000 or not rel <= 1e-5 or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"K1 disagrees with its plain version on {label}")
    return max(errs)


def _report_profile(prof, wall_us, phase, what, ours, ours_label, card):
    """Device time by kernel name, kernel launches, and the device's busy
    share of the profiled wall time; `ours` picks this repo's kernels."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    total = sum(dev_us.values())
    if not total:
        print(f"phase {phase}: the profiler saw no device time: not measured")
        return
    count = sum(e.count for e in kernels)
    mine = sum(t for k, t in dev_us.items() if ours in k)
    print(f"phase {phase}: {what} under torch.profiler on {card}: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {total / 1e3:.1f} ms ({total / wall_us:.3f} of wall), "
          f"{count} kernel launches, {ours_label} {mine / 1e3:.2f} ms "
          f"({mine / total:.3f} of device time)")
    for key, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t / 1e3:8.2f} ms  {key[:90]}")


def _profile_one_sample(render, presets, card):
    """Phase 6: where one 512x512 cbox sample's time goes."""
    from torch.profiler import ProfilerActivity, profile

    scene = presets.cornell_box(512, 512, spp=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render.render(scene, seed=1, device="cuda")
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 6, "1 spp 512x512 cbox", "brute_kernel", "K1+K2", card)


def _kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no PyTorch call casts rays against triangles
    }


def _brute_phases(card):
    """Phases 2-6: the brute-force path (cbox, K1 and K2). Returns the
    kernels' rows for the JSON line."""
    import numpy as np
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.core import soa
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    # ---- phase 2: kernels vs plain at the main path's shapes ----
    dev = torch.device("cuda")
    scene = presets.cornell_box(512, 512, spp=SPP_MAIN)
    st = scene.static
    sc = path_soa.scene_soa_from_aos(scene_to(scene, dev))
    g = sc.geom
    n = st.width * st.height
    org, d = _camera_rays(scene, dev)
    soups = (g.tri_soup, g.sph_soup, st.n_tris, st.n_spheres)
    cam_rays = (*org, *d)
    k1_err = _compare_k1(bk.intersect_brute(*soups, *cam_rays, 0.0),
                         bk.intersect_brute_plain(*soups, *cam_rays, 0.0), "camera rays")
    hit = bk.intersect_brute(*soups, *cam_rays, 0.0)
    pos, rd, dl, tfar, live = _secondary_rays(org, d, hit[0], hit[1], st.shadow_epsilon)
    eps = st.intersection_epsilon
    bounce_rays = (*pos, *rd)
    k1_err = max(k1_err, _compare_k1(
        bk.intersect_brute(*soups, *bounce_rays, eps),
        bk.intersect_brute_plain(*soups, *bounce_rays, eps), "bounce rays"))
    sh_rays = (*pos, *dl, tfar)
    seps = st.shadow_epsilon
    blocked = bk.occluded_brute(*soups, *sh_rays, seps)
    blocked_ref = bk.occluded_brute_plain(*soups, *sh_rays, seps)
    k2_err = float((blocked - blocked_ref).abs().max())
    print(f"  K2 shadow rays: {int((blocked != blocked_ref).sum())} of {n} differ, "
          f"blocked {float(blocked_ref.mean()):.4f}, live {float(live.float().mean()):.4f}")
    if k2_err > 0:
        raise AssertionError("K2 disagrees with its plain version on shadow rays")
    torch.cuda.synchronize()
    print("phase 2: K1 and K2 agree with their plain versions")

    # ---- phase 3: the brute-force main path on cuda ----
    for k in bk.LAUNCHES:
        bk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    img, rays = render.render(presets.cornell_box(512, 512, spp=SPP_MAIN), seed=0,
                              device="cuda", return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    mean = float(img.mean())
    print(f"phase 3: cbox 512x512 spp {SPP_MAIN}: mean radiance {mean:.6f}, "
          f"wall {wall:.3f} s, rays {rays:.0f}, {rays / wall / 1e6:.2f} Mrays/s, "
          f"launches {launches} on {card}")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not mean > 0:
        raise AssertionError("main-path image is not finite, not 512x512x3 or black")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")

    # ---- phase 4: cuda vs cpu render ----
    small = presets.cornell_box(32, 32, spp=2, max_depth=3)
    _cuda_vs_cpu(render, small, 4, "cbox")

    # ---- phase 5: timing beside the bound ----
    k1 = lambda: bk.intersect_brute(*soups, *bounce_rays, eps)  # noqa: E731
    k1p = lambda: bk.intersect_brute_plain(*soups, *bounce_rays, eps)  # noqa: E731
    k2 = lambda: bk.occluded_brute(*soups, *sh_rays, seps)  # noqa: E731
    k2p = lambda: bk.occluded_brute_plain(*soups, *sh_rays, seps)  # noqa: E731
    (k1_ms, k1_call), (k2_ms, k2_call) = _time_ms(k1, 100), _time_ms(k2, 100)
    (k1p_ms, _), (k2p_ms, _) = _time_ms(k1p, 10), _time_ms(k2p, 10)
    # K1 tests every pair; K2 stops at the first blocking primitive and
    # skips dead lanes: count the pairs this run's shadow rays need.
    t_s, s_s = st.n_tris, st.n_spheres
    k1_ops = n * (t_s * OPS_PER_TRI_PAIR + s_s * OPS_PER_SPH_PAIR)
    hit_rows = bk._tri_test_rows(g.tri_soup, t_s, tuple(sh_rays[:3]), tuple(sh_rays[3:6]),
                                 float(np.float32(seps)), tfar)[3]
    blk = hit_rows.any(dim=0)
    tested = torch.where(blk, hit_rows.int().argmax(dim=0) + 1, t_s)
    live2 = tfar > float(np.float32(seps))
    k2_ops = float(tested[live2].sum()) * OPS_PER_TRI_PAIR
    if s_s:
        k2_ops += float((live2 & ~blk).sum()) * s_s * OPS_PER_SPH_PAIR
    rows = []
    src = "gdpt_tpu_torch/csrc/brute_intersect.cu"
    for name, src_line, ms, call_ms, pms, nbytes, ops, cnt, err in (
            ("intersect_brute (K1)", "gdpt_tpu/accel/pallas_intersect.py:31", k1_ms, k1_call,
             k1p_ms, 52 * n, k1_ops, launches["intersect"], k1_err),
            ("occluded_brute (K2)", "gdpt_tpu/accel/pallas_intersect.py:223", k2_ms, k2_call,
             k2p_ms, 32 * n, k2_ops, launches["occluded"], k2_err)):
        rows.append(_kernel_row(name, src, src_line, cnt, err, ms, pms, nbytes, ops))
        print(f"phase 5: {name}: {ms * 1e3:.2f} us/launch on the device "
              f"({call_ms * 1e3:.2f} us per eager wrapper call), plain {pms * 1e3:.1f} us, "
              f"bound {rows[-1]['bound_ms'] * 1e3:.2f} us ({rows[-1]['bound_by']}), "
              f"{cnt / SPP_MAIN:.1f} launches/sample on {card}")

    _profile_one_sample(render, presets, card)
    return rows


def _camera_rays(scene, dev):
    """One camera ray per pixel of `scene` (jittered by seed 7), as V3s."""
    import numpy as np
    import torch

    from gdpt_tpu_torch.core import soa
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.scene.build import scene_to

    st = scene.static
    ys, xs = np.mgrid[0:st.height, 0:st.width]
    xs_d = torch.as_tensor(xs.ravel(), dtype=torch.float32, device=dev)
    ys_d = torch.as_tensor(ys.ravel(), dtype=torch.float32, device=dev)
    u0, u1 = soa.uniform2(7, torch.arange(st.width * st.height, device=dev), 0, 0)
    cam = scene_to(scene, dev).device.camera
    return path_soa.primary_rays_soa(st, cam, xs_d, ys_d, u0, u1)


def _secondary_rays(org, d, t, prim, shadow_eps):
    """From the camera hits: random bounce directions (seed 11), and
    shadow rays to random points on the Cornell light quad (y = 548.7,
    x in [213, 343], z in [227, 332]); misses and every eighth lane are
    dead (tfar = -1), as NEE retires lanes. Returns contiguous component
    tuples pos, bounce dir, light dir, and tfar, live."""
    import torch

    from gdpt_tpu_torch.core import soa

    n, dev = t.shape[0], t.device
    pos = soa.where(prim >= 0, org + d * t, org)
    gen = torch.Generator(device=dev).manual_seed(11)
    rd = torch.randn((3, n), generator=gen, device=dev)
    rd = rd / rd.norm(dim=0)
    lp = torch.rand((3, n), generator=gen, device=dev)
    lx, ly, lz = 213.0 + 130.0 * lp[0], torch.full_like(lp[1], 548.7), 227.0 + 105.0 * lp[2]
    to_l = soa.V3(lx, ly, lz) - pos
    dist = soa.length(to_l)
    dl = to_l * (1.0 / dist.clamp_min(1e-20))
    live = (prim >= 0) & (torch.arange(n, device=dev) % 8 != 0)
    tfar = torch.where(live, (1.0 - shadow_eps) * dist, -1.0)
    cont = lambda v: tuple(c.contiguous() for c in v)  # noqa: E731
    return cont(pos), cont(rd.unbind(0)), cont(dl), tfar, live


def _cuda_vs_cpu(render, scene, phase, label):
    import numpy as np

    a = render.render(scene, seed=3, device="cuda")
    b = render.render(scene, seed=3, device="cpu")
    frac = float(np.isclose(a, b, rtol=1e-3, atol=1e-4).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(float(b.mean()), 1e-12)
    print(f"phase {phase}: cuda vs cpu 32x32 {label}: {frac:.5f} of values within "
          f"rtol 1e-3/atol 1e-4, mean rel diff {mean_rel:.3g}")
    if frac < 0.99 or mean_rel > 1e-3:
        raise AssertionError(f"cuda and cpu renders of the {label} disagree")


def _icosphere(level, center, radius):
    """Unit icosahedron subdivided `level` times (20 * 4^level triangles),
    vertices pushed onto the sphere: (positions (V, 3), indices (T, 3))."""
    import numpy as np

    p = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                  [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = inv.reshape(3, -1) + len(v)
        v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
    return v * radius + np.asarray(center, np.float64), f


def _icosphere_box(width, height, spp, balls, spheres=(), max_depth=-1):
    """The Cornell box of presets.cornell_box (walls, ceiling light,
    camera, materials) with its two blocks replaced by icospheres:
    balls = [(level, center, radius), ...]; spheres = analytic spheres
    [(center, radius), ...]. Lambertian throughout."""
    import numpy as np

    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.scene import build, presets
    from gdpt_tpu_torch.scene import model as M
    from gdpt_tpu_torch.scene.filters import FILTER_GAUSSIAN

    quads = presets._mesh_from_quads
    materials = [M.Lambertian(presets.WHITE), M.Lambertian(presets.RED),
                 M.Lambertian(presets.GREEN), M.Lambertian(np.array([0.78, 0.78, 0.78]))]
    shapes = [
        quads([((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))], material_id=0),
        quads([((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0))],
              material_id=0),
        quads([((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))],
              material_id=0),
        quads([((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))], material_id=2),
        quads([((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))],
              material_id=1),
    ]
    for level, center, radius in balls:
        pos, idx = _icosphere(level, center, radius)
        shapes.append(M.TriangleMesh(positions=pos, indices=idx, material_id=0))
    for center, radius in spheres:
        shapes.append(M.Sphere(center=np.asarray(center, np.float64), radius=radius,
                               material_id=0))
    shapes.append(quads([((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
                          (213, 548.7, 227))], material_id=3, area_light_id=0))
    lights = [M.DiffuseAreaLight(shape_id=len(shapes) - 1, intensity=presets.LIGHT_RGB)]
    cam = M.Camera(cam_to_world=xf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
                   fov=39.3077, width=width, height=height,
                   filter_kind=FILTER_GAUSSIAN, filter_param=0.5)
    opts = M.RenderOptions(integrator="path", samples_per_pixel=spp, max_depth=max_depth)
    return build.build_scene(cam, materials, shapes, lights, options=opts)


# The tall block's place and the short block's, resting on the floor.
BALLS_FULL = [(7, (368.0, 100.0, 351.0), 100.0), (6, (186.0, 60.0, 169.0), 60.0)]


def _compare_k3(pk, tab, rays, n_tris, any_hit, label):
    """K3 against its plain version on the same rays. Both walk the same
    nodes in the same order with separately rounded operations, so t is
    held bit-equal and prim equal; the gate allows 0.01% of rays, every
    exception counted and printed. Returns (max abs err of t, counts)."""
    import torch

    t, prim, cnt = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True)
    rt, rprim, rcnt = pk.trace_packets_plain(tab, *rays, n_tris=n_tris, any_hit=any_hit,
                                             counts=True)
    torch.cuda.synchronize()
    n = t.shape[0]
    if any_hit:
        bad_t, bad_prim = 0, int(((prim >= 0) != (rprim >= 0)).sum())
    else:
        bad_t = int((t != rt).sum())
        bad_prim = int(((t == rt) & (prim != rprim)).sum())
    bad_cnt = int((cnt != rcnt).any(dim=1).sum())
    err = float((t - rt).abs().max())
    mean = cnt.float().mean(dim=0).tolist()
    print(f"  K3 {'any-hit' if any_hit else 'closest'} {label}: {n} rays, t differs on {bad_t}, "
          f"prim differs at equal t on {bad_prim}, visit counts differ on {bad_cnt}, "
          f"max abs err of t {err:.3g}, hits {float((rprim >= 0).float().mean()):.4f}; per ray "
          f"{mean[0]:.1f} super visits, {mean[1]:.1f} leaf visits, {mean[2]:.1f} primitive "
          f"tests, deepest stack {int(cnt[:, 3].max())} of {tab.stack_n // tab.width}")
    if bad_t + bad_prim > n // 10000 or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"K3 disagrees with its plain version on {label}")
    return err, cnt


def _brute_over_geo9(bk, geo9, rays, tnear):
    """Closest t of every ray over every triangle row of geo9, in chunks
    of plain PyTorch (the row tester of the brute kernels' plain version)."""
    import torch

    o, d = tuple(rays[:3]), tuple(rays[3:6])
    best = torch.full_like(rays[0], 3e37)
    for lo in range(0, geo9.shape[0], 4096):
        soup = geo9[lo:lo + 4096].T.contiguous()
        t, _, _, hit = bk._tri_test_rows(soup, soup.shape[1], o, d, tnear, 3e37)
        best = torch.minimum(best, torch.where(hit, t, 3e37).amin(dim=0))
    return best


def _small_table_checks(pk, dev):
    """K3 vs plain off the main path's shapes: a 16-wide table, and a
    32-wide table with more than 8 in-table spheres (n_tris given)."""
    import torch

    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.scene.build import scene_to

    errs = []
    spheres = [((60.0 + 48.0 * i, 40.0 + 30.0 * (i % 3), 120.0 + 35.0 * i), 30.0)
               for i in range(10)]
    for label, wide, sph in (("16-wide table", 16, ()), ("in-table spheres", 32, spheres)):
        scene = _icosphere_box(256, 256, 1, [(3, (368.0, 100.0, 351.0), 100.0)], sph)
        st = scene.static
        g = trs.geom_soa_from_aos(scene_to(scene, dev).device.geom, wide=wide)
        n_tris = trs._table_n_tris(st)
        if bool(sph) != (n_tris is not None) or g.packet.width != wide:
            raise AssertionError(f"{label}: the table is not the one asked for")
        org, d = _camera_rays(scene, dev)
        n = org.x.shape[0]
        cam = (*(c.contiguous() for c in org), *(c.contiguous() for c in d),
               torch.zeros(n, device=dev), torch.full((n,), 3e37, device=dev))
        t, prim = pk.trace_packets(g.packet, *cam, n_tris=n_tris)
        if sph and not bool((prim >= st.n_tris).any()):
            raise AssertionError("no camera ray hit an in-table sphere")
        pos, rd, dl, tfar, _ = _secondary_rays(org, d, t, prim, st.shadow_epsilon)
        eps = torch.full((n,), st.intersection_epsilon, device=dev)
        errs.append(_compare_k3(pk, g.packet, cam, n_tris, False, f"{label}, camera rays")[0])
        if not sph:
            # A table whose stack_n understates its depth: the kernel
            # must report the full stack, never drop the push.
            shallow = g.packet._replace(stack_n=wide)
            for counts in (True, False):
                try:
                    pk.trace_packets(shallow, *cam, counts=counts)
                    pk.check_overflow()
                except RuntimeError as e:
                    if "stack" not in str(e):
                        raise
                else:
                    raise AssertionError("K3 dropped a push past its stack without an error")
            print(f"  K3 {label}: a one-entry stack raises (counts on and off)")
        errs.append(_compare_k3(pk, g.packet, (*pos, *rd, eps, torch.full_like(eps, 3e37)),
                                n_tris, False, f"{label}, bounce rays")[0])
        _compare_k3(pk, g.packet, (*pos, *dl, eps, tfar), n_tris, True,
                    f"{label}, shadow rays")
    return max(errs)


def _bvh_phases(card):
    """Phases 7-12: the BVH path (packet table, K3, wavefront renderer)
    at full size. Returns K3's rows for the JSON line."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as pt
    from gdpt_tpu_torch.core.soa import V3
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")

    # ---- phase 7: the scene, its BVH and its packet table ----
    t0 = time.perf_counter()
    scene = _icosphere_box(512, 512, SPP_BVH, BALLS_FULL)
    t_scene = time.perf_counter() - t0
    st = scene.static
    t0 = time.perf_counter()
    scene_dev = scene_to(scene, dev)
    sc = path_soa.scene_soa_from_aos(scene_dev)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    tab = sc.geom.packet
    rows = tab.table.shape[0]
    print(f"phase 7: icosphere box: {st.n_tris} triangles, {scene.device.geom.bvh_count.shape[0]} "
          f"BVH nodes by the {scene.bvh_builder} builder, scene build {t_scene:.2f} s; packet "
          f"table {rows} rows x 128 ({rows * 512 / 1e6:.1f} MB), width {tab.width}, "
          f"stack_n {tab.stack_n}, table and shading tables {t_table:.2f} s")
    if st.use_brute_force or st.n_tris < 400_000 or scene.bvh_builder != "native":
        raise AssertionError("the BVH scene is not the full-size one, or not natively built")

    # ---- phase 8: K3 vs plain, and vs brute force ----
    org, d = _camera_rays(scene, dev)
    n = org.x.shape[0]
    big = torch.full((n,), 3e37, device=dev)
    cam = (*(c.contiguous() for c in org), *(c.contiguous() for c in d),
           torch.zeros(n, device=dev), big)
    err, _ = _compare_k3(pk, tab, cam, None, False, "camera rays")
    t_cam, prim_cam = pk.trace_packets(tab, *cam)
    pos, rd, dl, tfar, _ = _secondary_rays(org, d, t_cam, prim_cam, st.shadow_epsilon)
    eps_i = torch.full((n,), st.intersection_epsilon, device=dev)
    eps_s = torch.full((n,), st.shadow_epsilon, device=dev)
    bounce = (*pos, *rd, eps_i, big)
    shadow = (*pos, *dl, eps_s, tfar)
    err_b, _ = _compare_k3(pk, tab, bounce, None, False, "bounce rays")
    err_s, _ = _compare_k3(pk, tab, shadow, None, True, "shadow rays")
    err_c = max(err, err_b)
    err_c = max(err_c, _small_table_checks(pk, dev))
    # Brute force over every triangle is the oracle of any walk. A ray
    # that grazes a leaf group's tight f32 box can be a hit there and a
    # box-miss in the walk: the slab test's bound*inv - org*inv cancels
    # to a few ulps of org*inv, and an axis-aligned wall has a box of
    # zero thickness. Such rays are counted, not chased. The ones seen
    # leave a wall at a grazing angle and re-hit that wall just past
    # tnear; any other kind is held to 0.01%, all kinds to 0.1%.
    pick = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(5),
                          device=dev)[:N_BRUTE_SAMPLE]
    sample = tuple(c[pick].contiguous() for c in bounce)
    t_k3 = pk.trace_packets(tab, *sample)[0]
    t_bf = _brute_over_geo9(bk, tab.geo9, sample, st.intersection_epsilon)
    off = ~torch.isclose(t_k3, t_bf, rtol=1e-5, atol=0.0)
    missed = int((off & (t_bf < t_k3)).sum())
    at_eps = int((off & (t_bf < 2.0 * st.intersection_epsilon)).sum())
    n_off = int(off.sum())
    span = (f", brute-force t of these from {float(t_bf[off].min()):.4f} to "
            f"{float(t_bf[off].max()):.4f}" if n_off else "")
    print(f"  K3 closest vs brute force over {tab.geo9.shape[0]} triangles on {N_BRUTE_SAMPLE} "
          f"bounce rays: {n_off} beyond rtol 1e-5 ({missed} hits the walk missed, {at_eps} of "
          f"them re-hits of the ray's own wall within 2 tnear = "
          f"{2.0 * st.intersection_epsilon:.4f}{span})")
    if n_off - at_eps > N_BRUTE_SAMPLE // 10000 or n_off > N_BRUTE_SAMPLE // 1000:
        raise AssertionError("K3 disagrees with brute force over all triangles")
    print("phase 8: K3 agrees with its plain version and with brute force")

    # ---- phase 9: the BVH main path on cuda ----
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    if path_soa.scene_soa_from_aos(scene_to(scene, "cuda")) is not sc:
        raise AssertionError("the scene's tables of phase 7 were not kept for the render")
    t0 = time.perf_counter()
    img, rays = render.render(scene, spp=SPP_BVH, seed=0, device="cuda", return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    mean = float(img.mean())
    iters = path_soa.render_soa_wavefront.last_iters
    occ = path_soa.render_soa_wavefront.last_occupancy
    print(f"phase 9: icosphere box 512x512 spp {SPP_BVH}: mean radiance {mean:.6f}, "
          f"wall {wall:.3f} s (tables kept from phase 7, {t_table:.2f} s), rays {rays:.0f}, "
          f"{rays / wall / 1e6:.2f} Mrays/s, launches {launches}, {iters} wavefront "
          f"iterations, mean occupancy {occ:.3f} on {card}")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not mean > 0:
        raise AssertionError("BVH main-path image is not finite, not 512x512x3 or black")
    if min(launches.values()) == 0:
        raise AssertionError(f"a K3 mode of the BVH main path was never launched: {launches}")

    # ---- phase 10: cuda vs cpu render of a small BVH scene ----
    _cuda_vs_cpu(render, _icosphere_box(32, 32, 2, [(3, (368.0, 100.0, 351.0), 100.0)]),
                 10, "icosphere box (1,280 + 12 triangles)")

    # ---- phase 11: timing beside the bound ----
    def presorted(r):
        keys = pt._morton_keys(tab, V3(*r[:3]), V3(*r[3:6]))
        perm = torch.argsort(torch.where(r[7] >= r[6], keys, 2 ** 30), stable=True)
        return tuple(c[perm].contiguous() for c in r)

    out_rows = []
    for name, mode, r, any_hit, err_k in (
            ("trace_packets closest (K3)", "packet_intersect", bounce, False, err_c),
            ("trace_packets any-hit (K3)", "packet_occluded", shadow, True, err_s)):
        rs = presorted(r)
        ms_sorted, _ = _time_ms(lambda: pk.trace_packets(tab, *rs, any_hit=any_hit), 10, 3)
        ms_unsorted, _ = _time_ms(lambda: pk.trace_packets(tab, *r, any_hit=any_hit), 10, 3)
        full = (pt.occluded_packet if any_hit else pt.intersect_packet)
        o3, d3 = V3(*r[:3]), V3(*r[3:6])
        full(tab, o3, d3, r[6], r[7])
        ms_full = _events_ms(lambda: [full(tab, o3, d3, r[6], r[7]) for _ in range(5)], 5)
        pk.trace_packets_plain(tab, *rs, any_hit=any_hit)
        ms_plain = _events_ms(lambda: pk.trace_packets_plain(tab, *rs, any_hit=any_hit), 1)
        cnt = pk.trace_packets(tab, *rs, any_hit=any_hit, counts=True)[2].sum(dim=0).tolist()
        ops = cnt[0] * tab.width * OPS_PER_BOX + cnt[2] * OPS_PER_TRI_PAIR
        # Bytes of this call: eight ray arrays in (no start refs), t and
        # prim out, and each table row these rays' visits read, once.
        read = torch.zeros(rows, dtype=torch.bool, device=dev)
        pk.trace_packets_plain(tab, *rs, any_hit=any_hit, rows_read=read)
        n_read = int(read.sum())
        nbytes = 40 * n + n_read * 512
        row = _kernel_row(name, "gdpt_tpu_torch/csrc/packet_trace.cu",
                          "gdpt_tpu/accel/packet_trace.py:486", launches[mode], err_k,
                          ms_sorted, ms_plain, nbytes, ops)
        out_rows.append(row)
        print(f"phase 11: {name}: {ms_sorted * 1e3:.1f} us/launch on sorted rays, "
              f"{ms_unsorted * 1e3:.1f} us unsorted, {ms_full * 1e3:.1f} us per eager wrapper "
              f"call with sort, unsort and hit attributes; plain (eager, with its host "
              f"syncs) {ms_plain * 1e3:.0f} us; bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_by']}: {ops / 1e9:.2f} Gop, {nbytes / 1e6:.1f} MB = 40 B/ray + "
              f"{n_read} of {rows} rows read); "
              f"{launches[mode] / SPP_BVH:.1f} launches/sample on {card}")

    # ---- phase 12: one wavefront chunk under the profiler ----
    n_pix = st.width * st.height
    total = n_pix * SPP_BVH
    state = path_soa._wavefront_state(n_pix, path_soa._pool_width(total), total, 1, dev)
    cam_arrays = scene_dev.device.camera
    for _ in range(8):  # fill the pool to its steady state first
        state = path_soa._wavefront_body(st, cam_arrays, sc, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            state = path_soa._wavefront_body(st, cam_arrays, sc, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 12, "8 wavefront iterations of the icosphere box",
                    "packet_trace_kernel", "K3", card)
    return out_rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from gdpt_tpu_torch.accel import native_build

    # ---- phase 1: card and build ----
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    libs = native_build.build_all(
        ["brute_intersect.cu", "packet_trace.cu", "bvh_builder.cpp"], verbose=True)
    print(f"phase 1: built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")

    rows = _brute_phases(card) + _bvh_phases(card)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
