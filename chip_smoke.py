#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gdpt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card and its power limit; build the CUDA kernels from
     gdpt_tpu_torch/csrc (timed);
  2. hold each kernel (K1 closest hit, K2 any hit) against its plain
     PyTorch version at the 512x512 cbox's ray count: camera rays, random
     bounce rays from the camera hits, and shadow rays toward the light;
  3. the main path: render.render(cornell_box(512, 512, spp=16)) on cuda,
     with the kernel launch counters zeroed just before and read just
     after; the image must be finite and not black, and both kernels
     must have been launched;
  4. render cornell_box(32, 32, spp=2, max_depth=3) on cuda and on the
     CPU (plain versions) and hold the two images together;
  5. time each kernel and its plain version with CUDA events over CUDA
     graph replays (no host launch overhead between calls), beside its
     bound (the larger of bytes over 3.35 TB/s and operations over 67
     TFLOP/s f32, the H100 SXM's published peaks);
  6. profile one 512x512 sample: device time by kernel, the device's
     busy share, and the kernels' share of device time.

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
SPP_MAIN = 16


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


def _profile_one_sample(render, presets, card):
    """Phase 6: where one 512x512 sample's time goes. torch.profiler over
    a 1-spp render: device time by kernel name, kernel launches, and the
    device's busy share of the (profiled) wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scene = presets.cornell_box(512, 512, spp=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render.render(scene, seed=1, device="cuda")
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    total = sum(dev_us.values())
    if not total:
        print("phase 6: the profiler saw no device time: not measured")
        return
    count = sum(e.count for e in kernels)
    ours = sum(t for k, t in dev_us.items() if "brute_kernel" in k)
    print(f"phase 6: 1 spp 512x512 under torch.profiler on {card}: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {total / 1e3:.1f} ms ({total / wall_us:.3f} of wall), "
          f"{count} kernel launches, K1+K2 {ours / 1e3:.2f} ms ({ours / total:.3f} of device time)")
    for key, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t / 1e3:8.2f} ms  {key[:90]}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.core import soa
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    # ---- phase 1: card and build ----
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    lib = bk.build(verbose=True)
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.2f} s")

    # ---- phase 2: kernels vs plain at the main path's shapes ----
    dev = torch.device("cuda")
    scene = presets.cornell_box(512, 512, spp=SPP_MAIN)
    st = scene.static
    sc = path_soa.scene_soa_from_aos(scene_to(scene, dev))
    g = sc.geom
    n = st.width * st.height
    ys, xs = np.mgrid[0:st.height, 0:st.width]
    xs_d = torch.as_tensor(xs.ravel(), dtype=torch.float32, device=dev)
    ys_d = torch.as_tensor(ys.ravel(), dtype=torch.float32, device=dev)
    ray_idx = torch.arange(n, device=dev)
    u0, u1 = soa.uniform2(7, ray_idx, 0, 0)
    cam = scene_to(scene, dev).device.camera
    org, d = path_soa.primary_rays_soa(st, cam, xs_d, ys_d, u0, u1)
    soups = (g.tri_soup, g.sph_soup, st.n_tris, st.n_spheres)
    cam_rays = (*org, *d)
    k1_err = _compare_k1(bk.intersect_brute(*soups, *cam_rays, 0.0),
                         bk.intersect_brute_plain(*soups, *cam_rays, 0.0), "camera rays")
    hit = bk.intersect_brute(*soups, *cam_rays, 0.0)
    pos = soa.where(hit[1] >= 0, org + d * hit[0], org)
    gen = torch.Generator(device=dev).manual_seed(11)
    rd = torch.randn((3, n), generator=gen, device=dev)
    rd = rd / rd.norm(dim=0)
    eps = st.intersection_epsilon
    bounce_rays = (*(c.contiguous() for c in pos), *rd.unbind(0))
    k1_err = max(k1_err, _compare_k1(
        bk.intersect_brute(*soups, *bounce_rays, eps),
        bk.intersect_brute_plain(*soups, *bounce_rays, eps), "bounce rays"))
    # Shadow rays from the camera hits to random points on the light quad
    # (y = 548.7, x in [213, 343], z in [227, 332]); misses and every
    # eighth lane are dead (tfar = -1), as NEE retires lanes.
    lp = torch.rand((3, n), generator=gen, device=dev)
    lx, ly, lz = 213.0 + 130.0 * lp[0], torch.full_like(lp[1], 548.7), 227.0 + 105.0 * lp[2]
    to_l = soa.V3(lx, ly, lz) - pos
    dist = soa.length(to_l)
    dl = to_l * (1.0 / dist.clamp_min(1e-20))
    live = (hit[1] >= 0) & (ray_idx % 8 != 0)
    tfar = torch.where(live, (1.0 - st.shadow_epsilon) * dist, -1.0)
    sh_rays = (*(c.contiguous() for c in pos), *dl, tfar)
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

    # ---- phase 3: the main path on cuda ----
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
    a = render.render(small, seed=3, device="cuda")
    b = render.render(small, seed=3, device="cpu")
    frac = float(np.isclose(a, b, rtol=1e-3, atol=1e-4).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(float(b.mean()), 1e-12)
    print(f"phase 4: cuda vs cpu 32x32: {frac:.5f} of values within rtol 1e-3/atol 1e-4, "
          f"mean rel diff {mean_rel:.3g}")
    if frac < 0.99 or mean_rel > 1e-3:
        raise AssertionError("cuda and cpu renders disagree")

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
    for name, src_line, ms, call_ms, pms, nbytes, ops, cnt, err in (
            ("intersect_brute (K1)", "gdpt_tpu/accel/pallas_intersect.py:31", k1_ms, k1_call,
             k1p_ms, 52 * n, k1_ops, launches["intersect"], k1_err),
            ("occluded_brute (K2)", "gdpt_tpu/accel/pallas_intersect.py:223", k2_ms, k2_call,
             k2p_ms, 32 * n, k2_ops, launches["occluded"], k2_err)):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "gdpt_tpu_torch/csrc/brute_intersect.cu", "replaces": src_line,
            "launches": cnt, "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        print(f"phase 5: {name}: {ms * 1e3:.2f} us/launch on the device "
              f"({call_ms * 1e3:.2f} us per eager wrapper call), plain {pms * 1e3:.1f} us, "
              f"bound {max(t_bytes, t_ops) * 1e3:.2f} us ({rows[-1]['bound_by']}), "
              f"{cnt / SPP_MAIN:.1f} launches/sample on {card}")

    _profile_one_sample(render, presets, card)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
