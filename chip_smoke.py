#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gdpt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card and its power limit; build the native sources of
     gdpt_tpu_torch/csrc (four CUDA files, one C++ file; one compiler
     process each, started together; timed); read every timed kernel's
     registers and local memory from the built libraries;
  2. hold K1 (closest hit) and K2 (any hit) against their plain PyTorch
     versions at the 512x512 cbox's ray count, bit for bit (0 rays may
     differ in the bits of t, u, v, the normal or blocked, or in prim):
     camera rays, random bounce rays from the camera hits and shadow rays
     toward the light, all live and with dead lanes (tfar = -1) scattered
     and in whole warps;
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
     a small 16-wide table and on a table with in-table spheres (0 rays
     may differ in t, prim or visit counts), and
     against brute force over every triangle on a 16,384-ray sample
     (grazing rays the walk's box test drops are counted and printed);
  9. the BVH main path: render.render(scene, spp=4) on cuda (packet
     table, kept from phase 7 -> K3 -> wavefront renderer), counters
     zeroed just before and read just after; image finite and not black, both K3 modes launched;
 10. render a small BVH scene (a level-3 icosphere in the box, 32x32,
     2 spp) on cuda and on the CPU and hold the two images together;
 11. time K3 (closest and any hit, rays morton-sorted and unsorted) by
     CUDA graph replay, beside its plain version and its bound, whose
     operations and table rows the plain version counts from these rays'
     own visits;
 12. profile one wavefront chunk (8 iterations) of the BVH render;
 13. build that scene's 16-wide packet table; hold K4 (the dual walk)
     against its plain version and against K3 on it: camera, bounce and
     shadow rays, 262,144 and 262,143 rays, closest and any hit;
 14. hold K5 (the visit microbenchmark) against its plain version in every
     mode on 65,536 rays with 256 visits, bit for bit; then run the tool's
     entry point at 262,144 rays with 2,048 visits on the 32- and the
     16-wide table (counters zeroed just before, read just after, one per
     mode): ns per visit per ray and mode, beside K3's time per visit in
     the walk; and hold K5's super32 and leaf24 at that size against the
     plain version, whose time is taken there, bit for bit;
 15. the gradient-domain main path: render.render of the scene with
     integrator "gradpath", 4 spp, default table (5-path lockstep in the
     wavefront lane pool -> K3 -> screened-Poisson solve), counters zeroed
     just before and read just after; the Poisson solve timed alone;
 16. the same render at 1 spp on the 16-wide table, solo (K3) then dual
     (K4): identical images, K4 launched, K3 not launched by the dual
     render;
 17. render gradpath 32x32 on cuda and on the CPU, brute force (cbox) and
     BVH, and hold reconstruction and gradients together;
 18. time K4 beside K3 on the 16-wide table (rays sorted and unsorted) by
     CUDA graph replay, beside the plain version and the bound;
 19. hold K3 and K4 against their plain versions on the ray batches the
     gradpath lane pool hands the walk in its steady state (the pool's
     own rays, the 8n-lane probe/replay cast with most lanes dead, the
     5n-lane primary cast of a refill, the shadow rays): 0 rays may
     differ; time K3 on the 32- and the 16-wide table and K4 on each by
     CUDA graph replay beside its bound, and sum each walk's time over a
     gradpath iteration; then profile one gradpath wavefront chunk (6
     iterations);
 20. record the K1 and K2 batches of one 512x512 cbox `path` sample and
     one 512x512 cbox `gradpath` sample as the banded loops hand them to
     the wrappers; hold each against its plain version bit for bit, time
     it by CUDA graph replay beside its bound, print its live share, and
     sum K1 + K2 per sample of each render.

Prints one "kernels" JSON line (every row also carries its kernel's
registers and local bytes, K1's and K2's phase 20's time per sample of
each render),
then the card's name and power limit, and
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
SPP_GRAD = 4                # gradient-domain main path
N_BRUTE_SAMPLE = 16384      # rays held against brute force over all triangles
# The kernel behind each row of the kernels line, in its order: a part of
# its mangled name (K3 and K4 as timed, without counts; K5 super32 = mode
# 4, leaf24 = mode 9).
KERNEL_ENTRIES = (
    ("K1", "intersect_brute_kernel"), ("K2", "occluded_brute_kernel"),
    ("K3 closest", "packet_trace_kernelILi32ELb0ELb0E"),
    ("K3 any hit", "packet_trace_kernelILi32ELb1ELb0E"),
    ("K4 closest", "packet_trace_dual_kernelILb0ELb0E"),
    ("K4 any hit", "packet_trace_dual_kernelILb1ELb0E"),
    ("K5 super32", "visit_microbench_kernelILi4E"), ("K5 leaf24", "visit_microbench_kernelILi9E"))


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


def _brute_bits(a):
    import torch

    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _compare_k1(got, ref, label):
    """K1 against its plain version: 0 rays may differ in the bits of t,
    u, v or the normal, or in prim (the same operations in the same order
    with the same tie rule). Returns the max abs error (0)."""
    import torch

    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for a, b in zip(got, ref):
        bad |= _brute_bits(a) != _brute_bits(b)
    n_bad = int(bad.sum())
    err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, ref))
    print(f"  K1 {label}: {n_bad} of {got[0].numel()} rays differ, max abs err {err:.3g}, "
          f"hits {float((ref[1] >= 0).float().mean()):.4f}")
    if n_bad or not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"K1 disagrees with its plain version on {label}")
    return err


def _compare_k2(got, ref, label, live):
    """K2 against its plain version: 0 rays may differ."""
    n_bad = int((got != ref).sum())
    print(f"  K2 {label}: {n_bad} of {got.numel()} rays differ, blocked "
          f"{float(ref.mean()):.4f}, live {float(live.float().mean()):.4f}")
    if n_bad:
        raise AssertionError(f"K2 disagrees with its plain version on {label}")
    return float((got - ref).abs().max())


def _dead_lanes(n, share, layout, dev, seed):
    """A mask of dead lanes: `share` of them, one by one or in whole warps."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "warps":
        return (torch.rand((n + 31) // 32, generator=gen, device=dev) < share).repeat_interleave(
            32)[:n]
    return torch.rand(n, generator=gen, device=dev) < share


def _brute_work(kind, args):
    """(live lanes, operations, bytes) of one K1 or K2 call, from its
    inputs: 52 operations per ray-triangle and 40 per ray-sphere pair that
    the live rays test (K2 stops at a ray's first blocking triangle; the
    plain version finds it), and the bytes the call must move: tfar of
    every lane, the six ray components of the live lanes, every output (K1
    28 B a lane, K2 4 B)."""
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk

    tri, sph, n_tris, n_sph, *rays, tfar, tnear = args
    n = tfar.shape[0]
    tn = float(torch.tensor(tnear, dtype=torch.float32))
    live = tfar > tn
    n_live = int(live.sum())
    if kind == "K1":
        return (n_live, n_live * (n_tris * OPS_PER_TRI_PAIR + n_sph * OPS_PER_SPH_PAIR),
                4 * n + 24 * n_live + 28 * n)
    ops = 0.0
    blk = torch.zeros(n, dtype=torch.bool, device=tfar.device)
    if n_tris:
        hit = bk._tri_test_rows(tri, n_tris, tuple(rays[:3]), tuple(rays[3:]), tn, tfar)[3]
        blk = hit.any(dim=0)
        tested = torch.where(blk, hit.int().argmax(dim=0) + 1, n_tris)
        ops += float(tested[live].sum()) * OPS_PER_TRI_PAIR
    if n_sph:
        ops += float((live & ~blk).sum()) * n_sph * OPS_PER_SPH_PAIR
    return n_live, ops, 4 * n + 24 * n_live + 4 * n


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
    big = torch.full((n,), bk.BIG, device=dev)
    cam_rays = (*org, *d, big)
    k1_err = _compare_k1(bk.intersect_brute(*soups, *cam_rays, 0.0),
                         bk.intersect_brute_plain(*soups, *cam_rays, 0.0), "camera rays")
    hit = bk.intersect_brute(*soups, *cam_rays, 0.0)
    pos, rd, dl, tfar, live = _secondary_rays(org, d, hit[0], hit[1], st.shadow_epsilon)
    eps, seps = st.intersection_epsilon, st.shadow_epsilon
    bounce_rays = (*pos, *rd, big)
    sh_rays = (*pos, *dl, tfar)
    k2_err = _compare_k2(bk.occluded_brute(*soups, *sh_rays, seps),
                         bk.occluded_brute_plain(*soups, *sh_rays, seps), "shadow rays", live)
    for share, layout in ((0.0, "lanes"), (0.5, "lanes"), (0.5, "warps"), (0.93, "lanes"),
                          (0.93, "warps"), (1.0, "lanes")):
        dead = _dead_lanes(n, share, layout, dev, seed=int(share * 100) + len(layout))
        what = f"{share:.2f} dead by {layout}"
        b_far = torch.where(dead, -1.0, big)
        k1_err = max(k1_err, _compare_k1(bk.intersect_brute(*soups, *pos, *rd, b_far, eps),
                                         bk.intersect_brute_plain(*soups, *pos, *rd, b_far, eps),
                                         f"bounce rays, {what}"))
        s_far = torch.where(dead, -1.0, tfar)
        k2_err = max(k2_err, _compare_k2(bk.occluded_brute(*soups, *pos, *dl, s_far, seps),
                                         bk.occluded_brute_plain(*soups, *pos, *dl, s_far, seps),
                                         f"shadow rays, {what}", s_far > seps))
    torch.cuda.synchronize()
    print("phase 2: K1 and K2 equal their plain versions bit for bit")

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
    k1_args = (*soups, *bounce_rays, eps)
    k2_args = (*soups, *sh_rays, seps)
    k1 = lambda: bk.intersect_brute(*k1_args)  # noqa: E731
    k1p = lambda: bk.intersect_brute_plain(*k1_args)  # noqa: E731
    k2 = lambda: bk.occluded_brute(*k2_args)  # noqa: E731
    k2p = lambda: bk.occluded_brute_plain(*k2_args)  # noqa: E731
    (k1_ms, k1_call), (k2_ms, k2_call) = _time_ms(k1, 100), _time_ms(k2, 100)
    (k1p_ms, _), (k2p_ms, _) = _time_ms(k1p, 10), _time_ms(k2p, 10)
    rows = []
    src = "gdpt_tpu_torch/csrc/brute_intersect.cu"
    for name, src_line, ms, call_ms, pms, kind, args, cnt, err in (
            ("intersect_brute (K1)", "gdpt_tpu/accel/pallas_intersect.py:31", k1_ms, k1_call,
             k1p_ms, "K1", k1_args, launches["intersect"], k1_err),
            ("occluded_brute (K2)", "gdpt_tpu/accel/pallas_intersect.py:223", k2_ms, k2_call,
             k2p_ms, "K2", k2_args, launches["occluded"], k2_err)):
        n_live, ops, nbytes = _brute_work(kind, args)
        rows.append(_kernel_row(name, src, src_line, cnt, err, ms, pms, nbytes, ops))
        print(f"phase 5: {name}: {ms * 1e3:.2f} us/launch on the device "
              f"({call_ms * 1e3:.2f} us per eager wrapper call), plain {pms * 1e3:.1f} us, "
              f"bound {rows[-1]['bound_ms'] * 1e3:.2f} us ({rows[-1]['bound_by']}: "
              f"{ops / 1e9:.3f} Gop, {nbytes / 1e6:.1f} MB, {n_live} of {n} lanes live), "
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


def _gate_cuda_vs_cpu(a, b, scale, phase, label):
    import numpy as np

    frac = float(np.isclose(a, b, rtol=1e-3, atol=1e-4).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(scale, 1e-12)
    print(f"phase {phase}: cuda vs cpu 32x32 {label}: {frac:.5f} of values within "
          f"rtol 1e-3/atol 1e-4, mean rel diff {mean_rel:.3g}")
    if frac < 0.99 or mean_rel > 1e-3:
        raise AssertionError(f"cuda and cpu renders of the {label} disagree")


def _cuda_vs_cpu(render, scene, phase, label):
    a = render.render(scene, seed=3, device="cuda")
    b = render.render(scene, seed=3, device="cpu")
    _gate_cuda_vs_cpu(a, b, float(b.mean()), phase, label)


def _gradpath_cuda_vs_cpu(render, scene, label):
    """Reconstruction and gradients of a gradpath render, cuda against
    cpu; the gradients' means (differences near zero) are held to 0.1% of
    the primal's mean."""
    a, aux_a = render.render(scene, seed=3, device="cuda", return_aux=True)
    b, aux_b = render.render(scene, seed=3, device="cpu", return_aux=True)
    scale = float(aux_b["primal"].mean())
    _gate_cuda_vs_cpu(a, b, scale, 17, f"gradpath {label}, recon")
    for name in ("gx", "gy"):
        _gate_cuda_vs_cpu(aux_a[name], aux_b[name], scale, 17, f"gradpath {label}, {name}")


def _compare_k3(pk, tab, rays, n_tris, any_hit, label):
    """K3 against its plain version on the same rays. Both walk the same
    nodes in the same order with separately rounded operations and the
    same tie rules, so no ray may differ in t, prim or its visit counts.
    Returns (max abs err of t, counts)."""
    import torch

    t, prim, cnt = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True)
    rt, rprim, rcnt = pk.trace_packets_plain(tab, *rays, n_tris=n_tris, any_hit=any_hit,
                                             counts=True)
    torch.cuda.synchronize()
    n = t.shape[0]
    bad_t = int((t.view(torch.int32) != rt.view(torch.int32)).sum())
    bad_prim = int((prim != rprim).sum())
    bad_cnt = int((cnt != rcnt).any(dim=1).sum())
    err = float((t - rt).abs().max()) if n else 0.0
    mean = cnt.float().mean(dim=0).tolist()
    print(f"  K3 {'any-hit' if any_hit else 'closest'} {label}: {n} rays, t differs on {bad_t}, "
          f"prim on {bad_prim}, visit counts on {bad_cnt}, max abs err of t {err:.3g}, hits "
          f"{float((rprim >= 0).float().mean()):.4f}; per ray {mean[0]:.1f} super visits, "
          f"{mean[1]:.1f} leaf visits, {mean[2]:.1f} primitive tests, deepest stack "
          f"{int(cnt[:, 3].max())} of {tab.stack_n // tab.width}")
    if bad_t + bad_prim + bad_cnt or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"K3 differs from its plain version on {label}")
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
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    errs = []
    spheres = [((60.0 + 48.0 * i, 40.0 + 30.0 * (i % 3), 120.0 + 35.0 * i), 30.0)
               for i in range(10)]
    for label, wide, sph in (("16-wide table", 16, ()), ("in-table spheres", 32, spheres)):
        scene = presets.icosphere_box(256, 256, 1, [(3, (368.0, 100.0, 351.0), 100.0)], sph)
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


def _walk_work(pk, tab, rays, any_hit):
    """The work of one walk over `rays`, counted by the plain version
    whatever implements the kernel: (operations, bytes, table rows read,
    visits). Bytes: eight ray arrays in (no start refs), t and prim out,
    and each table row these rays' visits read, once."""
    import torch

    n, rows = rays[0].shape[0], tab.table.shape[0]
    read = torch.zeros(rows, dtype=torch.bool, device=rays[0].device)
    cnt = pk.trace_packets_plain(tab, *rays, any_hit=any_hit, counts=True, rows_read=read)[2]
    cnt = cnt.sum(dim=0).tolist()
    ops = cnt[0] * tab.width * OPS_PER_BOX + cnt[2] * OPS_PER_TRI_PAIR
    n_read = int(read.sum())
    return ops, 40 * n + n_read * 512, n_read, cnt[0] + cnt[1]


def _time_walk(pk, pt, tab, r, rs, any_hit, dual, phase, name, source, replaces, launches,
               spp, err, card):
    """Time one walk kernel (K3, or K4 with dual) on rays `r` and their
    morton-sorted copy `rs` by CUDA graph replay, beside the plain version
    and the bound counted from these rays' own visits. Returns its row and
    its time per visit per ray in ns."""
    from gdpt_tpu_torch.core.soa import V3

    n, rows = r[0].shape[0], tab.table.shape[0]
    walk = lambda rr: pk.trace_packets(tab, *rr, any_hit=any_hit, dual=dual)  # noqa: E731
    plain = pk.trace_packets_dual_plain if dual else pk.trace_packets_plain
    ms_sorted, _ = _time_ms(lambda: walk(rs), 10, 3)
    ms_unsorted, _ = _time_ms(lambda: walk(r), 10, 3)
    full = (pt.occluded_packet if any_hit else pt.intersect_packet)
    o3, d3 = V3(*r[:3]), V3(*r[3:6])
    full(tab, o3, d3, r[6], r[7], dual=dual)
    ms_full = _events_ms(lambda: [full(tab, o3, d3, r[6], r[7], dual=dual) for _ in range(5)], 5)
    plain(tab, *rs, any_hit=any_hit)
    ms_plain = _events_ms(lambda: plain(tab, *rs, any_hit=any_hit), 1)
    ops, nbytes, n_read, visits = _walk_work(pk, tab, rs, any_hit)
    row = _kernel_row(name, source, replaces, launches, err, ms_sorted, ms_plain, nbytes, ops)
    print(f"phase {phase}: {name}: {ms_sorted * 1e3:.1f} us/launch on sorted rays, "
          f"{ms_unsorted * 1e3:.1f} us unsorted, {ms_full * 1e3:.1f} us per eager wrapper "
          f"call with sort, unsort and hit attributes; plain (eager, with its host "
          f"syncs) {ms_plain * 1e3:.0f} us; bound {row['bound_ms'] * 1e3:.2f} us "
          f"({row['bound_by']}: {ops / 1e9:.2f} Gop, {nbytes / 1e6:.1f} MB = 40 B/ray + "
          f"{n_read} of {rows} rows read); {visits / n:.2f} visits per ray = "
          f"{ms_sorted * 1e6 / max(visits, 1):.4f} ns per visit per ray; "
          f"{launches / spp:.1f} launches/sample on {card}")
    return row, ms_sorted * 1e6 / max(visits, 1)


def _bvh_phases(card):
    """Phases 7-12: the BVH path (packet table, K3, wavefront renderer)
    at full size. Returns K3's rows for the JSON line, and what the
    gradient-domain phases reuse: the scene and its ray sets."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as pt
    from gdpt_tpu_torch.core.soa import V3
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")

    # ---- phase 7: the scene, its BVH and its packet table ----
    t0 = time.perf_counter()
    scene = presets.icosphere_box(512, 512, SPP_BVH, presets.ICOSPHERE_BALLS)
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
    if min(launches["packet_intersect"], launches["packet_occluded"]) == 0:
        raise AssertionError(f"a K3 mode of the BVH main path was never launched: {launches}")

    # ---- phase 10: cuda vs cpu render of a small BVH scene ----
    _cuda_vs_cpu(render, presets.icosphere_box(32, 32, 2, [(3, (368.0, 100.0, 351.0), 100.0)]),
                 10, "icosphere box (1,280 + 12 triangles)")

    # ---- phase 11: timing beside the bound ----
    def presorted(r, tab=tab):
        keys = pt._morton_keys(tab, V3(*r[:3]), V3(*r[3:6]))
        perm = torch.argsort(torch.where(r[7] >= r[6], keys, 2 ** 30), stable=True)
        return tuple(c[perm].contiguous() for c in r)

    out_rows, ns_visit = [], []
    for name, mode, r, any_hit, err_k in (
            ("trace_packets closest (K3)", "packet_intersect", bounce, False, err_c),
            ("trace_packets any-hit (K3)", "packet_occluded", shadow, True, err_s)):
        row, ns = _time_walk(
            pk, pt, tab, r, presorted(r), any_hit, False, 11, name,
            "gdpt_tpu_torch/csrc/packet_trace.cu", "gdpt_tpu/accel/packet_trace.py:486",
            launches[mode], SPP_BVH, err_k, card)
        out_rows.append(row)
        ns_visit.append(ns)

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
    return out_rows, dict(scene=scene, scene_dev=scene_dev, cam=cam, bounce=bounce,
                          shadow=shadow, presorted=presorted, k3_ns_per_visit=ns_visit)


def _compare_k4(pk, tab, rays, any_hit, label):
    """K4 against its plain version and against K3 on the same rays and
    16-wide table: t, prim and the visit counts are held equal bit for
    bit (the same walk per ray). Returns the max abs err of t."""
    import torch

    got = pk.trace_packets(tab, *rays, any_hit=any_hit, counts=True, dual=True)
    ref = pk.trace_packets_dual_plain(tab, *rays, any_hit=any_hit, counts=True)
    solo = pk.trace_packets(tab, *rays, any_hit=any_hit, counts=True)
    torch.cuda.synchronize()
    n = got[0].shape[0]
    bad = [[int((a != b).reshape(n, -1).any(dim=1).sum()) for a, b in zip(got, other)]
           for other in (ref, solo)]
    mean = got[2].float().mean(dim=0).tolist()
    print(f"  K4 {'any-hit' if any_hit else 'closest'} {label}: {n} rays; vs plain: t differs on "
          f"{bad[0][0]}, prim on {bad[0][1]}, counts on {bad[0][2]}; vs K3: t {bad[1][0]}, prim "
          f"{bad[1][1]}, counts {bad[1][2]}; hits {float((ref[1] >= 0).float().mean()):.4f}; per "
          f"ray {mean[0]:.1f} super visits, {mean[1]:.1f} leaf visits, {mean[2]:.1f} primitive "
          f"tests, deepest stack {int(got[2][:, 3].max())} of {tab.stack_n // tab.width}")
    if sum(map(sum, bad)) or not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"K4 disagrees with its plain version or with K3 on {label}")
    return float((got[0] - ref[0]).abs().max())


def _k5_differ(got, ref):
    """Rays whose K5 result differs from the plain version's in any bit
    of t, prim or the mask word."""
    import torch

    torch.cuda.synchronize()
    return [int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(got, ref)]


def _gradpath_phases(card, ctx):
    """Phases 13-19: the gradient-domain path (5-path lockstep, Poisson
    solve) on the icosphere box, the dual walk K4 on its 16-wide table
    and the visit microbenchmark K5. Returns K4's and K5's rows."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as pt
    from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, render
    from gdpt_tpu_torch.ops import poisson
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to
    from gdpt_tpu_torch.tools import visit_microbench as vm

    dev = torch.device("cuda")
    scene_dev = ctx["scene_dev"]
    cam, bounce, shadow = ctx["cam"], ctx["bounce"], ctx["shadow"]
    st = scene_dev.static
    sc32 = path_soa.scene_soa_from_aos(scene_dev)
    tab32 = sc32.geom.packet

    # ---- phase 13: the 16-wide table; K4 vs plain and vs K3 ----
    t0 = time.perf_counter()
    sc16 = path_soa.scene_soa_from_aos(scene_dev, wide=16)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    tab16 = sc16.geom.packet
    rows16 = tab16.table.shape[0]
    print(f"phase 13: 16-wide packet table {rows16} rows x 128 ({rows16 * 512 / 1e6:.1f} MB), "
          f"stack_n {tab16.stack_n}, table and shading tables {t_table:.2f} s")
    if tab16.width != 16:
        raise AssertionError("the 16-wide table is not 16-wide")
    err4 = {False: 0.0, True: 0.0}
    for label, r, any_hit in (("camera rays", cam, False), ("bounce rays", bounce, False),
                              ("shadow rays", shadow, True)):
        for n in (r[0].shape[0], r[0].shape[0] - 1):
            cut = tuple(c[:n].contiguous() for c in r)
            err4[any_hit] = max(err4[any_hit], _compare_k4(pk, tab16, cut, any_hit, label))
    try:
        pk.trace_packets(tab32, *bounce, dual=True)
    except ValueError as e:
        print(f"  K4 on the 32-wide table raises: {e}")
    else:
        raise AssertionError("the dual walk took a 32-wide table")
    print("phase 13: K4 agrees with its plain version and with K3")

    # ---- phase 14: K5 vs plain in every mode, then the timed tool run ----
    small = vm.random_rays(tab32, 65_536, seed=1)
    err5 = dict.fromkeys(vm.MODES, 0.0)
    for tab in (tab32, tab16):
        for mode in vm.MODES:
            got = vm.visit_microbench(tab, *small, 256, mode)
            ref = vm.visit_microbench_plain(tab, *small, 256, mode)
            bad = _k5_differ(got, ref)
            err5[mode] = max(err5[mode], float((got[0] - ref[0]).abs().max()))
            print(f"  K5 {mode} on the {tab.width}-wide table: 65536 rays x 256 visits: t differs "
                  f"on {bad[0]}, prim on {bad[1]}, mask word on {bad[2]}; hits "
                  f"{float((ref[1] >= 0).float().mean()):.4f}, word set on "
                  f"{float((ref[2] != 0).float().mean()):.4f}")
            if sum(bad):
                raise AssertionError(f"K5 disagrees with its plain version in mode {mode}")
    print("phase 14: K5 agrees with its plain version in every mode")
    for k in vm.LAUNCHES:
        vm.LAUNCHES[k] = 0
    n_rays, n_visits = 262_144, 2048
    timed = {tab.width: vm.run(tab, n_rays, n_visits, out=lambda m: print("  " + m))
             for tab in (tab32, tab16)}
    k5_launches = dict(vm.LAUNCHES)
    if min(k5_launches.values()) == 0:
        raise AssertionError(f"the microbenchmark's entry point left a mode out: {k5_launches}")
    ns3 = ctx["k3_ns_per_visit"]
    print(f"phase 14: K5 on {card}: launches by mode {k5_launches}; K3 (a lane group per ray) "
          f"spends {ns3[0]:.4f} (closest) and {ns3[1]:.4f} (any hit) ns per visit per ray on "
          f"the 32-wide table; K5's visits of one row shared by every ray cost "
          f"{timed[32]['super32'][1]:.5f} (super32) and {timed[32]['leaf24'][1]:.5f} (leaf24) ns "
          f"coherent, the bare loop {timed[32]['empty'][1]:.5f}")
    k5_rows = []
    rays_t = vm.random_rays(tab32, n_rays)
    for mode in ("super32", "leaf24"):  # the 32-wide table's own two visits
        ref = []
        ms_plain = _events_ms(
            lambda: ref.append(vm.visit_microbench_plain(tab32, *rays_t, n_visits, mode)), 1)
        bad = _k5_differ(vm.visit_microbench(tab32, *rays_t, n_visits, mode), ref[0])
        print(f"  K5 {mode} on the 32-wide table: {n_rays} rays x {n_visits} visits: t differs "
              f"on {bad[0]}, prim on {bad[1]}, mask word on {bad[2]}")
        if sum(bad):
            raise AssertionError(f"K5 disagrees with its plain version in mode {mode} at full size")
        ops, distinct = vm.visit_work(tab32, n_visits, mode)
        k5_rows.append(_kernel_row(
            f"visit_microbench {mode} (K5)", "gdpt_tpu_torch/csrc/visit_microbench.cu",
            "tools/visit_microbench.py:44", k5_launches[mode], err5[mode], timed[32][mode][0],
            ms_plain, 44 * n_rays + distinct * 512, ops * n_rays))
        print(f"phase 14: K5 {mode}: {timed[32][mode][0]:.3f} ms/launch, plain {ms_plain:.0f} ms, "
              f"bound {k5_rows[-1]['bound_ms']:.3f} ms ({k5_rows[-1]['bound_by']}: "
              f"{ops * n_rays / 1e9:.1f} Gop, {distinct} distinct rows)")

    # ---- phase 15: the gradient-domain main path on cuda (K3) ----
    grad = ctx["scene"]._replace(static=dataclasses.replace(
        st, options=dataclasses.replace(st.options, integrator="gradpath")))
    if path_soa.scene_soa_from_aos(scene_to(grad, "cuda")).geom.packet is not tab32:
        raise AssertionError("the scene's tables of phase 7 were not kept for the render")
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    recon, aux, rays = render.render(grad, spp=SPP_GRAD, seed=0, device="cuda",
                                     return_aux=True, return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    iters = gdpt_soa._gdpt_wavefront_accum.last_iters
    occ = gdpt_soa._gdpt_wavefront_accum.last_occupancy
    m_recon, m_primal = float(recon.mean()), float(aux["primal"].mean())
    print(f"phase 15: icosphere box 512x512 gradpath spp {SPP_GRAD}: mean recon {m_recon:.6f}, "
          f"mean primal {m_primal:.6f}, wall {wall:.3f} s (tables kept), rays {rays:.0f}, "
          f"{rays / wall / 1e6:.2f} Mrays/s, launches {launches}, {iters} wavefront iterations, "
          f"mean occupancy {occ:.3f} on {card}")
    if recon.shape != (512, 512, 3) or not np.isfinite(recon).all() or not m_primal > 0:
        raise AssertionError("gradpath reconstruction is not finite, not 512x512x3 or black")
    if not all(np.isfinite(a).all() for a in aux.values()) or not np.abs(aux["gx"]).mean() > 0:
        raise AssertionError("gradpath auxiliary buffers are not finite, or the gradients zero")
    if abs(m_recon - m_primal) > 0.02 * m_primal:
        raise AssertionError("the reconstruction lost the primal's mean (the DC term)")
    if min(launches["packet_intersect"], launches["packet_occluded"]) == 0 or \
            launches["packet_dual_intersect"] + launches["packet_dual_occluded"]:
        raise AssertionError(f"the gradpath main path did not go through K3 alone: {launches}")
    grad_launches = launches
    imgs = [torch.as_tensor(aux[k], device=dev) for k in ("primal", "gx", "gy")]
    solve = lambda: poisson.screened_poisson_solve(*imgs, st.options.gdpt_alpha)  # noqa: E731
    solve()
    print(f"phase 15: screened-Poisson solve alone at 512x512: "
          f"{_events_ms(lambda: [solve() for _ in range(10)], 10):.3f} ms on the device")

    # ---- phase 16: 16-wide table, solo then dual ----
    outs = {}
    for dual in (False, True):
        if path_soa.scene_soa_from_aos(scene_to(grad, "cuda"), 16, dual).geom.packet is not tab16:
            raise AssertionError("the 16-wide table was not kept for the render")
        for k in pk.LAUNCHES:
            pk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        outs[dual] = render.render(grad, spp=1, seed=0, device="cuda", return_aux=True,
                                   return_stats=True, packet_wide=16, packet_dual=dual)
        wall = time.perf_counter() - t0
        outs[dual] += (dict(pk.LAUNCHES),)
        print(f"phase 16: gradpath 1 spp, 16-wide table, {'dual (K4)' if dual else 'solo (K3)'}: "
              f"wall {wall:.3f} s, rays {outs[dual][2]:.0f}, {outs[dual][2] / wall / 1e6:.2f} "
              f"Mrays/s, launches {outs[dual][3]}")
    same = np.array_equal(outs[True][0], outs[False][0]) and all(
        np.array_equal(outs[True][1][k], outs[False][1][k]) for k in outs[True][1])
    dual_launches = outs[True][3]
    if not same or outs[True][2] != outs[False][2]:
        raise AssertionError("the dual walk's render differs from the solo walk's")
    if min(dual_launches["packet_dual_intersect"], dual_launches["packet_dual_occluded"]) == 0 \
            or dual_launches["packet_intersect"] + dual_launches["packet_occluded"]:
        raise AssertionError(f"the dual render did not go through K4 alone: {dual_launches}")
    print("phase 16: the dual render equals the solo render, through K4 alone")

    # ---- phase 17: cuda vs cpu gradpath, brute force and BVH ----
    _gradpath_cuda_vs_cpu(render, presets.cornell_box(32, 32, spp=2, max_depth=3,
                                                      integrator="gradpath"), "cbox")
    _gradpath_cuda_vs_cpu(
        render, presets.icosphere_box(32, 32, 2, [(3, (368.0, 100.0, 351.0), 100.0)],
                                      integrator="gradpath", max_depth=3),
        "icosphere box (1,280 + 12 triangles)")

    # ---- phase 18: K4 beside K3 on the 16-wide table ----
    rows = []
    for r, any_hit, mode in ((bounce, False, "intersect"), (shadow, True, "occluded")):
        rs = ctx["presorted"](r, tab16)
        what = "any-hit" if any_hit else "closest"
        for dual, name, src, line, cnt in (
                (False, f"trace_packets {what} (K3), 16-wide table",
                 "gdpt_tpu_torch/csrc/packet_trace.cu", "gdpt_tpu/accel/packet_trace.py:486",
                 outs[False][3][f"packet_{mode}"]),
                (True, f"trace_packets dual {what} (K4)",
                 "gdpt_tpu_torch/csrc/packet_trace_dual.cu", "gdpt_tpu/accel/packet_trace.py:829",
                 dual_launches[f"packet_dual_{mode}"])):
            row, _ = _time_walk(pk, pt, tab16, r, rs, any_hit, dual, 18, name, src, line, cnt, 1,
                                err4[any_hit], card)
            if dual:
                rows.append(row)

    # ---- phase 19: the pool's own batches, then a chunk under the profiler ----
    sc = sc32
    n_pix = st.width * st.height
    total = n_pix * SPP_GRAD
    camera = scene_dev.device.camera
    used = st.used_material_kinds
    state = gdpt_soa._gdpt_wavefront_state(st, camera, sc, total, 1,
                                           path_soa._pool_width(total, 1 << 17))
    # Fill the pool to its steady state first, keeping the last batch of
    # each size and mode as the walk's wrapper receives it (scrubbed,
    # sorted, retired lanes at the back with tfar = -1).
    batches = {}
    walk = pk.trace_packets

    def recording(tab, *rays, **kw):
        batches[(rays[0].shape[0], bool(kw.get("any_hit")))] = rays
        return walk(tab, *rays, **kw)

    pk.trace_packets = recording
    try:
        for _ in range(6):
            state = gdpt_soa._gdpt_wavefront_body(st, camera, sc, used, state)
    finally:
        pk.trace_packets = walk
    pool = state["pending"].shape[0]
    if {(pool, False), (pool, True), (5 * pool, False), (8 * pool, False)} - set(batches):
        raise AssertionError(f"the pool's casts were not all seen: {sorted(batches)}")
    for (n, any_hit), rays in sorted(batches.items()):
        dead = float((rays[7] < rays[6]).float().mean())
        label = f"pool batch of {n // pool} x {pool} lanes, {dead:.4f} dead"
        _compare_k3(pk, tab32, rays, None, any_hit, label + ", 32-wide table")
        _compare_k4(pk, tab16, rays, any_hit, label)
    print("phase 19: K3 and K4 agree with their plain versions on the pool's own batches")
    # Launches per gradpath iteration (phase 15): the base, shadow and 8n
    # probe/replay casts every iteration, the 5n primary cast in those that
    # refill the pool.
    per_iter = {(pool, False): 1.0, (pool, True): 1.0, (8 * pool, False): 1.0,
                (5 * pool, False): (grad_launches["packet_intersect"] - 2 * iters) / iters}
    iter_us = dict.fromkeys(("K3, 32-wide table", "K3, 16-wide table", "K4, 16-wide table"), 0.0)
    for (n, any_hit), rays in sorted(batches.items()):
        dead = float((rays[7] < rays[6]).float().mean())
        work = {}  # K3 and K4 do the same work on the 16-wide table
        for walker, tab, dual in (("K3", tab32, False), ("K3", tab16, False),
                                  ("K4", tab16, True)):
            ms, _ = _time_ms(lambda: pk.trace_packets(tab, *rays, any_hit=any_hit, dual=dual),
                             10, 3)
            if tab.width not in work:
                work[tab.width] = _walk_work(pk, tab, rays, any_hit)
            ops, nbytes, n_read, visits = work[tab.width]
            bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3
            what = f"{walker}, {tab.width}-wide table"
            iter_us[what] += per_iter.get((n, any_hit), 0.0) * ms * 1e3
            print(f"phase 19: {walker} {'any hit' if any_hit else 'closest'} on the pool batch "
                  f"of {n // pool} x {pool} lanes ({dead:.4f} dead), {tab.width}-wide table: "
                  f"{ms * 1e3:.1f} us/launch by CUDA graph replay, bound {bound * 1e3:.2f} us "
                  f"({ops / 1e9:.3f} Gop, {nbytes / 1e6:.1f} MB, {n_read} rows read), "
                  f"{visits / n:.2f} visits per ray on {card}")
    print(f"phase 19: walk time per gradpath iteration (each batch's time x its launches per "
          f"iteration, {per_iter[(5 * pool, False)]:.4f} for the 5n cast): " + ", ".join(
              f"{k} {v:.1f} us" for k, v in iter_us.items()) + f" on {card}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(6):
            state = gdpt_soa._gdpt_wavefront_body(st, camera, sc, used, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 19, "6 gradpath wavefront iterations of the icosphere box",
                    "packet_trace_kernel", "K3", card)
    print(f"phase 19: K3 launches per gradpath sample: "
          f"{grad_launches['packet_intersect'] / SPP_GRAD:.1f} closest, "
          f"{grad_launches['packet_occluded'] / SPP_GRAD:.1f} any hit "
          f"({grad_launches['packet_intersect'] / iters:.2f} and "
          f"{grad_launches['packet_occluded'] / iters:.2f} per iteration)")
    return rows + k5_rows


def _record_brute_batches(render, presets, bk, integrator):
    """Every K1 / K2 call of one 512x512 cbox sample as (kind, args),
    recorded through the wrappers' module attributes, in order."""
    seen = []
    wrappers = {"K1": bk.intersect_brute, "K2": bk.occluded_brute}

    def recording(kind):
        def call(*args):
            seen.append((kind, args))
            return wrappers[kind](*args)
        return call

    bk.intersect_brute, bk.occluded_brute = recording("K1"), recording("K2")
    try:
        render.render(presets.cornell_box(512, 512, spp=1, integrator=integrator), seed=0,
                      device="cuda")
    finally:
        bk.intersect_brute, bk.occluded_brute = wrappers["K1"], wrappers["K2"]
    return seen


def _batch_phase(card):
    """Phase 20: K1 and K2 on the batches the banded loops hand them in
    one cbox sample of each render. Returns {render: {kernel: us}}."""
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.integrators import render
    from gdpt_tpu_torch.scene import presets

    sums = {}
    for integrator in ("path", "gradpath"):
        batches = _record_brute_batches(render, presets, bk, integrator)
        per = sums.setdefault(integrator, {"K1": 0.0, "K2": 0.0})
        for j, (kind, args) in enumerate(batches):
            fn, plain = ((bk.intersect_brute, bk.intersect_brute_plain) if kind == "K1"
                         else (bk.occluded_brute, bk.occluded_brute_plain))
            label = f"{integrator} batch {j}"
            if kind == "K1":
                _compare_k1(fn(*args), plain(*args), label)
            else:
                _compare_k2(fn(*args), plain(*args), label, args[10] > args[11])
            ms, _ = _time_ms(lambda fn=fn, args=args: fn(*args), 10, 3)
            n_live, ops, nbytes = _brute_work(kind, args)
            n = args[10].shape[0]
            bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e6
            per[kind] += ms * 1e3
            print(f"phase 20: {label}: {kind} on {n} lanes, live {n_live / n:.4f}, "
                  f"{ms * 1e3:.2f} us by CUDA graph replay, bound {bound:.2f} us "
                  f"({ops / 1e9:.4f} Gop, {nbytes / 1e6:.2f} MB) on {card}")
        torch.cuda.synchronize()
        print(f"phase 20: cbox 512x512 {integrator}, one sample: {len(batches)} batches, each "
              f"equal to the plain version bit for bit; K1 {per['K1']:.1f} us + K2 "
              f"{per['K2']:.1f} us = {per['K1'] + per['K2']:.1f} us per sample on {card}")
    return sums


def _resource_usage(lib):
    """{kernel entry (mangled): (registers, local memory bytes a thread)}
    of a built library, from the toolkit's cuobjdump; {} where there is
    none."""
    import re
    import shutil
    from pathlib import Path

    from gdpt_tpu_torch.accel import native_build

    tool = shutil.which("cuobjdump") or str(Path(native_build.nvcc()).parent / "cuobjdump")
    try:
        out = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        return {}
    found = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", out)
    return {name: (int(reg), int(stack) + int(local)) for name, reg, stack, local in found}


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
        ["brute_intersect.cu", "packet_trace.cu", "packet_trace_dual.cu",
         "visit_microbench.cu", "bvh_builder.cpp"], verbose=True)
    print(f"phase 1: built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    resources = {}
    for lib in libs[:4]:
        resources.update(_resource_usage(lib))
    use = {entry: [v for k, v in resources.items() if entry in k] for _, entry in KERNEL_ENTRIES}
    use = {entry: v[0] if v else (None, None) for entry, v in use.items()}
    print(f"phase 1: registers, local bytes a thread: "
          + ", ".join(f"{name} {use[entry]}" for name, entry in KERNEL_ENTRIES))

    rows = _brute_phases(card)
    k3_rows, ctx = _bvh_phases(card)
    rows += k3_rows + _gradpath_phases(card, ctx)
    sums = _batch_phase(card)
    if len(rows) != len(KERNEL_ENTRIES):
        raise AssertionError(f"{len(rows)} kernel rows for {len(KERNEL_ENTRIES)} entries")
    for row, (name, entry) in zip(rows, KERNEL_ENTRIES):
        row["registers"], row["local_bytes"] = use[entry]
    for row, name in zip(rows, ("K1", "K2")):
        row["us_per_sample"] = {r: v[name] for r, v in sums.items()}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
