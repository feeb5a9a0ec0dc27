"""Per-bounce breakdown of a banded SoA path-trace sample.

Counterpart of tools/profile_render.py: path_soa.trace_paths_soa replayed
stage by stage (the same RNG counters, the same ray streams): primary
rays, the extension cast, shade_hit, the NEE shadow ray, the shadow cast,
the BSDF stage and the lane update, each timed as the reference's stages
(tools/profile_wavefront.timed: wall, and on the card the stage's kernel
launches and device time). The lane update keeps the reference's
approximation of Russian roulette (a uniform 0.8 survival past rr_depth),
so live lanes after rr_depth are the reference's, not the render's. On a
scene with a packet table, standalone probes follow: incoherent and
coherent casts through packet_trace.intersect_packet and a morton-key
argsort with the port's unsort (a scatter). On the card, for a scene
inside integrators/path_fused.py's envelope, the split of a replayed
sample follows (fused_split): the replay by CUDA events, and each fused
stage's kernel and plain version by CUDA events beside its bytes bound.

    python -m gdpt_tpu_torch.tools.profile_render [scene] [--bounces N]
        [--skip-probes] [--probe-rays N] [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
material_box_bvh, the stand-in for the reference's disney_bsdf).
"""

import argparse
import statistics
import sys

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_trace as pt
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import banded, path_fused
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.integrators import vertex_soa as vx
from gdpt_tpu_torch.ops import materials_soa as msoa
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.profile_wavefront import timed
from gdpt_tpu_torch.utils.profiling import device_note, event_span_ms

DEFAULT_SCENE = "material_box_bvh"
# The stages of a bounce in the reference's three columns.
COLUMNS = {"intersect": "intersect", "occluded": "occluded", "gen_primary": "other",
           "shade": "other", "nee_rays": "other", "bsdf": "other", "update": "other"}


def profile(scene, bounces=16, probes=True, probe_rays=1 << 20, reps=3):
    """Rows (dicts) of one sample, bounce by bounce: one row per stage
    (bounce, stage, live lanes entering the bounce, wall_ms, launches,
    device_ms, hand_ms, hand_launches; the primary cast also its hits),
    then on a packet scene one row per
    probe (stage "probe ...", rays)."""
    static = scene.static
    camera = scene.device.camera
    device = camera.sample_to_cam.device
    w, h = static.width, static.height
    n = w * h
    sc = ps.scene_soa_from_aos(scene)
    used = static.used_material_kinds
    ys, xs = np.mgrid[0:h, 0:w]
    xs_d = torch.from_numpy(xs.ravel().astype(np.float32)).to(device)
    ys_d = torch.from_numpy(ys.ravel().astype(np.float32)).to(device)
    ray_idx = torch.arange(n, dtype=torch.int64, device=device)
    rows = []

    def uni2(bounce, ctr):
        return soa.uniform2(0, ray_idx, bounce * ps._CTR_STRIDE + ctr, 0)

    def stage(bounce, name, live, fn, *args):
        out, row = timed(fn, *args, device=device, reps=reps)
        rows.append({"bounce": bounce, "stage": name, "live": live, **row})
        return out

    def gen_primary():
        u0, u1 = uni2(0, ps._CTR_PIXEL)
        return ps.primary_rays_soa(static, camera, xs_d, ys_d, u0, u1)

    def do_intersect(org, d, tnear, tfar):
        return trs.intersect_soa_gn(static, sc.geom, org, d, tnear, tfar)

    def do_shade(org, d, hit, gn):
        return ps.shade_hit(static, sc, org, d, hit, gn)

    def nee_rays(v, b, active):
        """First half of ps.nee_soa: light sample -> shadow ray."""
        lu0, lu1 = uni2(b, ps._CTR_LIGHT_UV)
        lw, lsw = uni2(b, ps._CTR_LIGHT_W)
        _, p_l, n_l, _, is_env = vx.sample_light_point(static, sc, v.position, lu0, lu1, lw,
                                                       lsw)
        to_l = p_l - v.position
        dist = soa.length(to_l)
        dl = soa.where(is_env, -1.0 * n_l, to_l * (1.0 / torch.clamp_min(dist, 1e-20)))
        tfar = torch.where(is_env, BIG, (1.0 - static.shadow_epsilon) * dist)
        return dl, torch.where(active, tfar, -1.0)

    def do_occluded(org, dl, tfar):
        return trs.occluded_soa(static, sc.geom, org, dl, static.shadow_epsilon, tfar)

    def bsdf_stage(v, b, d, active):
        """Materials math: params gather + full eval/sample/pdf."""
        dir_view = -d
        params = msoa.gather_params_soa(
            sc.mat_tables, used, v.material_id, v.uv_u, v.uv_v, static.spec_image_slots,
            float_tex_slots=static.float_tex_slots)
        bu0, bu1 = uni2(b, ps._CTR_BSDF_UV)
        w_lobe, u_rr = uni2(b, ps._CTR_BSDF_W)
        samp = msoa.sample_bsdf_soa(params, dir_view, v.gn, v.frame, bu0, bu1, w_lobe, used)
        msoa.eval_bsdf_soa(params, dir_view, samp.dir_out, v.gn, v.frame, used)
        pdf_b = msoa.pdf_bsdf_soa(params, dir_view, samp.dir_out, v.gn, v.frame, used)
        act = active & (samp.valid > 0) & (pdf_b > 0)
        return samp.dir_out, act, u_rr

    def update_stage(nxt, active, u_rr, bounce):
        """RR + live-lane bookkeeping (the reference's approximation: a
        uniform 0.8 survival)."""
        act = active & (nxt.valid > 0)
        if (bounce + 2) >= static.options.rr_depth:
            act = act & (u_rr <= 0.8)
        return act

    org, d = stage(0, "gen_primary", n, gen_primary)
    hit, gn = stage(0, "intersect", n, do_intersect, org, d, 0.0, BIG)
    active = hit.prim_id >= 0
    rows[-1]["hits"] = int(active.sum())
    v = stage(0, "shade", n, do_shade, org, d, hit, gn)
    d0 = d
    for b in range(1, bounces + 1):
        live = int(active.sum())
        if live == 0:
            break
        dl, tfar = stage(b, "nee_rays", live, nee_rays, v, b, active)
        stage(b, "occluded", live, do_occluded, v.position, dl, tfar)
        d_out, act2, u_rr = stage(b, "bsdf", live, bsdf_stage, v, b, d, active)
        ext_tfar = torch.where(act2, BIG, -1.0)
        nhit, ngn = stage(b, "intersect", live, do_intersect, v.position, d_out,
                          static.intersection_epsilon, ext_tfar)
        nv = stage(b, "shade", live, do_shade, v.position, d_out, nhit, ngn)
        act3 = stage(b, "update", live, update_stage, nv, act2, u_rr, b)
        v, d, active = nv, d_out, act3

    if probes and sc.geom.packet is not None:
        rows += _probes(scene, sc, org, d0, m=probe_rays, reps=reps)
    return rows


def _probes(scene, sc, org, d_primary, m, reps):
    """The reference's standalone traversal probes on the packet table:
    m incoherent rays (origins uniform in the table's box, numpy's
    RandomState(0)), the primary rays tiled to m (the reference tiles the
    primary origins with the last bounce's directions; here the primary
    directions), and an argsort of m random keys with its unsort."""
    static = scene.static
    device = org.x.device
    tab = sc.geom.packet
    n_tris = trs._table_n_tris(static)
    bbox = tab.bbox.cpu().numpy()
    lo, hi = bbox[:3], bbox[3:]
    rng = np.random.RandomState(0)
    o = (lo + rng.rand(m, 3).astype(np.float32) * (hi - lo)).astype(np.float32)
    dd = rng.randn(m, 3).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    o3 = V3(*(torch.from_numpy(np.ascontiguousarray(o[:, i])).to(device) for i in range(3)))
    d3 = V3(*(torch.from_numpy(np.ascontiguousarray(dd[:, i])).to(device) for i in range(3)))
    rows = []

    def probe(o_, d_):
        return pt.intersect_packet(tab, o_, d_, 0.0, BIG, n_tris=n_tris)[1]

    _, row = timed(probe, o3, d3, device=device, reps=reps)
    rows.append({"bounce": None, "stage": "probe incoherent", "rays": m, **row})
    n = org.x.shape[0]
    tile = max(1, m // n)
    oc = V3(*(c.repeat(tile) for c in org))
    dc = V3(*(c.repeat(tile) for c in d_primary))
    _, row = timed(probe, oc, dc, device=device, reps=reps)
    rows.append({"bounce": None, "stage": "probe coherent", "rays": tile * n, **row})
    keys = torch.from_numpy(rng.randint(0, 1 << 21, size=m).astype(np.int32)).to(device)

    def argsort_unsort(k):
        perm = torch.argsort(k)
        return perm, torch.empty_like(perm).index_copy_(
            0, perm, torch.arange(k.shape[0], device=k.device))

    _, row = timed(argsort_unsort, keys, device=device, reps=reps)
    rows.append({"bounce": None, "stage": "probe argsort+unsort", "rays": m, **row})
    return rows


# Bytes a lane each fused stage reads once and writes once (K1's hit 28 B,
# K2's mask 4 B, a vector row 12 B, a scalar row 4 B, the lane's int64
# stream 8 B; csrc/path_fused.cu): the first after_hit writes the whole
# vertex and reads no state, a later one reads and writes it.
FUSED_BYTES = {"primary": 16 + 28, "after_hit 0": 60 + 108, "after_hit": 136 + 104,
               "after_shadow": 104 + 36}
HBM_BYTES_PER_S = 3.35e12


def fused_split(scene, reps=20):
    """A replayed sample of a scene inside path_fused's envelope, on the
    card: rows (dicts) of the replay of the banded pass's captured sample
    by CUDA events (least and median of `reps` replays, ms), then of each
    stage of one sample in order: its kernel's device time a launch
    (event_ms, profiling.event_span_ms: the least of `reps` launches from
    a copy of the same state), its plain version's (plain_ms, three
    calls: an upper bound, gaps between its kernels included) and its
    bytes bound at 3.35 TB/s (bound_us)."""
    static, camera = scene.static, scene.device.camera
    dev = camera.sample_to_cam.device
    if dev.type != "cuda" or not path_fused.supports(static, dev) or static.options.max_depth < 1:
        raise ValueError("fused_split takes a scene inside path_fused's envelope on the card, "
                         "at a fixed depth")
    sc = ps.scene_soa_from_aos(scene)
    w, h = static.width, static.height
    n = w * h
    ys, xs = np.mgrid[0:h, 0:w]
    lanes = (torch.from_numpy(xs.ravel().astype(np.float32)).to(dev),
             torch.from_numpy(ys.ravel().astype(np.float32)).to(dev),
             torch.arange(n, dtype=torch.int64, device=dev))
    graph = banded._SampleGraph(ps._add_fused_sample, 3, {"captured": 0}, static, camera, sc,
                                *lanes, path_fused.LAUNCHES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        graph.graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    rows = [{"stage": "replay", "ms": min(times), "median_ms": statistics.median(times),
             "launches": sum(graph.launches.values()),
             "stage_launches": sum(graph.kernel_launches.values())}]
    st = torch.zeros((path_fused.N_ROWS, n), device=dev)
    seed, sample0 = 0, 0

    def kernel(k, args, s):
        path_fused.KERNELS[k](path_fused._Launch(static, camera, sc, s, lanes, seed, sample0),
                              *args)

    def plain(k, args, s):
        path_fused.PLAIN[k](static, camera, sc, s, lanes, seed, sample0, *args)

    for name, k, args in path_fused.schedule(static, sc, st):
        kind = "after_hit 0" if name == "after_hit 0" else path_fused.STAGES[k]
        rows.append({"stage": name,
                     "event_ms": event_span_ms(lambda s: kernel(k, args, s),
                                               lambda: (st.clone(),), reps=reps),
                     "plain_ms": event_span_ms(lambda s: plain(k, args, s), lambda: (st.clone(),)),
                     "bound_us": FUSED_BYTES[kind] * n / HBM_BYTES_PER_S * 1e6})
        kernel(k, args, st)
    return rows


def print_fused(rows, out=print):
    replay = rows[0]
    out(f"replay: {replay['ms']:.4f} ms least, {replay['median_ms']:.4f} median by CUDA events "
        f"({replay['launches']} K1/K2 nodes, {replay['stage_launches']} stage nodes)")
    for row in rows[1:]:
        out(f"  {row['stage']:>14}: kernel {row['event_ms'] * 1e3:8.2f} us, bound "
            f"{row['bound_us']:6.2f} us, plain {row['plain_ms'] * 1e3:9.1f} us")
    kernels = sum(row["event_ms"] for row in rows[1:])
    out(f"  stages summed {kernels:.4f} ms ({len(rows) - 1} launches)")


def per_bounce(rows):
    """The reference's table: (label, live, intersect ms, occluded ms,
    other ms) per bounce, from the stage rows."""
    table = {}
    for r in rows:
        if r["bounce"] is None:
            continue
        label = "primary" if r["bounce"] == 0 else f"bounce{r['bounce']}"
        cols = table.setdefault(label, {"live": r["live"], "intersect": 0.0,
                                        "occluded": 0.0, "other": 0.0})
        cols[COLUMNS[r["stage"]]] += r["wall_ms"]
    return [(k, v["live"], v["intersect"], v["occluded"], v["other"])
            for k, v in table.items()]


def print_rows(rows, out=print):
    for r in rows:
        if r["bounce"] is not None and r["bounce"] <= 3 and r.get("launches") is not None:
            out(f"  bounce{r['bounce']} {r['stage']}: {r['wall_ms']:.2f} ms, {device_note(r)}")
    out(f"\n{'stage':>10} {'live':>8} {'intersect':>10} {'occluded':>10} {'other':>10}")
    tot = [0.0, 0.0, 0.0]
    for name, live, ti, to, tx in per_bounce(rows):
        out(f"{name:>10} {live:>8} {ti:>9.1f}ms {to:>9.1f}ms {tx:>9.1f}ms")
        tot = [tot[0] + ti, tot[1] + to, tot[2] + tx]
    out(f"{'TOTAL':>10} {'':>8} {tot[0]:>9.1f}ms {tot[1]:>9.1f}ms "
        f"{tot[2]:>9.1f}ms   (sum {sum(tot):.1f}ms/sample)")
    for r in rows:
        if r["bounce"] is None:
            out(f"{r['stage'][len('probe '):]} {r['rays']} rays: {r['wall_ms']:.1f}ms = "
                f"{r['rays'] / (r['wall_ms'] * 1e-3) / 1e6:.2f} Mrays/s"
                + ("" if r["launches"] is None else f" ({device_note(r)})"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.profile_render",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--bounces", type=int, default=16)
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--probe-rays", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    st = scene.static
    sc = ps.scene_soa_from_aos(scene)
    print(f"{st.width}x{st.height} = {st.width * st.height} lanes, {st.n_tris} tris, "
          f"packet={'yes' if sc.geom.packet is not None else 'no'}", flush=True)
    print_rows(profile(scene, bounces=args.bounces, probes=not args.skip_probes,
                       probe_rays=args.probe_rays))
    if (path_fused.supports(st, scene.device.camera.sample_to_cam.device)
            and st.options.max_depth > 0):
        print_fused(fused_split(scene))
    return 0


if __name__ == "__main__":
    sys.exit(main())
