"""Plain gradient-domain path tracing over a RefScene.

The estimator of the fork's `gradpath` (its spec small_gdpt.cpp:153-352,
in lajolla src/path_tracing.h:354-1050, driven by src/render.cpp:257-369)
for the benchmark's Lambertian scenes. Per (pixel, sample) lane:

- five camera rays through the pixel and its neighbours x-1, x+1, y-1,
  y+1 on the pixel's own film randoms; an offset is valid while its
  primary hits the base's material;
- the base path bounces by cosine-weighted sampling; at each bounce an
  offset that has not merged reconnects to the base's next vertex (both
  vertices are diffuse), if that vertex is the first thing the offset
  sees along the new direction, with the geometry-ratio Jacobian
  |cos cos| / d^2 (offset) over |cos cos| / d^2 (base); once merged it
  follows the base's factors;
- every light the base path hits, the base continuing through it, adds
  one term to the brute-force primal contrib / prob and to each
  one-sided difference (offset term - base term), the offset weighted
  by prob / (prob + prob_shift * jacobian), signed so that the buffers
  estimate u[x] - u[x-1] (at x and at x-1) and likewise along y;
- Russian roulette from the throughput before the bounce, its survival
  probability folded into the base's and every offset's probability;
- beside them the NEE primal: next-event estimation and the
  BSDF-sampled light hit, power-heuristic weighted, as in
  integrators.py, which the Poisson solve takes as its data term.

Departures from the fork:

- the random-number-replay shift (src/path_tracing.h:780-959, pdf-ratio
  Jacobian) is left out: every material here is Lambertian, so an offset
  either reconnects at the base's next vertex or the base's bounce left
  the scene, ending the base path and every later term that would read
  the offset. A scene with any other material raises ValueError;
- the fork disables next-event estimation in this integrator
  (src/path_tracing.h:520) and solves on its brute-force primal; here,
  as in the port, the data term is the NEE primal and the brute-force
  primal is returned beside it;
- each light hit adds its term as it is found, where the fork multiplies
  one product out at the loop's end (src/path_tracing.h:1016-1049);
- the random numbers are the frame's own PCG3D streams (rng.py) at the
  port's use sites, drawn for the base path and shared by its offsets,
  so a sound frame agrees value for value but for the rare path that
  rounding sends another way;
- depth: a lane runs at most min(max_depth, 32) extensions (32 where
  max_depth < 0).

The lanes advance in lockstep, bounce by bounce, until every lane is
done.
"""

import numpy as np
import torch

from benchmark.reference import geometry, rng
from benchmark.reference import vec as V
from benchmark.reference.integrators import (BIG, cast, emission, lambert_eval, lambert_sample,
                                             light_pdf, nee, primary_rays, vwhere)

MAX_DEPTH_CAP = 32
# Offset pixels (x-1, x+1, y-1, y+1) and the sign of each one-sided
# difference: -1 stores base - offset, +1 offset - base.
OFFSETS = ((-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))
SIGNS = (-1.0, 1.0, -1.0, 1.0)
BUFFERS = ("primal", "primal_bf", "gx_here", "gx_next", "gy_here", "gy_next")


def full_precision():
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_lambertian(desc):
    """Raise ValueError unless every material of the description is a
    Lambertian albedo (three numbers)."""
    for i, m in enumerate(desc["materials"]):
        a = np.asarray(m)
        if a.shape != (3,) or not np.issubdtype(a.dtype, np.number):
            raise ValueError(f"the gradpath reference renders Lambertian scenes only; "
                             f"material {i} is {m!r}")


def _geom_term(p0, n0, p1, n1):
    d = V.sub(p1, p0)
    d2 = torch.clamp_min(V.dot(d, d), 1e-20)
    dn = V.scale(d, 1.0 / torch.sqrt(d2))
    return torch.abs(V.dot(dn, n1)) * torch.abs(V.dot(dn, n0)) / d2


def trace_gdpt(rs, pixel, sample, seed):
    """One gradpath sample per lane: pixel, sample (N,) int64. Returns the
    six per-lane vectors of BUFFERS."""
    dt = rs.sample_to_cam.dtype
    n_iters = MAX_DEPTH_CAP if rs.max_depth < 0 else min(rs.max_depth, MAX_DEPTH_CAP)

    def uni(bounce, site):
        return rng.uniform2(seed, pixel, bounce * rng.SITE_STRIDE + site, sample, dt)

    xs, ys = (pixel % rs.width).to(dt), (pixel // rs.width).to(dt)
    zero = torch.zeros_like(xs)
    one = zero + 1.0
    zero3, one3 = (zero, zero, zero), (one, one, one)
    u0, u1 = uni(0, rng.SITE_PIXEL)
    prim = []
    for dx, dy in ((0.0, 0.0),) + OFFSETS:
        o, d = primary_rays(rs, xs + dx, ys + dy, u0, u1)
        v, _ = cast(rs, o, d, 0.0, torch.full_like(xs, BIG))
        prim.append((v, d))
    base, base_d = prim[0]
    offs = [dict(valid=v["valid"] & (v["mat"] == base["mat"]), merged=torch.zeros_like(
        base["valid"]), v=v, d=d, contrib=one3, prob=one, jacob=one) for v, d in prim[1:]]
    radiance = V.where(base["valid"], emission(rs, base, V.scale(base_d, -1.0)), zero3)
    primal_bf = zero3
    diffs = [zero3] * 4
    contrib, prob = one3, one
    active = base["valid"]

    for k in range(n_iters + 1):
        if not bool(active.any()):
            break
        b = k + 1
        view = V.scale(base_d, -1.0)

        # A light at the base vertex: one term for the primal and each
        # difference.
        hit_light = active & (base["light"] >= 0) & (prob > 0)
        emitted = emission(rs, base, view)
        prob_c = torch.clamp_min(prob, 1e-30)
        base_term = V.mul(contrib, emitted)
        primal_bf = V.add(primal_bf, V.where(hit_light, V.scale(base_term, 1.0 / prob_c),
                                             zero3))
        for i, off in enumerate(offs):
            lit = off["valid"] & (off["merged"] | (off["v"]["light"] >= 0))
            o_emit = V.where(off["merged"], emitted,
                             emission(rs, off["v"], V.scale(off["d"], -1.0)))
            term = V.where(lit, V.scale(V.mul(off["contrib"], o_emit), off["jacob"]), zero3)
            p_shift = off["prob"] * off["jacob"]
            w = torch.where(lit, prob / torch.clamp_min(prob + p_shift, 1e-30), 1.0)
            d_i = V.scale(V.sub(term, base_term), SIGNS[i] * w / prob_c)
            diffs[i] = V.add(diffs[i], V.where(hit_light, d_i, zero3))

        # The NEE primal, then the base's bounce.
        throughput = V.scale(contrib, 1.0 / prob_c)
        lu0, lu1 = uni(b, rng.SITE_LIGHT_UV)
        lw, lsw = uni(b, rng.SITE_LIGHT_W)
        radiance = V.add(radiance, V.mul(throughput, nee(rs, base, view, lu0, lu1, lw, lsw,
                                                         active)))
        bu0, bu1 = uni(b, rng.SITE_BSDF_UV)
        _, u_rr = uni(b, rng.SITE_BSDF_W)
        d_out, above = lambert_sample(base, view, bu0, bu1)
        f_base, pdf_base = lambert_eval(rs, base, view, d_out)
        if k + 2 >= rs.rr_depth:
            rr_prob = torch.clamp_max(V.vmax(contrib) / prob_c, 0.95)
            survive = u_rr <= rr_prob
        else:
            rr_prob, survive = one, torch.ones_like(active)
        nxt, nxt_prim = cast(rs, base["pos"], d_out, rs.eps, torch.where(active, BIG, -1.0))
        nxt_ok = nxt["valid"]
        ok_base = above & (pdf_base > 0) & nxt_ok

        # The BSDF-sampled light hit of the NEE primal.
        to_nxt = V.sub(nxt["pos"], base["pos"])
        dist2 = V.dot(to_nxt, to_nxt)
        g2 = torch.abs(V.dot(d_out, nxt["gn"])) / torch.clamp_min(dist2, 1e-20)
        p2a = pdf_base * g2
        p1h = light_pdf(rs, nxt["light"])
        w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
        c2 = V.scale(V.mul(f_base, emission(rs, nxt, V.scale(d_out, -1.0))),
                     g2 * w2 / torch.clamp_min(p2a, 1e-30))
        lit = active & ok_base & (nxt["light"] >= 0)
        radiance = V.add(radiance, V.where(lit, V.mul(throughput, c2), zero3))

        # The offsets: reconnect to the base's next vertex, or follow it.
        g_base = _geom_term(base["pos"], base["gn"], nxt["pos"], nxt["gn"])
        for off in offs:
            ov, merged = off["v"], off["merged"]
            o_view = V.scale(off["d"], -1.0)
            to_next = V.sub(nxt["pos"], ov["pos"])
            dir_rec = V.scale(to_next, 1.0 / torch.clamp_min(V.length(to_next), 1e-20))
            reconnect = nxt_ok & ~merged
            tfar = torch.where(active & off["valid"] & reconnect, BIG, -1.0)
            probe = geometry.closest(rs.geom, ov["pos"], dir_rec, rs.eps, tfar)[1]
            seen = (probe >= 0) & (probe == torch.clamp_min(nxt_prim, 0)) & nxt_ok
            f_rec, pdf_rec = lambert_eval(rs, ov, o_view, dir_rec)
            g_shift = _geom_term(ov["pos"], ov["gn"], nxt["pos"], nxt["gn"])
            upd = active & off["valid"]
            valid = off["valid"] & (merged | (reconnect & seen & (pdf_rec > 0)))
            new_c = V.mul(off["contrib"], V.where(merged, f_base, f_rec))
            new_p = off["prob"] * torch.where(merged, pdf_base, pdf_rec) * rr_prob
            new_j = torch.where(merged, off["jacob"],
                                off["jacob"] * g_shift / torch.clamp_min(g_base, 1e-20))
            off.update(valid=torch.where(upd, valid, off["valid"]),
                       merged=torch.where(upd, merged | reconnect, merged),
                       v=vwhere(upd, nxt, ov), d=V.where(upd, d_out, off["d"]),
                       contrib=V.where(upd, new_c, off["contrib"]),
                       prob=torch.where(upd, new_p, off["prob"]),
                       jacob=torch.where(upd, new_j, off["jacob"]))

        ext = active & ok_base & survive
        contrib = V.where(ext, V.mul(contrib, f_base), contrib)
        prob = torch.where(ext, prob * pdf_base * rr_prob, prob)
        base = vwhere(ext, nxt, base)
        active = ext & (k + 1 <= n_iters)
        base_d = V.where(active, d_out, base_d)
    return (radiance, primal_bf, *diffs)


def assemble(gx_here, gx_next, gy_here, gy_next):
    """The backward differences the solve takes: the estimate of
    u[x] - u[x-1] made at x plus the one made at x-1 (src/render.cpp:
    340-350); (h, w, 3) arrays."""
    gx, gy = gx_here.copy(), gy_here.copy()
    gx[:, 1:] += gx_next[:, :-1]
    gy[1:] += gy_next[:-1]
    return gx, gy


def render_gradpath(rs, spp, seed, chunk=1 << 19):
    """The mean over samples 0..spp-1 of every pixel of a gradpath frame
    rendered with `seed`: a dict of the six BUFFERS and the assembled
    `gx`, `gy`, each (h, w, 3) float64 on the host. The samples of a
    pixel are lanes of one batch, at most `chunk` lanes a batch."""
    if rs.integrator != "gradpath":
        raise ValueError(f"render_gradpath renders `gradpath`, not {rs.integrator!r}")
    full_precision()
    n = rs.width * rs.height
    dev = rs.sample_to_cam.device
    pixels = torch.arange(n, device=dev)
    lanes = pixels.repeat(spp)
    sample = torch.arange(spp, device=dev).repeat_interleave(n)
    seed = int(seed) & rng.M32
    out = torch.zeros((n * spp, len(BUFFERS), 3), dtype=torch.float64)
    for lo in range(0, n * spp, chunk):
        sl = slice(lo, lo + chunk)
        vecs = trace_gdpt(rs, lanes[sl], sample[sl], seed)
        out[sl] = torch.stack([torch.stack(v, dim=1) for v in vecs], dim=1).to(
            torch.float64).cpu()
    mean = (out.reshape(spp, n, len(BUFFERS), 3).sum(0) / spp).numpy()
    bufs = {name: mean[:, i].reshape(rs.height, rs.width, 3) for i, name in enumerate(BUFFERS)}
    bufs["gx"], bufs["gy"] = assemble(bufs["gx_here"], bufs["gx_next"], bufs["gy_here"],
                                      bufs["gy_next"])
    return bufs
