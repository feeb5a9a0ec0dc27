"""Plain path tracing over a RefScene.

The estimator of lajolla's `path` (src/path_tracing.h:13-348), for the
scenes the benchmark renders: Lambertian triangles lit by
triangle-mesh area lights, one-sided by their winding, a Gaussian pixel
filter sampled by Box-Muller.

- path: camera ray, then per bounce next-event estimation (a light
  picked by power, a triangle by area, a point uniformly) weighted
  against BSDF sampling by the power heuristic, a cosine-weighted bounce,
  the emitter it hits MIS-weighted, Russian roulette from rr_depth on.

Each (pixel, sample) is a lane with its own random numbers (rng.py), so
any set of pixels renders to the same values it has in a whole frame.
Lanes advance in lockstep, bounce by bounce, until every lane is done.
"""

import math

import torch

from benchmark.reference import geometry, rng
from benchmark.reference import vec as V
from benchmark.reference.scene import HARD_BOUNCE_CAP

BIG = 1e30


def primary_rays(rs, xs, ys, u0, u1):
    """Camera rays through pixels (xs, ys) at film offsets drawn from
    (u0, u1) through the Gaussian filter."""
    wh = torch.tensor([rs.width, rs.height], dtype=xs.dtype, device=xs.device)
    pixel = torch.stack([xs + u0, ys + u1], dim=-1) / wh * wh
    frac = pixel - torch.floor(pixel)
    r = rs.filter_stddev * torch.sqrt(-2.0 * torch.log(torch.clamp_min(frac[:, 0], 1e-8)))
    phi = 2.0 * math.pi * frac[:, 1]
    off = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    film = (torch.floor(pixel) + 0.5 + off) / wh
    m, c = rs.sample_to_cam, rs.cam_to_world
    px, py = film[:, 0], film[:, 1]
    pt = [m[i, 0] * px + m[i, 1] * py + m[i, 3] for i in range(4)]
    dc = V.normalize((pt[0] / pt[3], pt[1] / pt[3], pt[2] / pt[3]))
    d = V.normalize(tuple(c[i, 0] * dc[0] + c[i, 1] * dc[1] + c[i, 2] * dc[2] for i in range(3)))
    org = tuple(c[i, 3].expand(xs.shape[0]).contiguous() for i in range(3))
    return org, d


def shade(rs, o, d, t, prim, nraw):
    """The surface point of each cast: position, normal (the triangle's,
    by its winding), frame, material, light and validity. A miss reads
    triangle 0's material and light and is not valid."""
    p = torch.clamp_min(prim, 0)
    gn = V.normalize(nraw)
    return dict(pos=V.add(o, V.scale(d, t)), gn=gn, frame=V.basis(gn),
                mat=rs.tri_material[p], light=rs.tri_light[p], valid=prim >= 0)


def cast(rs, o, d, tnear, tfar):
    t, prim, n = geometry.closest(rs.geom, o, d, tnear, tfar)
    return shade(rs, o, d, t, prim, n), prim


def vwhere(c, a, b):
    out = {}
    for k in a:
        if k == "frame":
            out[k] = tuple(V.where(c, x, y) for x, y in zip(a[k], b[k]))
        elif isinstance(a[k], tuple):
            out[k] = V.where(c, a[k], b[k])
        else:
            out[k] = torch.where(c, a[k], b[k])
    return out


def emission(rs, v, view):
    ok = (v["light"] >= 0) & (V.dot(v["gn"], view) > 0)
    rad = V.take(rs.light_radiance, torch.clamp_min(v["light"], 0))
    return V.where(ok, rad, V.zeros(ok.shape[0], rad[0]))


def _frame_toward(v, din):
    t, b, n = v["frame"]
    s = torch.where(V.dot(n, din) < 0.0, -1.0, 1.0).to(n[0].dtype)
    return V.scale(t, s), V.scale(b, s), V.scale(n, s)


def lambert_eval(rs, v, din, dout):
    """(f, pdf) of the Lambertian BSDF at v from din to dout."""
    n = _frame_toward(v, din)[2]
    ok = (V.dot(v["gn"], din) >= 0) & (V.dot(v["gn"], dout) >= 0)
    val = torch.where(ok, torch.clamp_min(V.dot(n, dout), 0.0) / math.pi, 0.0)
    return V.scale(V.take(rs.albedo, torch.clamp_min(v["mat"], 0)), val), val


def lambert_sample(v, din, u0, u1):
    """A cosine-weighted direction around the normal on din's side, and
    whether din lies above the surface."""
    frame = _frame_toward(v, din)
    phi = 2.0 * math.pi * u0
    r = torch.sqrt(u1)
    local = (r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0)))
    return V.to_world(frame, local), V.dot(v["gn"], din) >= 0


def light_pdf(rs, light):
    """pmf * area pdf of a light point (area measure)."""
    lid = torch.clamp_min(light, 0)
    return rs.light_pmf[lid] * (1.0 / torch.clamp_min(rs.light_area[lid], 1e-20))


def nee(rs, v, view, lu0, lu1, lw, lsw, active):
    """Next-event estimation at v, power-heuristic weighted."""
    g = rs.geom
    n_l = rs.light_pmf.shape[0]
    lid = torch.clamp(torch.searchsorted(rs.light_cdf, lw, right=True) - 1, 0, n_l - 1)
    rows = rs.light_tri_cdf[lid]
    local = torch.clamp((rows <= lsw[:, None]).sum(dim=1) - 1, 0, rows.shape[1] - 2)
    tri = torch.clamp(rs.light_first[lid] + local, 0, g.v0.shape[0] - 1)
    v0, e1, e2 = V.take(g.v0, tri), V.take(g.e1, tri), V.take(g.e2, tri)
    a = torch.sqrt(torch.clamp(lu0, 0.0, 1.0))
    b1, b2 = 1.0 - a, a * lu1
    nl = V.normalize(V.cross(e1, e2))
    p_l = V.add(V.add(v0, V.scale(e1, b1)), V.scale(e2, b2))
    pdf_pt = 1.0 / torch.clamp_min(rs.light_area[lid], 1e-20)
    to_l = V.sub(p_l, v["pos"])
    dist = V.length(to_l)
    dl = V.scale(to_l, 1.0 / torch.clamp_min(dist, 1e-20))
    g_geo = torch.clamp_min(-V.dot(dl, nl), 0.0) / torch.clamp_min(dist * dist, 1e-20)
    p1 = rs.light_pmf[lid] * pdf_pt
    f, p2_raw = lambert_eval(rs, v, view, dl)
    zero = torch.zeros_like(lu0)
    rad = V.take(rs.light_radiance, lid)
    l_emit = V.where(V.dot(nl, V.scale(dl, -1.0)) > 0, rad, (zero, zero, zero))
    need = active & (g_geo > 0) & (p1 > 0) & (V.vmax(f) > 0) & (V.vmax(l_emit) > 0)
    tfar = torch.where(need, (1.0 - rs.eps) * dist, -1.0)
    blocked = geometry.occluded(g, v["pos"], dl, rs.eps, tfar)
    gg = g_geo * (~blocked).to(g_geo.dtype)
    p2 = p2_raw * gg
    ok = (gg > 0) & (p1 > 0) & need
    w1 = torch.where(ok, p1 * p1 / torch.clamp_min(p1 * p1 + p2 * p2, 1e-30), 0.0)
    c = V.scale(V.mul(f, l_emit), gg * w1 / torch.clamp_min(p1, 1e-30))
    return V.where(ok, c, (zero, zero, zero))


def trace_path(rs, pixel, sample, seed):
    """Radiance of one `path` sample per lane: pixel (N,) int64."""
    dt = rs.sample_to_cam.dtype
    n_iters = HARD_BOUNCE_CAP if rs.max_depth < 0 else max(rs.max_depth - 1, 0)

    def uni(bounce, site):
        return rng.uniform2(seed, pixel, bounce * rng.SITE_STRIDE + site, sample, dt)

    xs, ys = (pixel % rs.width).to(dt), (pixel // rs.width).to(dt)
    o, d = primary_rays(rs, xs, ys, *uni(0, rng.SITE_PIXEL))
    v, _ = cast(rs, o, d, 0.0, torch.full_like(xs, BIG))
    zero = torch.zeros_like(xs)
    zero3 = (zero, zero, zero)
    radiance = V.where(v["valid"], emission(rs, v, V.scale(d, -1.0)), zero3)
    tp = (zero + 1.0, zero + 1.0, zero + 1.0)
    active = v["valid"]
    bounce = 0
    while bounce < n_iters and (rs.max_depth > 0 or bool(active.any())):
        b = bounce + 1
        view = V.scale(d, -1.0)
        lu0, lu1 = uni(b, rng.SITE_LIGHT_UV)
        lw, lsw = uni(b, rng.SITE_LIGHT_W)
        radiance = V.add(radiance, V.mul(tp, nee(rs, v, view, lu0, lu1, lw, lsw, active)))
        bu0, bu1 = uni(b, rng.SITE_BSDF_UV)
        _, u_rr = uni(b, rng.SITE_BSDF_W)
        d_out, above = lambert_sample(v, view, bu0, bu1)
        f_b, pdf_b = lambert_eval(rs, v, view, d_out)
        active = active & above & (pdf_b > 0)
        nxt, _ = cast(rs, v["pos"], d_out, rs.eps, torch.where(active, BIG, -1.0))
        nxt_ok = nxt["valid"]
        dist2 = V.dot(V.sub(nxt["pos"], v["pos"]), V.sub(nxt["pos"], v["pos"]))
        g2 = torch.where(nxt_ok, torch.abs(V.dot(d_out, nxt["gn"])) / torch.clamp_min(dist2, 1e-20),
                         1.0)
        p2a = pdf_b * g2
        hit_light = nxt_ok & (nxt["light"] >= 0) & active
        l_emit = emission(rs, nxt, V.scale(d_out, -1.0))
        p1h = light_pdf(rs, nxt["light"])
        w2 = p2a * p2a / torch.clamp_min(p1h * p1h + p2a * p2a, 1e-30)
        contrib = V.scale(V.mul(V.mul(tp, f_b), l_emit), g2 * w2 / torch.clamp_min(p2a, 1e-30))
        radiance = V.add(radiance, V.where(hit_light, contrib, zero3))
        active = active & nxt_ok
        new_tp = V.scale(V.mul(tp, f_b), g2 / torch.clamp_min(p2a, 1e-30))
        if bounce + 2 >= rs.rr_depth:
            rr = torch.clamp_max(V.vmax(new_tp) / 1.0, 0.95)
            active = active & (u_rr <= rr)
            new_tp = V.scale(new_tp, 1.0 / torch.clamp_min(rr, 1e-20))
        tp = V.where(active, new_tp, tp)
        v = vwhere(active, nxt, v)
        d = V.where(active, d_out, d)
        bounce += 1
    return radiance


def render_pixels(rs, pixels, spp, seed, chunk=1 << 19):
    """Mean radiance over samples 0..spp-1 of the given pixels (N,) int64
    of a `path` frame rendered with `seed`: (N, 3) float64 on the host.
    The samples of a pixel are lanes of one batch, at most `chunk` lanes
    a batch."""
    if rs.integrator != "path":
        raise ValueError(f"the reference renders `path` only, not {rs.integrator!r}")
    n = pixels.shape[0]
    lanes = pixels.repeat(spp)
    sample = torch.arange(spp, device=pixels.device).repeat_interleave(n)
    seed = int(seed) & rng.M32
    out = torch.zeros((n * spp, 3), dtype=torch.float64)
    for lo in range(0, n * spp, chunk):
        sl = slice(lo, lo + chunk)
        out[sl] = torch.stack(trace_path(rs, lanes[sl], sample[sl], seed), dim=1).to(
            torch.float64).cpu()
    return (out.reshape(spp, n, 3).sum(0) / spp).numpy()
