"""AOV / debug integrators (reference: src/render.cpp:15-72).

Counterpart of gdpt_tpu/integrators/aux.py as one batched pass: one
primary ray per pixel center for the whole image, one closest-hit cast
through traverse_soa.intersect_soa_gn (K1 for brute-force scenes, K3 for
BVH scenes; K4 with packet_dual=True) and path_soa.shade_hit for the
vertex. The AOV kind selects what is written: depth, shading normal,
mean curvature, ray differential (radius, spread) or mipmap level.
Where the primary ray misses, the pixel is 0; the image is not
NaN-filtered, as the reference's is not.
"""

import numpy as np
import torch

from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.core.dtypes import BIG, REAL
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.scene import textures as tex
from gdpt_tpu_torch.scene.build import Scene

AUX_KINDS = ("depth", "shading_normal", "mean_curvature", "ray_differential",
             "mipmap_level")


def render_aux(scene: Scene, kind: str, packet_wide=32, packet_dual=False, **cast):
    """The AOV image of `kind` for a scene on its device: an (h, w, 3)
    float32 numpy array. packet_wide, packet_dual and **cast (two_phase,
    packet_sort, premerge, entry_k, packet, max_table_mb) pick a BVH
    scene's table and walk, as in path_soa.render_soa."""
    if kind not in AUX_KINDS:
        raise ValueError(f"unknown aux integrator {kind}")
    static = scene.static
    w, h = static.width, static.height
    sc = ps.scene_soa_from_aos(scene, packet_wide, packet_dual, **cast)
    camera = scene.device.camera
    device = camera.sample_to_cam.device
    ys, xs = np.mgrid[0:h, 0:w]
    xs_d = torch.as_tensor(xs.ravel(), dtype=REAL, device=device)
    ys_d = torch.as_tensor(ys.ravel(), dtype=REAL, device=device)
    # The pixel center: (x + 0.5) / w, scaled back by w and warped through
    # the filter, in the reference's order (gdpt_tpu/scene/camera.py:55-60).
    org, d = ps.primary_rays_soa(static, camera, xs_d, ys_d, 0.5, 0.5)
    zero = torch.zeros_like(xs_d)
    spread = torch.full_like(xs_d, 0.25 / max(w, h))  # reference: src/ray.h:36-38
    hit, gn_raw = trs.intersect_soa_gn(static, sc.geom, org, d, 0.0, BIG)
    v = ps.shade_hit(static, sc, org, d, hit, gn_raw, ray_radius=zero, ray_spread=spread)
    if kind == "depth":
        p = v.position - org
        dist = torch.sqrt(p.x * p.x + p.y * p.y + p.z * p.z)
        color = (dist, dist, dist)
    elif kind == "shading_normal":
        color = tuple(v.frame.n)
    elif kind == "mean_curvature":
        color = (v.mean_curv,) * 3
    elif kind == "ray_differential":
        color = (v.radius, spread, zero)
    else:
        # The mip level the reflectance slot would fetch
        # (reference: src/render.cpp:45-62).
        desc = tex.gather_desc(scene.device.materials.refl,
                               torch.clamp_min(v.material_id, 0).long())
        pool = scene.device.pool3
        w0 = pool.level_w[desc.img_id.long(), 0].to(REAL)
        h0 = pool.level_h[desc.img_id.long(), 0].to(REAL)
        scaled = torch.maximum(w0, h0) * torch.maximum(desc.uscale, desc.vscale) * v.fp
        level = torch.log2(torch.clamp_min(scaled, 1e-8))
        level = torch.where(desc.kind == tex.TEX_IMAGE, level, 0.0)
        color = (level,) * 3
    valid = v.valid > 0
    img = torch.stack([torch.where(valid, c, 0.0) for c in color], dim=-1)
    return img.reshape(h, w, 3).cpu().numpy()
