"""Steady-state wavefront pool rays, the extension cast's own population.

Counterpart of capture_pool_rays in tools/wavefront_visits.py (its
`capture` and `analyze` modes replay the TPU's 1,024-lane packet walk on
the host and are not ported; see ROADMAP.md). tools/speed_of_light.py
times the walk on these rays for the packet configs' ceiling.
"""

import numpy as np
import torch

from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import REAL
from gdpt_tpu_torch.integrators import path_soa as ps


def regen(static, camera, st):
    """The next wavefront iteration's regeneration of dead lanes, as
    path_soa._wavefront_body does it, without updating `st`: (org, d,
    bounce, alive, pixel, sample) of the lanes its extension cast takes."""
    n_pix = static.width * static.height
    dead = st["alive"] <= 0
    rank = torch.cumsum(dead.to(torch.int64), dim=0) - 1
    item = (st["next_item"] + torch.where(dead, rank, 0)) & ps._M32
    fresh = dead & (item < st["total"]) & (item >= st["next_item"])
    pixel = torch.where(fresh, item % n_pix, st["pixel"])
    sample = torch.where(fresh, item // n_pix, st["sample"])
    xs = (pixel % static.width).to(REAL)
    ys = (pixel // static.width).to(REAL)
    u0, u1 = soa.uniform2(st["seed"], pixel, ps._CTR_PIXEL, sample)
    porg, pd = ps.primary_rays_soa(static, camera, xs, ys, u0, u1)
    org = soa.where(fresh, porg, st["org"])
    d = soa.where(fresh, pd, st["d"])
    bounce = torch.where(fresh, 0, st["bounce"])
    alive = fresh | (st["alive"] > 0)
    return org, d, bounce, alive, pixel, sample


def capture_pool_rays(scene, warm_chunks=3, pool=1 << 18):
    """Run the path wavefront (path_soa._wavefront_body, pool unsorted) on
    the scene's device to steady state, warm_chunks chunks of 8
    iterations over a queue of 64 samples a pixel, and return the
    post-regen rays of the next iteration: what its extension cast
    dispatches. A dict of numpy arrays: ox..dz, bounce and alive (lanes
    the queue could not refill are dead)."""
    static = scene.static
    camera = scene.device.camera
    device = camera.sample_to_cam.device
    n_pix = static.width * static.height
    sc = ps.scene_soa_from_aos(scene)
    lane_q = ps.LANE_QUANTUM
    pool = -(-pool // lane_q) * lane_q
    total = n_pix * 64
    st = ps._wavefront_state(n_pix, pool, total, 0, device)
    for _ in range(warm_chunks * 8):
        st = ps._wavefront_body(static, camera, sc, st, pool_sort=False)

    org, d, bounce, alive, _, _ = regen(static, camera, st)
    out = dict(ox=org.x, oy=org.y, oz=org.z, dx=d.x, dy=d.y, dz=d.z, bounce=bounce, alive=alive)
    return {k: np.asarray(v.cpu().numpy()) for k, v in out.items()}
