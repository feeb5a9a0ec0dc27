"""A/B: K3 on the 32-wide packet table against K3 on the 16-wide one.

Counterpart of tools/ab_wide_kernel.py: the same morton-sorted rays (the
captured wavefront pool's, and speed_of_light._harvest_rays' bounce and
shadow rays) cast by packet_kernels.trace_packets over both tables of the
scene, after _check_equal has held both tables' hits equal (equal hit
masks; a differing prim only on a tie at equal t). Chained and timed as
ab_dual_kernel times its casts.

    python -m gdpt_tpu_torch.tools.ab_wide_kernel [scene] [--pool N]
        [--harvest N] [--width W --height H] [--device cpu]

scene: a scene file or a preset of tools/stand_ins.py (default
icosphere_box, the stand-in for the reference's sponza).
"""

import argparse
import json
import sys

import numpy as np

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import traverse_soa as trs
from gdpt_tpu_torch.integrators import path_soa as ps
from gdpt_tpu_torch.tools import stand_ins
from gdpt_tpu_torch.tools.ab_dual_kernel import CHAIN_K, ray_sets, summary, timed_row, walk

DEFAULT_SCENE = "icosphere_box"


def _check_equal(tab16, tab32, packed, n, any_hit=False, n_tris=None):
    """The reference's check: both tables give the same hit mask, and
    where the closest hit's prim differs, the same t (coplanar duplicate
    geometry ties at equal t, and the winner depends on traversal order)."""
    a = pk.trace_packets(tab16, *packed, n_tris=n_tris, any_hit=any_hit)
    b = pk.trace_packets(tab32, *packed, n_tris=n_tris, any_hit=any_hit)
    pa = a[1].cpu().numpy().reshape(-1)[:n]
    pb = b[1].cpu().numpy().reshape(-1)[:n]
    if any_hit:
        assert ((pa >= 0) == (pb >= 0)).all(), "wide any-hit mismatch"
    else:
        ta = a[0].cpu().numpy().reshape(-1)[:n]
        tb = b[0].cpu().numpy().reshape(-1)[:n]
        good = pa >= 0
        np.testing.assert_allclose(ta[good], tb[good], rtol=1e-6, atol=1e-6)
        diff = pa != pb
        assert ((pa >= 0) == (pb >= 0)).all(), "wide hit-mask mismatch"
        if diff.any():
            assert np.allclose(ta[diff], tb[diff], rtol=1e-6), \
                f"wide prim mismatch beyond ties: {diff.sum()}"


def ab(scene, pool=1 << 18, harvest=1 << 19, k=CHAIN_K):
    """Rows (dicts) of K3 on the 16- and the 32-wide table per ray set:
    the pool's and the shadow rays' hits held equal first (_check_equal),
    as the reference does."""
    device = scene.device.camera.sample_to_cam.device
    tab16 = ps.scene_soa_from_aos(scene, wide=16).geom.packet
    sc32 = ps.scene_soa_from_aos(scene, wide=32)
    tab32 = sc32.geom.packet
    if tab16 is None or tab32 is None:
        raise ValueError("ab_wide_kernel needs a scene with packet tables")
    n_tris = trs._table_n_tris(scene.static)
    rows = [{"label": "table", "rows16": int(tab16.table.shape[0]),
             "rows32": int(tab32.table.shape[0])}]
    for name, (packed, n, any_hit) in ray_sets(scene, sc32, tab16, pool, harvest).items():
        if name != "bounce":
            _check_equal(tab16, tab32, packed, n, any_hit=any_hit, n_tris=n_tris)
        for width, tab in ((16, tab16), (32, tab32)):
            rows.append(timed_row(f"{name}_{width}", walk(tab, n_tris, any_hit), packed, n,
                                  device, k))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.ab_wide_kernel",
                                 description=__doc__.splitlines()[0])
    stand_ins.add_arguments(ap, DEFAULT_SCENE)
    ap.add_argument("--pool", type=int, default=1 << 18)
    ap.add_argument("--harvest", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    scene, info = stand_ins.load(args.scene, args.width, args.height, device=args.device)
    stand_ins.describe(info)
    rows = ab(scene, pool=args.pool, harvest=args.harvest)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(summary(args.scene, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
