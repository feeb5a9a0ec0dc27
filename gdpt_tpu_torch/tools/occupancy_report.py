"""Measured wavefront occupancy and throughput: the banded loop against the
sample-regeneration pool, per integrator.

Counterpart of tools/occupancy_report.py: one JSON line per (scene,
integrator, mode) with the reference's keys (scene, integrator, mode, spp,
wall_s, Mrays, spp_per_s, mean; the wavefront rows also occupancy, the
mean live-lane fraction per iteration, and iterations) and the traced
rays. The mode is the renderers' wavefront= argument, as the reference's
is GDPT_WAVEFRONT: "banded" passes False, "wavefront" None, the
renderers' default, which takes the lane pool for BVH scenes and the
banded loop for brute-force ones, as the reference's does. Only a row
whose render ran the pool carries occupancy and iterations (the
reference's brute-force rows carry those of an earlier render). Scenes
with integrator "volpath" take render_volpath_soa; the others path_soa.render_soa (path) and
gdpt_soa.render_gradpath_soa (gradpath). The scene's packet table is
built before the first timed render.

    python -m gdpt_tpu_torch.tools.occupancy_report [sponza|disney|volpath6|both|FILE]
        [--spp-path N] [--spp-gdpt N] [--integ path|gradpath|volpath]
        [--mode banded|wavefront] [--width W --height H] [--device cpu]

The reference's three scenes are its files; here each name takes the
stand-in of tools/stand_ins.py: sponza icosphere_box, disney
material_box_bvh, volpath6 volpath_grid6. A scene file or a preset name is
taken as given.
"""

import argparse
import json
import sys
import time

import numpy as np

from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, volpath_soa
from gdpt_tpu_torch.tools import stand_ins

SCENES = {"sponza": "icosphere_box", "disney": "material_box_bvh", "volpath6": "volpath_grid6"}


def run(scene, name, spp_path=2, spp_gdpt=1, integ_only=None, mode_only=None, out=print):
    """Rows (dicts) of every (integrator, mode) of a scene on its device,
    each printed by `out` as a JSON line as it completes."""
    if scene.static.options.integrator == "volpath":
        combos = (("volpath", spp_path, volpath_soa.render_volpath_soa,
                   volpath_soa._vol_wavefront_accum),)
    else:
        combos = (("path", spp_path, path_soa.render_soa, path_soa.render_soa_wavefront),
                  ("gradpath", spp_gdpt, gdpt_soa.render_gradpath_soa,
                   gdpt_soa._gdpt_wavefront_accum))
    path_soa.scene_soa_from_aos(scene)
    rows = []
    for integ, spp, fn, wf in combos:
        if integ_only and integ != integ_only:
            continue
        for mode in ("banded", "wavefront"):
            if mode_only and mode != mode_only:
                continue
            wf.last_iters = 0
            t0 = time.perf_counter()
            out_ = fn(scene, spp=spp, seed=0, return_stats=True,
                      wavefront=None if mode == "wavefront" else False)
            img, rays = out_[0], out_[-1]
            dt = time.perf_counter() - t0
            row = {
                "scene": name, "integrator": integ, "mode": mode,
                "spp": spp, "wall_s": round(dt, 2),
                "Mrays": round(rays / dt / 1e6, 3),
                "spp_per_s": round(spp / dt, 4),
                "mean": round(float(np.asarray(img).mean()), 5),
                "rays": rays,
            }
            if wf.last_iters:
                row["occupancy"] = round(wf.last_occupancy, 4)
                row["iterations"] = wf.last_iters
            rows.append(row)
            out(json.dumps(row))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.tools.occupancy_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="both",
                    help="sponza, disney, volpath6, both, a preset or a scene file")
    ap.add_argument("--spp-path", type=int, default=2)
    ap.add_argument("--spp-gdpt", type=int, default=1)
    ap.add_argument("--integ", default=None, choices=("path", "gradpath", "volpath"))
    ap.add_argument("--mode", default=None, choices=("banded", "wavefront"))
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    refused = stand_ins.refuse_without_card(args.device, ap.prog)
    if refused is not None:
        return refused
    names = list(SCENES) if args.which == "both" else [args.which]
    for name in names:
        scene, info = stand_ins.load(SCENES.get(name, name), args.width, args.height,
                                     device=args.device)
        stand_ins.describe(info, out=lambda s: print(s, file=sys.stderr))
        run(scene, name, spp_path=args.spp_path, spp_gdpt=args.spp_gdpt,
            integ_only=args.integ, mode_only=args.mode, out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
