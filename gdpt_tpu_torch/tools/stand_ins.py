"""Scenes and command-line plumbing shared by the stage profilers and the
cast A/B tools (profile_render, profile_wavefront, profile_nee,
trace_decompose, occupancy_report, ab_dual_kernel, ab_wide_kernel,
chain_sweep, occl_ab).

The reference's tools default to its scene files, which are not in the
repository. Each tool here takes a scene file or the name of a scene the
port builds in code; a preset names the reference scene it stands in for,
as the bench's rows do (bench.py `stands_in_for`). PRESETS is where those
scenes are defined: the bench builds its code-built configs from it.
"""

import sys
from typing import Callable, NamedTuple, Optional

import torch

from gdpt_tpu_torch.core.dtypes import resolve_device


class Preset(NamedTuple):
    build: Callable            # (width, height, spp, integrator=...) -> host scene
    stands_in_for: Optional[str]


def _cbox(w, h, spp, integrator="path"):
    from gdpt_tpu_torch.scene import presets

    return presets.cornell_box(w, h, spp, integrator=integrator, max_depth=6)


def _icosphere_box(w, h, spp, integrator="path"):
    from gdpt_tpu_torch.scene import presets

    return presets.icosphere_box(w, h, spp, integrator=integrator)


def _material_box_bvh(w, h, spp, integrator="path"):
    from gdpt_tpu_torch.scene import presets

    return presets.material_box(w, h, spp, bvh=True, integrator=integrator, max_depth=8,
                                image_px=1024, env_px=512)


def _volpath_grid6(w, h, spp):
    from gdpt_tpu_torch.scene import presets

    return presets.volpath_scene(
        version=6, width=w, height=h, spp=spp, g=0.6, with_diffuse_sphere=True,
        density=presets.medium_grid(64, 3, 0.8), albedo=presets.albedo_grid(64, 4))


PRESETS = {
    "cbox": Preset(_cbox, None),
    "icosphere_box": Preset(
        _icosphere_box, "sponza/sponza.xml (icospheres of level 7 and 6 in the Cornell "
        "box, 409,612 triangles, for sponza's 262k)"),
    "material_box_bvh": Preset(
        _material_box_bvh, "disney_bsdf_test/disney_bsdf.xml (every material kind, image "
        "textures and an image envmap, the icosphere balls; depth cut to 8)"),
    "volpath_grid6": Preset(
        _volpath_grid6, "volpath_test/volpath_test6.xml (a seeded 64^3 chromatic density "
        "grid, HG g = 0.6, the diffuse sphere)"),
}


def load(scene, width=None, height=None, spp=4, device=None):
    """(scene on `device`, description dict) for a preset name (512x512
    unless width and height are given) or a scene file (width and height
    override its film where given)."""
    from gdpt_tpu_torch.scene import parser
    from gdpt_tpu_torch.scene.build import scene_to

    device = resolve_device(device)
    if scene in PRESETS:
        p = PRESETS[scene]
        host = p.build(width or 512, height or 512, spp)
        info = {"scene": scene, "stands_in_for": p.stands_in_for}
    else:
        host = parser.parse_scene(scene, width=width, height=height)[0]
        info = {"scene": scene}
    s = host.static
    info.update(width=s.width, height=s.height, tris=s.n_tris, spheres=s.n_spheres,
                brute_force=bool(s.use_brute_force))
    return scene_to(host, device), info


def describe(info, out=print):
    line = (f"scene {info['scene']}: {info['width']}x{info['height']}, {info['tris']} tris, "
            f"{info['spheres']} spheres, {'brute force' if info['brute_force'] else 'BVH'}")
    if info.get("stands_in_for"):
        line += f"; stands in for {info['stands_in_for']}"
    out(line)


def add_arguments(ap, scene):
    """The arguments every tool shares: a scene (preset or file), its film
    and the device."""
    ap.add_argument("scene", nargs="?", default=scene,
                    help=f"a scene file or one of {', '.join(PRESETS)} (default {scene})")
    ap.add_argument("--width", type=int, default=None, help="a preset's 512 or the file's")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")


def refuse_without_card(device, prog):
    """2, after one error line on stderr, where no device was asked for
    and there is no card; else None."""
    if device is None and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is available; pass --device cpu to run the plain "
              "PyTorch versions", file=sys.stderr)
        return 2
    return None
