"""small_gdpt: the reference's standalone GDPT prototype, on the card.

Counterpart of examples/small_gdpt_tpu.py, which reproduces the fork's own
small_gdpt.cpp through the framework: smallpt's sphere box (walls as huge
spheres, a mirror and a glass ball, a sphere light under the ceiling)
rendered by the gradient-domain integrator (integrators/gdpt.py's
render_gradpath, the per-ray oracle) and reconstructed by the
screened-Poisson solve, written as the prototype's four PFMs: image.pfm
(the primal), image_dx.pfm and image_dy.pfm (|gradients|) and the
reconstruction.

    python -m gdpt_tpu_torch.examples.small_gdpt [spp] [--out image.pfm]
        [--width 256] [--height 192] [--device cuda|cpu]

Renders on the card unless --device cpu is given; without a card it raises.
"""

import argparse

import numpy as np

from gdpt_tpu_torch.core import image as gimage
from gdpt_tpu_torch.core import transform as xf
from gdpt_tpu_torch.integrators import gdpt
from gdpt_tpu_torch.scene import build
from gdpt_tpu_torch.scene import model as M


def smallpt_scene(width=256, height=192, spp=16):
    """The classic smallpt sphere configuration (small_gdpt.cpp:60-69, the
    public smallpt scene)."""
    def diffuse(color):
        return M.Lambertian(np.asarray(color))

    materials = [
        diffuse([0.75, 0.25, 0.25]),   # left wall
        diffuse([0.25, 0.25, 0.75]),   # right wall
        diffuse([0.75, 0.75, 0.75]),   # back/floor/ceiling
        M.DisneyMetal(base_color=np.array([0.999, 0.999, 0.999]), roughness=0.02),
        M.RoughDielectric(roughness=0.02, eta=1.5),
        diffuse([0.0, 0.0, 0.0]),      # light body
    ]
    spheres = [
        (1e5, [1e5 + 1, 40.8, 81.6], 0, -1),     # left
        (1e5, [-1e5 + 99, 40.8, 81.6], 1, -1),   # right
        (1e5, [50, 40.8, 1e5], 2, -1),           # back
        (1e5, [50, 1e5, 81.6], 2, -1),           # bottom
        (1e5, [50, -1e5 + 81.6, 81.6], 2, -1),   # top
        (16.5, [27, 16.5, 47], 3, -1),           # mirror
        (16.5, [73, 16.5, 78], 4, -1),           # glass
        (600.0, [50, 681.6 - 0.27, 81.6], 5, 0),  # light
    ]
    shapes = [M.Sphere(center=np.asarray(c, np.float64), radius=r, material_id=m,
                       area_light_id=light)
              for r, c, m, light in spheres]
    lights = [M.DiffuseAreaLight(shape_id=7, intensity=np.full(3, 12.0))]
    cam_pos = np.array([50.0, 50.0, 295.6])
    cam_dir = np.array([0.0, -0.042612, -1.0])
    cam_dir /= np.linalg.norm(cam_dir)
    cam = M.Camera(
        cam_to_world=xf.look_at(cam_pos, cam_pos + cam_dir, [0, 1, 0]),
        fov=2 * np.degrees(np.arctan(0.5135 / 2 * (width / height))),
        width=width,
        height=height,
    )
    opts = M.RenderOptions(integrator="gradpath", samples_per_pixel=spp, max_depth=8)
    return build.build_scene(cam, materials, shapes, lights, options=opts)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gdpt_tpu_torch.examples.small_gdpt")
    ap.add_argument("spp", nargs="?", type=int, default=16)
    ap.add_argument("--out", default="image_poisson.pfm")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    scene = smallpt_scene(args.width, args.height, spp=args.spp)
    recon, aux = gdpt.render_gradpath(scene, return_aux=True, device=args.device)
    # The prototype's set of images (small_gdpt.cpp:551-562).
    gimage.write_pfm("image.pfm", aux["primal"])
    gimage.write_pfm("image_dx.pfm", np.abs(aux["gx"]))
    gimage.write_pfm("image_dy.pfm", np.abs(aux["gy"]))
    gimage.write_pfm(args.out, recon)
    print(f"wrote image.pfm, image_dx.pfm, image_dy.pfm, {args.out}")
    return recon, aux


if __name__ == "__main__":
    main()
