"""Command-line renderer, counterpart of gdpt_tpu/cli.py.

Replaces reference: src/main.cpp:
  python -m gdpt_tpu_torch [options] scene1.xml [scene2.xml ...]

Options:
  -o <file>    override the output filename from the scene file
               (.exr, .pfm, or an LDR format when Pillow is installed)
  -t <n>       kept for lajolla CLI compatibility (ignored: the device
               owns the render)
  --spp <n>    override samples per pixel
  --seed <s>   the render's seed
  --device     cuda (the default) or cpu; the reference's --platform
               named a jax platform
  --checkpoint-every <n>  write accumulator checkpoints every n spp to
               <output>.ckpt.npz, and resume from one found there
  --profile <dir>  write a torch.profiler Chrome trace of each render
               to this directory
"""

import argparse
import contextlib


def main(argv=None):
    """Render each scene file of `argv` (sys.argv when None) and write its
    image; returns [(scene, image), ...], one pair a file, for callers in
    the same process."""
    ap = argparse.ArgumentParser(prog="gdpt_tpu_torch")
    ap.add_argument("scenes", nargs="+", help="Mitsuba-dialect XML scene files")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-t", "--threads", type=int, default=None,
                    help="ignored (kept for lajolla CLI compatibility)")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace to this directory")
    args = ap.parse_args(argv)

    from gdpt_tpu_torch.core import image as gimage
    from gdpt_tpu_torch.core.dtypes import resolve_device
    from gdpt_tpu_torch.integrators import render as R
    from gdpt_tpu_torch.scene import parser
    from gdpt_tpu_torch.utils import checkpoint, profiling

    device = resolve_device(args.device)
    results = []
    for scene_file in args.scenes:
        print(f"Parsing & constructing scene {scene_file}.")
        with profiling.timer() as t_parse:
            scene, out_name = parser.parse_scene(scene_file)
        print(f"Done. Took {t_parse():.5f} seconds.")
        out = args.output or out_name
        print(f"Rendering on {device}...")
        trace = profiling.device_trace(args.profile) if args.profile else contextlib.nullcontext()
        with trace, profiling.timer() as t_render:
            if args.checkpoint_every:
                img = checkpoint.render_with_checkpoints(
                    scene, spp=args.spp, seed=args.seed, every=args.checkpoint_every,
                    path=out + ".ckpt.npz", device=device)
            else:
                img = R.render(scene, spp=args.spp, seed=args.seed, device=device)
        print(f"Done. Took {t_render():.5f} seconds.")
        with profiling.timer() as t_write:
            gimage.imwrite(out, img)
        print(f"Wrote {out}. Took {t_write():.5f} seconds.")
        results.append((scene, img))
    return results
