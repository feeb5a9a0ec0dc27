"""The control and the faults that `correct` has to catch.

Each is a frame function for session.run(frame_fn=...), put in the
program's place:

- control: the plain reference computed in bfloat16, one precision below
  the scene's float32;
- stale: every frame returns the first frame's output (a step that
  returns its state unchanged);
- half: half of each frame's work left out and the mean taken over the
  rest (half the samples of a pixel; at one sample a pixel, every second
  pixel copied from its neighbour);
- altered: each frame's answer altered where it is produced (every value
  scaled by 1.01);
- band: the same alteration confined to one row of each frame (a fault
  of one band of lanes, under 0.2 % of a 512-row frame).

    python -m benchmark.harness.controls <workload> <frame> <seed> [<seed> ...]

runs <frame> (control, one of FAULTS, or program) in a short window at
the cell's own size on the card and prints each run's compared numbers:
the control's, a fault's or the program's readings.
"""

import io
import sys
import time

import numpy as np
import torch

from benchmark.reference import integrators, scene


def control(ctx, spp, seed):
    cfg, device = ctx["cfg"], ctx["device"]
    if "control_scene" not in ctx:
        from benchmark.harness import session

        ctx["control_scene"] = scene.build(session.describe(cfg, ctx["root"]), device,
                                           torch.bfloat16)
    rs = ctx["control_scene"]
    pixels = torch.arange(rs.width * rs.height, device=device)
    img = integrators.render_pixels(rs, pixels, spp, seed).reshape(rs.height, rs.width, 3)
    return img.astype(np.float32), 0.0


def stale(ctx, spp, seed):
    if "first" not in ctx:
        ctx["first"] = ctx["program"](spp, seed)
    return ctx["first"]


def half(ctx, spp, seed):
    if spp > 1:
        return ctx["program"](spp // 2, seed)
    img, rays = ctx["program"](spp, seed)
    img = np.array(img)
    img[:, 1::2] = img[:, 0:img.shape[1] - 1:2]
    return img, rays


def altered(ctx, spp, seed):
    img, rays = ctx["program"](spp, seed)
    return np.asarray(img) * np.float32(1.01), rays


def band(ctx, spp, seed):
    img, rays = ctx["program"](spp, seed)
    img = np.array(img)
    img[img.shape[0] // 2] *= np.float32(1.01)
    return img, rays


FAULTS = {"stale": stale, "half": half, "altered": altered, "band": band}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from benchmark.harness import session, spec

    cell = spec.Cell(spec.load_spec(), argv[0])
    frame_fn = {"control": control, "program": None, **FAULTS}[argv[1]]
    for seed in argv[2:]:
        t0 = time.perf_counter()
        res = session.run(cell, int(seed), 0.5, False, t0, frame_fn=frame_fn,
                          out=io.StringIO(), err=io.StringIO())
        print(f"{argv[1]} {cell.name} seed {seed}: correct {res['correct']} "
              f"{ {k: c['value'] for k, c in res['compared'].items()} } "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
