"""The control and the faults that `correct` has to catch in `gradpath`
cells.

Each is a frame function for session.run(frame_fn=...), put in the
program's place. Beside controls.FAULTS (stale, half, altered, band):

- control: the plain gradient-domain reference rendered in bfloat16, one
  precision below the scene's float32, and solved by the reference's
  float64 solve;
- mix: each value moved 1 % toward the mean of its four neighbours (the
  border's missing neighbours taken as the value itself): the frame's
  mean stays about where it was, its local differences shrink, as a
  fault in the gradients would shrink them.

    python -m benchmark.harness.controls_gradpath <workload> <frame> <seed> [<seed> ...]

runs <frame> (control, mix, one of controls.FAULTS, or program) in a
short window at the cell's own size on the card and prints each run's
compared numbers.
"""

import io
import sys
import time

import numpy as np
import torch

from benchmark.harness import controls


def control(ctx, spp, seed):
    from benchmark.checks import gradpath as check
    from benchmark.harness import session

    cfg = ctx["cfg"]
    desc = session.describe(cfg, ctx["root"])
    ref = check.reference_frames(desc, cfg, [(0, seed, None)], spp, ctx["device"],
                                 torch.bfloat16)[0]
    return ref.astype(np.float32), 0.0


def mix(ctx, spp, seed):
    img, rays = ctx["program"](spp, seed)
    img = np.asarray(img, np.float32)
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    near = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]) * np.float32(0.25)
    return img + np.float32(0.01) * (near - img), rays


FAULTS = {**controls.FAULTS, "mix": mix}


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
