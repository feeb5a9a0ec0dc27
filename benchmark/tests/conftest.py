"""The benchmark's own tests: on the CPU at tiny films through the
program's plain versions; tests marked `gpu` need the card and skip
without one. Run from the repository's root:

    python -m pytest benchmark/tests -q               # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu        # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("cbox_512_path.frames_256spp",)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def load_cell(name, root=ROOT):
    from benchmark.harness import spec

    return spec.Cell(spec.load_spec(root), name, root)


def cpu_run(cell, seed=1234567891234, seconds=0.2, trace=False, film=16, frame_fn=None, spp=1):
    """session.run on the CPU at a tiny film and spp samples a frame (the
    cell's own where None; one keeps a 256-spp cell's frames, profiled
    ones too, well under a second here): (result, stdout, stderr)."""
    import io
    import time

    from benchmark.harness import session

    if spp is not None:
        cell.traffic = dict(cell.traffic, spp_per_frame=spp)
    out, err = io.StringIO(), io.StringIO()
    res = session.run(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                      film=(film, film), frame_fn=frame_fn, out=out, err=err)
    return res, out.getvalue(), err.getvalue()
