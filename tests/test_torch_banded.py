"""The banded render loop that the SoA renderers share
(integrators/banded.py), on the CPU: the route rule as path, gradpath and
volpath each take it, and the loop's program spans on a volpath render.
"""

import sys

import numpy as np
import pytest

from gdpt_tpu_torch.integrators import banded, gdpt_soa, path_soa, render, volpath_soa
from gdpt_tpu_torch.parallel import sharding
from gdpt_tpu_torch.scene import presets
from gdpt_tpu_torch.utils import profiling

from test_torch_tracing import FRAME_SPANS, registry  # noqa: F401 (fixture)

# Each renderer, its 8x8 scene (brute force, or BVH with force_bvh=True)
# and the name of its wavefront renderer in its module.
KINDS = {
    "path": (path_soa.render_soa, lambda **kw: presets.cornell_box(8, 8, spp=1, max_depth=3,
                                                                   **kw),
             "render_soa_wavefront"),
    "gradpath": (gdpt_soa.render_gradpath_soa,
                 lambda **kw: presets.cornell_box(8, 8, spp=1, max_depth=3,
                                                  integrator="gradpath", **kw),
                 "_gdpt_wavefront_accum"),
    "volpath": (volpath_soa.render_volpath_soa,
                lambda **kw: presets.volpath_scene(version=6, width=8, height=8, spp=1,
                                                   max_depth=3, **kw),
                "_vol_wavefront_accum"),
}


class _Took(Exception):
    """Raised in place of a route's work: its args name the route."""


@pytest.mark.parametrize("kind", KINDS)
def test_the_route_rule(kind, monkeypatch):
    """Through each renderer: a resumed, checkpointed or sharded render
    takes the banded loop on a brute-force and on a BVH scene alike, and
    with wavefront=True raises ValueError; wavefront=None takes the
    banded loop on a brute-force scene and the wavefront pool on a BVH
    one (but for a work queue past 2^32); True and False pick one."""
    render_fn, scene_of, wavefront_fn = KINDS[kind]

    def took(route):
        def run(*args, **kw):
            raise _Took(route)
        return run

    monkeypatch.setattr(banded, "loop", took("banded"))
    monkeypatch.setattr(sys.modules[render_fn.__module__], wavefront_fn, took("wavefront"))
    brute, bvh = scene_of(), scene_of(force_bvh=True)
    assert brute.static.use_brute_force and not bvh.static.use_brute_force
    mesh = sharding.make_mesh(["cpu"] * 2)

    def route(scene, **kw):
        with pytest.raises(_Took) as got:
            render_fn(scene, spp=2, seed=1, **kw)
        return got.value.args[0]

    for scene in (brute, bvh):
        for kw in (dict(start_sample=1), dict(init_acc=np.zeros(1)),
                   dict(on_chunk=lambda acc, done: None), dict(mesh=mesh)):
            assert route(scene, **kw) == "banded", kw
            with pytest.raises(ValueError, match="the banded loop; wavefront=True cannot"):
                render_fn(scene, spp=2, seed=1, wavefront=True, **kw)
    assert route(brute) == "banded" and route(bvh) == "wavefront"
    assert route(brute, wavefront=True) == "wavefront"
    assert route(bvh, wavefront=False) == "banded"
    assert not banded.route(None, bvh.static, 2 ** 31, 2, 0, None, None, None)


def test_a_volpath_render_opens_the_loop_spans(registry):
    """A 12x12 grid-medium volpath frame of one pass through render.render:
    its banded loop opens the loop spans as often as a path frame's
    (test_torch_tracing.FRAME_SPANS): the lane columns and their copy,
    the scene's copy and view, one pass and its wait, the read-back and
    the overflow check, the host's sums and the image."""
    scene = presets.volpath_scene(version=6, width=12, height=12, spp=2, max_depth=4,
                                  hetero=True)
    assert scene.static.use_brute_force
    img = render.render(scene, seed=1, device="cpu")
    assert img.shape == (12, 12, 3) and np.isfinite(img).all()
    names = ("render.frame", "render.scene", "render.lanes", "render.pass", "render.wait",
             "render.readback", "render.image")
    assert {n: profiling.span_stats(n)["calls"] for n in names} == \
        {n: FRAME_SPANS[n] for n in names}
