"""Render entry point: integrator dispatch (reference: src/render.cpp:374-394).

Counterpart of gdpt_tpu/integrators/render.py. The scene (built on the
host) is carried to `device` — the CUDA card unless the caller passes
device="cpu" — and rendered there. Only the "path" integrator is
ported: brute-force scenes through the banded loop, BVH scenes (above
128 primitives) through the packet table and the wavefront renderer.
"""

from gdpt_tpu_torch.core.dtypes import resolve_device
from gdpt_tpu_torch.scene.build import Scene, scene_to


def render(scene: Scene, spp=None, seed=0, device=None, return_stats=False):
    """Render `scene` on `device`; returns an (h, w, 3) float32 numpy
    image, and with return_stats also the number of rays traced."""
    device = resolve_device(device)
    integrator = scene.static.options.integrator
    if integrator == "path":
        from gdpt_tpu_torch.integrators import path_soa

        return path_soa.render_soa(scene_to(scene, device), spp=spp, seed=seed,
                                   return_stats=return_stats)
    raise NotImplementedError(
        f"integrator {integrator!r} is not ported yet; see ROADMAP.md")
