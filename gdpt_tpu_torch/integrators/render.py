"""Render entry point: integrator dispatch (reference: src/render.cpp:374-394).

Counterpart of gdpt_tpu/integrators/render.py. The scene (built on the
host) is carried to `device` — the CUDA card unless the caller passes
device="cpu" — and rendered there. Ported integrators: "path" and
"gradpath" (gradient-domain path tracing with the screened-Poisson
reconstruction). Brute-force scenes go through the banded loops, BVH
scenes (above 128 primitives) through the packet table and the wavefront
renderers; packet_wide and packet_dual choose the table's width and the
walk: the solo kernel K3, or on a 16-wide table the dual kernel K4.
"""

from gdpt_tpu_torch.core.dtypes import resolve_device
from gdpt_tpu_torch.scene.build import Scene, scene_to


def render(scene: Scene, spp=None, seed=0, device=None, return_stats=False,
           packet_wide=32, packet_dual=False, return_aux=False):
    """Render `scene` on `device`; returns an (h, w, 3) float32 numpy
    image (for "gradpath" the reconstruction), with return_aux ("gradpath"
    only) also the dict of its primal, primal_bf, gx and gy images, and
    with return_stats also the number of rays traced. packet_dual=True
    needs packet_wide=16 and raises ValueError otherwise."""
    device = resolve_device(device)
    integrator = scene.static.options.integrator
    walk = dict(packet_wide=packet_wide, packet_dual=packet_dual)
    if return_aux and integrator != "gradpath":
        raise ValueError(f"return_aux: integrator {integrator!r} has no auxiliary buffers")
    if integrator == "path":
        from gdpt_tpu_torch.integrators import path_soa

        return path_soa.render_soa(scene_to(scene, device), spp=spp, seed=seed,
                                   return_stats=return_stats, **walk)
    if integrator == "gradpath":
        from gdpt_tpu_torch.integrators import gdpt_soa

        if not gdpt_soa.supports_soa_gdpt(scene):
            raise NotImplementedError(
                "gradpath: this scene is outside the SoA material envelope and the "
                "per-ray gradient-domain integrator is not ported; see ROADMAP.md")
        return gdpt_soa.render_gradpath_soa(scene_to(scene, device), spp=spp, seed=seed,
                                            return_aux=return_aux,
                                            return_stats=return_stats, **walk)
    raise NotImplementedError(
        f"integrator {integrator!r} is not ported yet; see ROADMAP.md")
