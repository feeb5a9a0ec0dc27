"""Entry points of the port, as the reference's __graft_entry__.py has them.

entry(device=None): one 2-spp path-traced pass over a 32x32 Cornell box's
lanes, as (fn, args): fn(*args) is integrators/path.trace_path over every
pixel's lane, each keyed by fold_in(PRNGKey(0), pixel), the flagship
integrator per ray.

dryrun_multichip(n, device=None): the sharded renders of
parallel/sharding.py over a mesh of n entries, each `device` (the card
unless "cpu" is given: [cuda:0] * n on one card, [cpu] * n in tests), at
tiny shapes, with the reference's asserts: the per-ray path render, the
SoA path, gradient-domain and volumetric renders. The reference runs them
in a subprocess on n virtual CPU devices; here the mesh is built in
process, from devices given.
"""

import numpy as np
import torch

from gdpt_tpu_torch.core.dtypes import REAL, resolve_device


def _tiny_scene(width=32, height=32, spp=2):
    from gdpt_tpu_torch.scene import presets

    return presets.cornell_box(width=width, height=height, spp=spp, max_depth=4)


def entry(device=None):
    """(fn, (device scene, xs, ys, pix)) of the 32x32 cbox on `device`."""
    from gdpt_tpu_torch.core import rng
    from gdpt_tpu_torch.integrators import path, path_soa
    from gdpt_tpu_torch.ops import intersect as isect
    from gdpt_tpu_torch.scene.build import scene_to

    device = resolve_device(device)
    scene = scene_to(_tiny_scene(), device)
    static = scene.static
    casts = isect.Casts(path_soa.scene_soa_from_aos(scene).geom)
    w, h = static.width, static.height
    ys, xs = np.mgrid[0:h, 0:w]
    xs = torch.from_numpy(xs.ravel().astype(np.float32)).to(device)
    ys = torch.from_numpy(ys.ravel().astype(np.float32)).to(device)
    pix = torch.arange(w * h, dtype=torch.int64, device=device)

    def fn(device_scene, xs, ys, pix):
        key = rng.ray_key(rng.prng_key(0, pix.shape[0], pix.device), pix)
        return path.trace_path(device_scene, static, casts, xs.to(REAL), ys.to(REAL), key)

    return fn, (scene.device, xs, ys, pix)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The reference's four sharded renders over make_mesh([device] *
    n_devices), with its asserts (16x16, 2 spp)."""
    from gdpt_tpu_torch.integrators import path
    from gdpt_tpu_torch.parallel import sharding
    from gdpt_tpu_torch.scene import presets

    mesh = sharding.make_mesh([resolve_device(device)] * n_devices)
    assert len(mesh.devices) == n_devices, f"need {n_devices} devices, have {len(mesh.devices)}"
    scene = _tiny_scene(width=16, height=16, spp=2)
    img = sharding.render_samples_sharded(scene, path.trace_path, mesh, spp=2, sample_shards=2)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0
    # The SoA path render, sharded over the same mesh.
    img2 = sharding.render_soa_sharded(scene, mesh, spp=2)
    assert img2.shape == (16, 16, 3)
    assert np.isfinite(img2).all()
    assert img2.max() > 0
    # The SoA gradient-domain render (base + 4 offset paths + Poisson
    # reconstruction), sharded over the same mesh.
    scg = presets.cornell_box(width=16, height=16, spp=2, max_depth=3, integrator="gradpath")
    img3 = sharding.render_gradpath_soa_sharded(scg, mesh, spp=2)
    assert img3.shape == (16, 16, 3)
    assert np.isfinite(img3).all()
    # The SoA volumetric render (delta-tracking null scattering).
    scv = presets.volpath_scene(version=6, width=16, height=16, spp=2, max_depth=4, hetero=True)
    img4 = sharding.render_volpath_soa_sharded(scv, mesh, spp=2)
    assert img4.shape == (16, 16, 3)
    assert np.isfinite(img4).all()
