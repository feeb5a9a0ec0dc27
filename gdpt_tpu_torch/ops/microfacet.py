"""Microfacet toolbox of the per-ray materials (reference: src/microfacet.h).

Counterpart of gdpt_tpu/ops/microfacet.py, lane-batched: dielectric
Fresnel, GTR1/GTR2 NDFs, Smith masking, Heitz-2018
visible-normal sampling (isotropic + anisotropic) and the clearcoat
inverse-CDF sampler, branch-free. Vectors are (N, 3), per-lane scalars
(N,).
"""

import math

import torch

from gdpt_tpu_torch.core import math as gm


def fresnel_dielectric(n_dot_i, eta):
    """Exact dielectric Fresnel from the incident-side cosine; 1 on total
    internal reflection (reference: src/microfacet.h:48-57).
    eta = eta_transmit / eta_incident."""
    n_dot_t_sq = 1.0 - (1.0 - n_dot_i * n_dot_i) / (eta * eta)
    n_dot_t = gm.safe_sqrt(n_dot_t_sq)
    ni = torch.abs(n_dot_i)
    rs = (ni - eta * n_dot_t) / torch.clamp_min(ni + eta * n_dot_t, 1e-20)
    rp = (eta * ni - n_dot_t) / torch.clamp_min(eta * ni + n_dot_t, 1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(n_dot_t_sq < 0.0, 1.0, f)


def gtr2(n_dot_h, roughness):
    alpha = roughness * roughness
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / torch.clamp_min(math.pi * t * t, 1e-20)


def gtr2_aniso(h_local, alpha_x, alpha_y):
    """Anisotropic GTR2 / GGX NDF."""
    hx, hy, hz = h_local[..., 0], h_local[..., 1], h_local[..., 2]
    d = (hx / alpha_x) ** 2 + (hy / alpha_y) ** 2 + hz * hz
    return 1.0 / torch.clamp_min(math.pi * alpha_x * alpha_y * d * d, 1e-20)


def smith_masking_gtr2(v_local, roughness):
    """Smith G1 for isotropic GTR2 (reference: src/microfacet.h:79-85)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    vx, vy, vz = v_local[..., 0], v_local[..., 1], v_local[..., 2]
    lam = (-1.0 + torch.sqrt(
        1.0 + (vx * vx * a2 + vy * vy * a2) / torch.clamp_min(vz * vz, 1e-20))) / 2.0
    return 1.0 / (1.0 + lam)


def smith_masking_aniso(v_local, alpha_x, alpha_y):
    vx, vy, vz = v_local[..., 0], v_local[..., 1], v_local[..., 2]
    inner = ((vx * alpha_x) ** 2 + (vy * alpha_y) ** 2) / torch.clamp_min(vz * vz, 1e-20)
    lam = (torch.sqrt(1.0 + inner) - 1.0) / 2.0
    return 1.0 / (1.0 + lam)


def _vndf_impl(local_dir_in, ax, ay, uv):
    hemi = gm.normalize(
        torch.stack([ax * local_dir_in[..., 0], ay * local_dir_in[..., 1],
                     local_dir_in[..., 2]], dim=-1),
        eps=1e-20,
    )
    r = torch.sqrt(uv[..., 0])
    phi = 2.0 * math.pi * uv[..., 1]
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + hemi[..., 2])
    t2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - t1 * t1, 0.0)) + s * t2
    disk_n = torch.stack(
        [t1, t2, torch.sqrt(torch.clamp_min(1.0 - t1 * t1 - t2 * t2, 0.0))], dim=-1)
    hemi_n = gm.to_world(gm.make_frame(hemi), disk_n)
    out = torch.stack([ax * hemi_n[..., 0], ay * hemi_n[..., 1],
                       torch.clamp_min(hemi_n[..., 2], 0.0)], dim=-1)
    return gm.normalize(out, eps=1e-20)


def sample_visible_normals(local_dir_in, alpha, uv, alpha_x=None, alpha_y=None):
    """Heitz 2018 VNDF sampling (reference: src/microfacet.h:98-161), with
    the reference's below-horizon mirroring."""
    ax = alpha if alpha_x is None else alpha_x
    ay = alpha if alpha_y is None else alpha_y
    below = local_dir_in[..., 2] < 0.0
    din = gm.where(below, -local_dir_in, local_dir_in)
    h = _vndf_impl(din, ax, ay, uv)
    return gm.where(below, -h, h)


def sample_clearcoat_normal(alpha, uv):
    """GTR1 half-vector inverse-CDF sampler (reference: src/microfacet.h:164-177)."""
    a2 = alpha * alpha
    u0, u1 = uv[..., 0], uv[..., 1]
    azim = 2.0 * math.pi * u1
    cos2 = (1.0 - torch.pow(a2, 1.0 - u0)) / (1.0 - a2)
    cos_e = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_e = torch.sqrt(torch.clamp(1.0 - cos2, 0.0, 1.0))
    return gm.normalize(
        torch.stack([sin_e * torch.cos(azim), sin_e * torch.sin(azim), cos_e], dim=-1),
        eps=1e-20,
    )


def gtr1_clearcoat(hz, alpha):
    """GTR1-style clearcoat NDF (reference: src/materials/disney_clearcoat.inl:30)."""
    a2 = alpha * alpha
    denom = math.pi * torch.log(a2) * (1.0 + (a2 - 1.0) * hz * hz)
    denom = torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
    return (a2 - 1.0) / denom


def reflect_over(dir_in, half):
    """Mirror dir_in (pointing away from the surface) over the half-vector."""
    return gm.normalize(-dir_in + 2.0 * gm.dot(dir_in, half)[..., None] * half, eps=1e-20)
