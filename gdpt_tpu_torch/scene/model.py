"""Host-side scene description (the user-facing scene API).

Python dataclasses playing the role of the reference's std::variant
plugin types (reference: src/material.h:102-110, src/shape.h:53,
src/light.h:34, src/medium.h:22). ``scene.build`` freezes these into the
flat device arrays the integrators consume.
"""

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


@dataclass
class ConstantTexture:
    value: Union[float, np.ndarray]


@dataclass
class ImageTexture:
    """Image texture; `data` is an (h, w[, 3]) linear float array."""

    data: np.ndarray
    name: str = ""          # cache key (matches TexturePool semantics)
    uscale: float = 1.0
    vscale: float = 1.0
    uoffset: float = 0.0
    voffset: float = 0.0


@dataclass
class CheckerboardTexture:
    color0: Union[float, np.ndarray]
    color1: Union[float, np.ndarray]
    uscale: float = 1.0
    vscale: float = 1.0
    uoffset: float = 0.0
    voffset: float = 0.0


HostTexture = Union[ConstantTexture, ImageTexture, CheckerboardTexture, float, np.ndarray, list, tuple]

# ---------------------------------------------------------------------------
# Materials (reference: src/material.h:12-98)
# ---------------------------------------------------------------------------

MAT_LAMBERTIAN = 0
MAT_ROUGH_PLASTIC = 1
MAT_ROUGH_DIELECTRIC = 2
MAT_DISNEY_DIFFUSE = 3
MAT_DISNEY_METAL = 4
MAT_DISNEY_GLASS = 5
MAT_DISNEY_CLEARCOAT = 6
MAT_DISNEY_SHEEN = 7
MAT_DISNEY_BSDF = 8


@dataclass
class Lambertian:
    reflectance: HostTexture = 0.5
    kind = MAT_LAMBERTIAN


@dataclass
class RoughPlastic:
    diffuse_reflectance: HostTexture = 0.5
    specular_reflectance: HostTexture = 1.0
    roughness: HostTexture = 0.1
    eta: float = 1.5
    kind = MAT_ROUGH_PLASTIC


@dataclass
class RoughDielectric:
    specular_reflectance: HostTexture = 1.0
    specular_transmittance: HostTexture = 1.0
    roughness: HostTexture = 0.1
    eta: float = 1.5
    kind = MAT_ROUGH_DIELECTRIC


@dataclass
class DisneyDiffuse:
    base_color: HostTexture = 0.5
    roughness: HostTexture = 0.5
    subsurface: HostTexture = 0.0
    kind = MAT_DISNEY_DIFFUSE


@dataclass
class DisneyMetal:
    base_color: HostTexture = 0.5
    roughness: HostTexture = 0.5
    anisotropic: HostTexture = 0.0
    kind = MAT_DISNEY_METAL


@dataclass
class DisneyGlass:
    base_color: HostTexture = 0.5
    roughness: HostTexture = 0.5
    anisotropic: HostTexture = 0.0
    eta: float = 1.5
    kind = MAT_DISNEY_GLASS


@dataclass
class DisneyClearcoat:
    clearcoat_gloss: HostTexture = 1.0
    kind = MAT_DISNEY_CLEARCOAT


@dataclass
class DisneySheen:
    base_color: HostTexture = 0.5
    sheen_tint: HostTexture = 0.5
    kind = MAT_DISNEY_SHEEN


@dataclass
class DisneyBSDF:
    base_color: HostTexture = 0.5
    specular_transmission: HostTexture = 0.0
    metallic: HostTexture = 0.0
    subsurface: HostTexture = 0.0
    specular: HostTexture = 0.5
    roughness: HostTexture = 0.5
    specular_tint: HostTexture = 0.0
    anisotropic: HostTexture = 0.0
    sheen: HostTexture = 0.0
    sheen_tint: HostTexture = 0.5
    clearcoat: HostTexture = 0.0
    clearcoat_gloss: HostTexture = 1.0
    eta: float = 1.5
    kind = MAT_DISNEY_BSDF


HostMaterial = Union[
    Lambertian, RoughPlastic, RoughDielectric, DisneyDiffuse, DisneyMetal,
    DisneyGlass, DisneyClearcoat, DisneySheen, DisneyBSDF,
]

# ---------------------------------------------------------------------------
# Shapes (reference: src/shape.h:28-53)
# ---------------------------------------------------------------------------


@dataclass
class TriangleMesh:
    positions: np.ndarray               # (v, 3)
    indices: np.ndarray                 # (t, 3) int
    normals: Optional[np.ndarray] = None  # (v, 3)
    uvs: Optional[np.ndarray] = None      # (v, 2)
    material_id: int = -1
    area_light_id: int = -1
    interior_medium_id: int = -1
    exterior_medium_id: int = -1


@dataclass
class Sphere:
    center: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 1.0
    material_id: int = -1
    area_light_id: int = -1
    interior_medium_id: int = -1
    exterior_medium_id: int = -1


HostShape = Union[TriangleMesh, Sphere]

# ---------------------------------------------------------------------------
# Lights (reference: src/light.h:15-34)
# ---------------------------------------------------------------------------


@dataclass
class DiffuseAreaLight:
    shape_id: int
    intensity: np.ndarray = field(default_factory=lambda: np.ones(3))


@dataclass
class Envmap:
    texture: HostTexture = 1.0
    to_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    scale: float = 1.0


HostLight = Union[DiffuseAreaLight, Envmap]

# ---------------------------------------------------------------------------
# Media (reference: src/medium.h, src/phase_function.h, src/volume.h)
# ---------------------------------------------------------------------------

PHASE_ISOTROPIC = 0
PHASE_HG = 1


@dataclass
class IsotropicPhase:
    kind = PHASE_ISOTROPIC
    g: float = 0.0


@dataclass
class HenyeyGreenstein:
    g: float = 0.0
    kind = PHASE_HG


@dataclass
class ConstantVolume:
    value: Union[float, np.ndarray]


@dataclass
class GridVolume:
    data: np.ndarray                    # (zres, yres, xres, c)
    p_min: np.ndarray = field(default_factory=lambda: np.zeros(3))
    p_max: np.ndarray = field(default_factory=lambda: np.ones(3))
    scale: float = 1.0


HostVolume = Union[ConstantVolume, GridVolume, float, np.ndarray]


@dataclass
class HomogeneousMedium:
    sigma_a: np.ndarray = field(default_factory=lambda: np.zeros(3))
    sigma_s: np.ndarray = field(default_factory=lambda: np.zeros(3))
    phase: Union[IsotropicPhase, HenyeyGreenstein] = field(default_factory=IsotropicPhase)


@dataclass
class HeterogeneousMedium:
    albedo: HostVolume = 0.5
    density: HostVolume = 1.0
    phase: Union[IsotropicPhase, HenyeyGreenstein] = field(default_factory=IsotropicPhase)


HostMedium = Union[HomogeneousMedium, HeterogeneousMedium]

# ---------------------------------------------------------------------------
# Camera + render options (reference: src/camera.h, src/scene.h:25-32)
# ---------------------------------------------------------------------------


@dataclass
class Camera:
    cam_to_world: np.ndarray
    fov: float                 # vertical fov in degrees (after fovAxis fixup)
    width: int = 512
    height: int = 512
    filter_kind: int = 0       # filters.FILTER_*
    filter_param: float = 1.0  # width (box/tent) or stddev (gaussian)
    medium_id: int = -1


@dataclass(frozen=True)
class RenderOptions:
    integrator: str = "path"   # depth/shading_normal/mean_curvature/
    #                            ray_differential/mipmap_level/path/volpath/gradpath
    samples_per_pixel: int = 4
    max_depth: int = -1
    rr_depth: int = 5
    vol_path_version: int = 0
    max_null_collisions: int = 1000
    # GDPT reconstruction data weight (reference: src/render.cpp:353)
    gdpt_alpha: float = 0.04
