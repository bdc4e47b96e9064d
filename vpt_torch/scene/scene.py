"""Scene representation: structure-of-arrays sphere soup as torch tensors.

Counterpart of ``vpt/scene/scene.py``. The reference hardcodes a global
``std::vector<Sphere>`` (include/Sphere.h:49, Sphere.cpp:7-23) with fields
radius / center / albedo / radiance / material / eta / kappa / alpha; here
the scene is a frozen dataclass of tensors. Material codes follow the
reference (include/Sphere.h:18-21):

  0 = Lambertian, 1 = Beckmann microfacet conductor, 2 = smooth dielectric,
  3 = volumetric boundary (participating-medium shell).

A medium is homogeneous, or scaled by one of vpt's density fields
(media/density.py: exp_height ground fog, Gaussian blobs, voxel grids); the
scenes foggy_cornell and blob_cloud carry the analytic ones.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "LAMBERT", "MICROFACET", "DIELECTRIC", "VOLUME_BOUNDARY",
    "Medium", "Scene", "make_scene", "CORNELL_VPT_SPHERES", "cornell_vpt",
    "sigma_comparison", "light_near_camera", "near_point_area_sources",
    "one_primitive_infinite", "simple_cornell", "medium_shell",
    "foggy_cornell", "blob_cloud", "SCENES",
]

LAMBERT = 0
MICROFACET = 1
DIELECTRIC = 2
VOLUME_BOUNDARY = 3


@dataclasses.dataclass(frozen=True)
class Medium:
    """Participating medium: sigma_a(x) = sigma_a * d(x), sigma_s(x) =
    sigma_s * d(x) with d the density field, or d == 1 (homogeneous) when
    density is None.

    g: Henyey-Greenstein anisotropy; 0 is isotropic.
    density: a media.density.DensityField (exp_height, blobs or grid) or
    None."""

    sigma_a: torch.Tensor
    sigma_s: torch.Tensor
    g: torch.Tensor | float = 0.0
    density: "DensityField | None" = None


@dataclasses.dataclass(frozen=True)
class Scene:
    radius: torch.Tensor     # (S,)   radius; r == 0 => point light
    center: torch.Tensor     # (S, 3)
    albedo: torch.Tensor     # (S, 3) diffuse color
    radiance: torch.Tensor   # (S, 3) emission; any channel > 0 => emitter
    material: torch.Tensor   # (S,)   int32 material code
    eta: torch.Tensor        # (S, 3) conductor IOR (real part)
    kappa: torch.Tensor      # (S, 3) conductor IOR (imaginary part)
    alpha: torch.Tensor      # (S,)   Beckmann roughness
    medium: Medium
    # light structure, decided by make_scene exactly as in vpt
    emitter_idx: tuple = ()      # any-channel emitters
    mis_light_idx: tuple = ()    # r > 0 and radiance.x > 0
    point_idx: tuple = ()        # r == 0 (point sources)

    @property
    def count(self) -> int:
        return self.radius.shape[0]


def make_scene(
    spheres: Sequence[tuple],
    sigma_a: float = 0.001,
    sigma_s: float = 0.009,
    g: float = 0.0,
    density=None,
    dtype=torch.float32,
    device="cpu",
) -> Scene:
    """Build a Scene from (radius, center, albedo, radiance, material, eta,
    kappa, alpha) tuples — the reference Sphere constructor order
    (include/Sphere.h:23). density: a media.density.DensityField or None
    (homogeneous)."""
    n = len(spheres)
    radius = np.zeros((n,), np.float64)
    center = np.zeros((n, 3), np.float64)
    albedo = np.zeros((n, 3), np.float64)
    radiance = np.zeros((n, 3), np.float64)
    material = np.zeros((n,), np.int32)
    eta = np.zeros((n, 3), np.float64)
    kappa = np.zeros((n, 3), np.float64)
    alpha = np.zeros((n,), np.float64)
    for i, (r, p, c, rad, m, e, k, a) in enumerate(spheres):
        radius[i] = r
        center[i] = p
        albedo[i] = c
        radiance[i] = rad
        material[i] = m
        eta[i] = e
        kappa[i] = k
        alpha[i] = a
    emitter_idx = tuple(int(i) for i in np.flatnonzero((radiance > 0).any(-1)))
    mis_light_idx = tuple(
        int(i) for i in np.flatnonzero((radiance[:, 0] > 0) & (radius > 0)))
    point_idx = tuple(int(i) for i in np.flatnonzero(radius == 0))

    def as_(a):
        return torch.as_tensor(a, device=device).to(dtype)

    return Scene(
        radius=as_(radius), center=as_(center), albedo=as_(albedo),
        radiance=as_(radiance),
        material=torch.as_tensor(material, device=device),
        eta=as_(eta), kappa=as_(kappa), alpha=as_(alpha),
        medium=Medium(as_(sigma_a), as_(sigma_s), as_(g), density),
        emitter_idx=emitter_idx, mis_light_idx=mis_light_idx,
        point_idx=point_idx,
    )


_Z3 = (0.0, 0.0, 0.0)

# Aluminum spectral IOR used by the reference scenes (Sphere.cpp:17).
ALUMINUM_ETA = (1.66058, 0.88143, 0.521467)
ALUMINUM_KAPPA = (9.2282, 6.27077, 4.83803)
# Gold spectral IOR from the commented alternates (Sphere.cpp:82).
GOLD_ETA = (0.143245, 0.377423, 1.43919)
GOLD_KAPPA = (3.98479, 2.3847, 1.60434)

# The reference's ACTIVE scene table (Sphere.cpp:7-23) as exact python floats.
CORNELL_VPT_SPHERES = (
    (1e5, (-1e5 - 49, 0, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
    (1e5, (1e5 + 49, 0, 0), (0.0, 0.0, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
    (1e5, (0, 0, -1e5 - 81.6), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
    (1e5, (0, -1e5 - 40.8, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
    (1e5, (0, 1e5 + 40.8, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
    (16.5, (-23, -24.3, -34.6), _Z3, _Z3, MICROFACET, ALUMINUM_ETA, ALUMINUM_KAPPA, 0.09),
    (16.5, (23, -24.3, -3.6), (0.0, 0.0, 0.9), _Z3, LAMBERT, _Z3, _Z3, 0.0),
    (2.0, (0, 24.3, -35), _Z3, (100, 100, 0), LAMBERT, _Z3, _Z3, 0.0),
    (0.0, (-23, 24.3, 0), _Z3, (6000, 0, 0), LAMBERT, _Z3, _Z3, 0.0),
    (2.0, (23, 24.3, 35), _Z3, (75, 75, 60), LAMBERT, _Z3, _Z3, 0.0),
)


def cornell_vpt(dtype=torch.float32, device="cpu") -> Scene:
    """The reference's ACTIVE scene (Sphere.cpp:7-23): 5 giant-sphere walls,
    an aluminum microfacet sphere, a blue Lambertian sphere, two spherical
    area lights and one point light."""
    return make_scene(list(CORNELL_VPT_SPHERES), dtype=dtype, device=device)


def sigma_comparison(dtype=torch.float32, device="cpu") -> Scene:
    """Commented alternate "ESCENA DOS" (Sphere.cpp:28-46)."""
    return make_scene(
        [
            (1e5, (-1e5 - 49, 0, 0), _Z3, _Z3, MICROFACET, ALUMINUM_ETA, ALUMINUM_KAPPA, 0.03),
            (1e5, (1e5 + 49, 0, 0), _Z3, _Z3, MICROFACET, ALUMINUM_ETA, ALUMINUM_KAPPA, 0.03),
            (1e5, (0, 0, -1e5 - 81.6), (0.25, 0.75, 0.25), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, -1e5 - 40.8, 0), (0.25, 0.75, 0.75), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, 1e5 + 40.8, 0), (0.75, 0.75, 0.25), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (16.5, (-23, -24.3, -34.6), (0.75, 0.75, 0.25), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (16.5, (23, -24.3, -3.6), (0.4, 0.3, 0.2), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (14, -24.3, -35), _Z3, (2000, 2000, 3000), LAMBERT, _Z3, _Z3, 0.0),
        ],
        dtype=dtype, device=device,
    )


def light_near_camera(dtype=torch.float32, device="cpu") -> Scene:
    """Commented alternate "ESCENA 3" (Sphere.cpp:49-62)."""
    return make_scene(
        [
            (30.0, (0, 11.2, 165), (0.0, 0.25, 0.75), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (16.5, (0, -10, 200), (0.75, 0.75, 0.75), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (0, 11.2, 204), _Z3, (400, 400, 400), LAMBERT, _Z3, _Z3, 0.0),
        ],
        dtype=dtype, device=device,
    )


def near_point_area_sources(dtype=torch.float32, device="cpu") -> Scene:
    """Commented alternate "fuentes de area que tienden a puntuales"
    (Sphere.cpp:65-77)."""
    return make_scene(
        [
            (1e5, (-1e5 - 49, 0, 0), (0.75, 0.25, 0.25), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (1e5 + 49, 0, 0), (0.25, 0.25, 0.75), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, 0, -1e5 - 81.6), (0.25, 0.75, 0.25), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, -1e5 - 40.8, 0), (0.25, 0.75, 0.75), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (16.5, (-23, -24.3, -34.6), _Z3, _Z3, MICROFACET, ALUMINUM_ETA, ALUMINUM_KAPPA, 0.03),
            (12.0, (24, 24.3, -50), _Z3, (0, 800, 800), LAMBERT, _Z3, _Z3, 0.0),
        ],
        dtype=dtype, device=device,
    )


def one_primitive_infinite(dtype=torch.float32, device="cpu") -> Scene:
    """Commented alternate "1 primitive infinite" (Sphere.cpp:79-89)."""
    return make_scene(
        [
            (16.5, (-23, -24.3, -34.6), _Z3, _Z3, MICROFACET, ALUMINUM_ETA, ALUMINUM_KAPPA, 0.03),
            (16.5, (23, -24.3, -3.6), _Z3, _Z3, MICROFACET, GOLD_ETA, GOLD_KAPPA, 0.3),
            (100.0, (0, -24.3, -200), _Z3, _Z3, MICROFACET, GOLD_ETA, GOLD_KAPPA, 0.02),
            (0.0, (24, 24.3, -3.6), _Z3, (2000, 2000, 2000), LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (-24, 10, -34.6), _Z3, (2000, 5000, 1000), LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (0, -24.3, -30), _Z3, (4000, 8000, 4000), LAMBERT, _Z3, _Z3, 0.0),
        ],
        dtype=dtype, device=device,
    )


def simple_cornell(dtype=torch.float32, device="cpu") -> Scene:
    """Commented alternate simple Cornell (Sphere.cpp:91-106)."""
    return make_scene(
        [
            (1e5, (-1e5 - 49, 0, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (1e5 + 49, 0, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, 0, -1e5 - 81.6), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, -1e5 - 40.8, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, 1e5 + 40.8, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (16.5, (23, -24.3, -3.6), (0.5, 0.5, 0.0), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (-23, 0, -10.6), (1, 1, 1), (6000, 6000, 6000), LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (23, 24.3, -50), (1, 1, 1), (4000, 4000, 4000), LAMBERT, _Z3, _Z3, 0.0),
        ],
        dtype=dtype, device=device,
    )


def medium_shell(dtype=torch.float32, device="cpu") -> Scene:
    """Capability scene with a volumetric boundary sphere (material 3). The
    render kernel and the differentiable pair draw it (pLight's material-3
    cascade); the dual kernel refuses it (ROADMAP Queue 1 item 5)."""
    return make_scene(
        [
            (1e5, (-1e5 - 49, 0, 0), (0.6, 0.3, 0.3), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (1e5 + 49, 0, 0), (0.3, 0.3, 0.6), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, 0, -1e5 - 81.6), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, -1e5 - 40.8, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (1e5, (0, 1e5 + 40.8, 0), (0.5, 0.5, 0.5), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (14.0, (0, -10.0, -10.0), (1, 1, 1), _Z3, VOLUME_BOUNDARY, _Z3, _Z3, 0.0),
            (10.0, (20, -30.8, -40.0), (0.7, 0.6, 0.2), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (0.0, (-20, 24.3, 10), _Z3, (4000, 3500, 3000), LAMBERT, _Z3, _Z3, 0.0),
            (2.0, (23, 24.3, 35), _Z3, (75, 75, 60), LAMBERT, _Z3, _Z3, 0.0),
        ],
        dtype=dtype, device=device,
    )


def foggy_cornell(dtype=torch.float32, device="cpu") -> Scene:
    """vpt's heterogeneous capability scene (vpt/scene/scene.py:300-314):
    the reference's active Cornell geometry in ground fog, an exp_height
    field d(x) = exp(-k (y - y0)) anchored at the floor (y0 = -40.8, k =
    0.06: density 1.0 at the floor, ~0.007 at the ceiling), with a denser
    medium (sigma_t = 0.04). The majorant 1.01 covers the floor sphere's
    dip of ~0.012 below y = -40.8 at the side walls."""
    from ..media.density import exp_height

    return make_scene(
        list(CORNELL_VPT_SPHERES), sigma_a=0.004, sigma_s=0.036,
        density=exp_height(k=0.06, y0=-40.8, majorant=1.01, dtype=dtype),
        dtype=dtype, device=device)


def blob_cloud(dtype=torch.float32, device="cpu") -> Scene:
    """vpt's Gaussian-blob capability scene (vpt/scene/scene.py:317-347):
    three overlapping density blobs between the camera and two spheres
    (the light_near_camera geometry, Sphere.cpp:49-62), lit by a sphere
    light (a point light's medium NEE is zero by the reference's
    missing-else quirk). Free flight is delta tracking against the
    majorant 1.8."""
    from ..media.density import blobs

    return make_scene(
        [
            (12.0, (-18, -8, 150), (0.75, 0.3, 0.2), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (12.0, (18, -8, 160), (0.2, 0.4, 0.75), _Z3, LAMBERT, _Z3, _Z3, 0.0),
            (3.0, (0, 35, 190), _Z3, (130, 130, 115), LAMBERT, _Z3, _Z3, 0.0),
        ],
        sigma_a=0.004, sigma_s=0.04,
        density=blobs([
            # cx, cy, cz, radius, weight
            (-8.0, 2.0, 178.0, 9.0, 0.9),
            (8.0, -2.0, 170.0, 12.0, 0.7),
            (0.0, 10.0, 162.0, 8.0, 1.0),
        ], majorant=1.8, dtype=dtype),
        dtype=dtype, device=device)


SCENES = {
    "cornell_vpt": cornell_vpt,
    "foggy_cornell": foggy_cornell,
    "blob_cloud": blob_cloud,
    "medium_shell": medium_shell,
    "sigma_comparison": sigma_comparison,
    "light_near_camera": light_near_camera,
    "near_point_area_sources": near_point_area_sources,
    "one_primitive_infinite": one_primitive_infinite,
    "simple_cornell": simple_cornell,
}
