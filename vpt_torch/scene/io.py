"""Scene (de)serialization on the JSON schema of ``vpt/scene/io.py``:

    {
      "sigma_a": 0.001, "sigma_s": 0.009,
      "spheres": [
        {"radius": 1e5, "center": [-1e5-49, 0, 0], "albedo": [0.5, 0.5, 0.5],
         "radiance": [0, 0, 0], "material": 0,
         "eta": [0, 0, 0], "kappa": [0, 0, 0], "alpha": 0.0},
        ...
      ],
      "camera": {"origin": [0, 11.2, 214], "direction": [0, -0.042612, -1],
                 "fov_scale": 0.5095}          # optional
    }

Values are written as exact python floats, so a scene saved by either
package rebuilds the same f32 values in the other, and both render the same
thing. Scenes with a "density" field need the heterogeneous media of ROADMAP
Queue 1 item 6 and are refused.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .camera import Camera
from .scene import Scene, make_scene

__all__ = ["scene_to_dict", "scene_from_dict", "save_scene", "load_scene"]


def _f64(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().to(torch.float64).numpy()


def scene_to_dict(scene: Scene, camera: Camera | None = None) -> dict:
    """Plain-python dict of the scene (and optionally camera), JSON-ready."""
    r, c, alb, rad = (_f64(scene.radius), _f64(scene.center),
                      _f64(scene.albedo), _f64(scene.radiance))
    eta, kap, alp = _f64(scene.eta), _f64(scene.kappa), _f64(scene.alpha)
    mat = scene.material.detach().cpu().numpy().astype(np.int64)
    spheres = [
        {
            "radius": float(r[i]), "center": list(map(float, c[i])),
            "albedo": list(map(float, alb[i])),
            "radiance": list(map(float, rad[i])),
            "material": int(mat[i]),
            "eta": list(map(float, eta[i])),
            "kappa": list(map(float, kap[i])),
            "alpha": float(alp[i]),
        }
        for i in range(scene.count)
    ]
    out = {
        "sigma_a": float(_f64(scene.medium.sigma_a)),
        "sigma_s": float(_f64(scene.medium.sigma_s)),
        "spheres": spheres,
    }
    g = float(_f64(scene.medium.g))
    if g != 0.0:
        out["g"] = g      # HG anisotropy; omitted when isotropic
    if camera is not None:
        out["camera"] = {
            "origin": list(map(float, _f64(camera.origin))),
            "direction": list(map(float, _f64(camera.direction))),
            "fov_scale": float(_f64(camera.fov_scale)),
        }
    return out


def scene_from_dict(d: dict, dtype=torch.float32, device="cpu"):
    """(Scene, Camera | None) from a scene dict. Missing per-sphere fields
    default like the reference Sphere constructor (zeros; material 0)."""
    if "density" in d:
        raise NotImplementedError(
            "scene has a density field: heterogeneous media are not ported "
            "yet (ROADMAP Queue 1 item 6)")
    spheres = []
    for s in d["spheres"]:
        spheres.append((
            float(s.get("radius", 0.0)),
            tuple(s.get("center", (0.0, 0.0, 0.0))),
            tuple(s.get("albedo", (0.0, 0.0, 0.0))),
            tuple(s.get("radiance", (0.0, 0.0, 0.0))),
            int(s.get("material", 0)),
            tuple(s.get("eta", (0.0, 0.0, 0.0))),
            tuple(s.get("kappa", (0.0, 0.0, 0.0))),
            float(s.get("alpha", 0.0)),
        ))
    scene = make_scene(spheres, sigma_a=float(d.get("sigma_a", 0.001)),
                       sigma_s=float(d.get("sigma_s", 0.009)),
                       g=float(d.get("g", 0.0)), dtype=dtype, device=device)
    camera = None
    if "camera" in d:
        c = d["camera"]
        # normalize only when the stored direction is NOT already unit to
        # f32 precision: renormalizing a saved unit direction could flip
        # last-ulp bits and break the bit-identical round trip
        raw = np.asarray(c["direction"], np.float64)
        if abs(float((raw.astype(np.float32).astype(np.float64) ** 2).sum())
               - 1.0) > 1e-6:
            raw = raw / np.linalg.norm(raw)

        def as_(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=device).to(dtype)

        camera = Camera(origin=as_(c["origin"]), direction=as_(raw),
                        fov_scale=as_(c.get("fov_scale", 0.5095)))
    return scene, camera


def save_scene(path: str, scene: Scene, camera: Camera | None = None) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene, camera), f, indent=1)
        f.write("\n")


def load_scene(path: str, dtype=torch.float32, device="cpu"):
    """(Scene, Camera | None) from a JSON scene file."""
    with open(path) as f:
        return scene_from_dict(json.load(f), dtype=dtype, device=device)
