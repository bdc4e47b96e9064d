"""vpt_torch — the vpt volumetric path tracer on PyTorch and CUDA.

The port of the JAX package ``vpt`` (which stays the reference) to one
NVIDIA H100: the same module layout and public names, plain torch around
hand-written CUDA kernels (csrc/). It imports no JAX.

Ported so far: the forward render of the homogeneous free-flight NEE
integrators through the render kernel (kernels/wavefront.py); see
ROADMAP.md for the queue.
"""
from .api.config import RenderConfig
from .api.render import render
from .scene.scene import Scene, Medium, SCENES, cornell_vpt, make_scene
from .scene.camera import Camera, default_camera, look_at
from .scene.io import save_scene, load_scene

__all__ = ["RenderConfig", "render", "Scene", "Medium", "SCENES",
           "cornell_vpt", "make_scene", "Camera", "default_camera",
           "look_at", "save_scene", "load_scene"]

__version__ = "0.1.0"
