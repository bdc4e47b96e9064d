"""vpt_torch — the vpt volumetric path tracer on PyTorch and CUDA.

The port of the JAX package ``vpt`` (which stays the reference) to one
NVIDIA H100: the same module layout and public names, plain torch around
hand-written CUDA kernels (csrc/). It imports no JAX.

Ported so far: the forward render of every fused-kernel integrator of vpt
(free-flight and equi-angular, explicit and implicit, physical; HG g;
material-3 shells) through the render kernel (kernels/wavefront.py), with
adaptive sampling (render_adaptive) and rendering to a noise target
(render_to_noise) on it, in homogeneous media and in vpt's analytic density
fields (media/density.py: exp_height ground fog, Gaussian blobs); the
differentiable render pair with its trainer (kernels/diff.py,
vpt_torch.dist.fit_kernel), the fog falloff and the blob rows traced too;
and the geometric-gradient
dual kernel with its trainers (kernels/geom.py, vpt_torch.dist.fit_geom and
fit_geom_fd); see ROADMAP.md for the queue.
"""
from .api.config import RenderConfig
from .api.render import render
from .api.adaptive import make_adaptive_renderer, render_adaptive
from .api.noise import render_to_noise
from .scene.scene import Scene, Medium, SCENES, cornell_vpt, make_scene
from .scene.camera import Camera, default_camera, look_at
from .scene.io import save_scene, load_scene
from . import dist  # inverse rendering (fit_kernel)
from . import media  # density fields (exp_height, blobs)

__all__ = ["RenderConfig", "render", "make_adaptive_renderer",
           "render_adaptive", "render_to_noise", "Scene", "Medium", "SCENES",
           "cornell_vpt", "make_scene", "Camera", "default_camera",
           "look_at", "save_scene", "load_scene", "dist", "media"]

__version__ = "0.1.0"
