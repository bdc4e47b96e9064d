from .config import RenderConfig
from .render import render
from .adaptive import make_adaptive_renderer, render_adaptive
from .noise import render_to_noise

__all__ = ["RenderConfig", "render", "make_adaptive_renderer",
           "render_adaptive", "render_to_noise"]
