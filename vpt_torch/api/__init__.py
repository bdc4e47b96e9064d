from .config import RenderConfig
from .render import render

__all__ = ["RenderConfig", "render"]
