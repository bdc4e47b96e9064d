"""Participating-media extensions (counterpart of ``vpt/media``): the
density fields of density.py (exp_height, blobs and voxel grids); vpt's NEE
and engine-side media code is ROADMAP Queue 1 item 9."""
from .density import BLOBS, EXP_HEIGHT, GRID, DensityField, blobs, exp_height, grid

__all__ = ["DensityField", "exp_height", "blobs", "grid", "EXP_HEIGHT",
           "BLOBS", "GRID"]
