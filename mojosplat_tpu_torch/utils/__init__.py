"""Utilities: image IO, PLY and splat scene IO, metrics/timing, profiling."""

from .image import save_png, to_uint8
from .metrics import StageTimer, amortized_ms, compilation_count, log_render_aux
from .ply import load_gaussian_ply, save_gaussian_ply
from .profiling import annotate, roofline_report, trace
from .splat import load_gaussian_splat, save_gaussian_splat

__all__ = [
    "save_png",
    "to_uint8",
    "StageTimer",
    "amortized_ms",
    "compilation_count",
    "log_render_aux",
    "load_gaussian_ply",
    "save_gaussian_ply",
    "load_gaussian_splat",
    "save_gaussian_splat",
    "annotate",
    "roofline_report",
    "trace",
]
