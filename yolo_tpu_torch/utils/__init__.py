"""Utilities: the CUDA kernel build (``kernels``) and drawing (``visualization``).

This package imports nothing, so that loading it pulls in neither PIL nor a
compiler; the drawing names resolve on first use.
"""

from importlib import import_module

_LAZY = {
    "draw_detections": "visualization",
    "draw_objectness_grid_on_image": "visualization",
    "extract_objectness_scores": "visualization",
    "visualize_objectness_grid": "visualization",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_LAZY)
