"""Load model weights from a JAX ``.ckpt`` or a reference ``.pth``, without JAX.

The subset of yolo_tpu/training/checkpoints.py that inference needs. A JAX
``.ckpt`` is a plain pickle of numpy trees (yolo_tpu/training/checkpoints.py:
30-36), but its ``optimizer_state_dict`` holds optax NamedTuples, and
unpickling those would import optax and with it jax. The unpickler here puts
an inert stand-in in place of any optax/jax/flax class; the model weights
are plain numpy and load as they are. Only open checkpoints you trust:
unpickling can run code.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict

import torch

_FOREIGN = ("optax", "jax", "jaxlib", "flax")


class ForeignObject:
    """Stands in for an object of a JAX-side class; keeps what it was built from."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (ForeignObject,), {"__module__": module})
        return super().find_class(module, name)


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """A JAX ``.ckpt`` payload, with foreign optimizer classes stubbed out."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_variables(path: str | Path) -> Dict[str, Any]:
    """Just the JAX model variables ``{'params', 'batch_stats'}`` of a ``.ckpt``."""
    msd = load_checkpoint(path)["model_state_dict"]
    return {"params": msd["params"], "batch_stats": msd.get("batch_stats", {})}


def load_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """The port's state dict from a ``.pth`` (reference names) or a JAX ``.ckpt``."""
    path = Path(path)
    if path.suffix == ".pth":
        raw = torch.load(str(path), map_location="cpu", weights_only=True)
        return raw.get("model_state_dict", raw)
    from yolo_tpu_torch.convert import state_dict_from_jax

    return state_dict_from_jax(load_variables(path))
