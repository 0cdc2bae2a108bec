"""Checkpoints: save and resume training as ``.pth``, and read JAX ``.ckpt`` files.

Port of yolo_tpu/training/checkpoints.py with the same four file roles
(``yolo_latest`` every epoch, ``yolo_epoch_{N}`` at the save frequency,
``yolo_best`` by validation loss, ``yolo_best_map`` by mAP50:95) and the same
metadata keys (epoch, train_loss, val_loss, mAP50:95, mAP50, mAP75). The
files are ``.pth`` in the reference's layout: ``model_state_dict`` (the
reference's parameter names), ``optimizer_state_dict`` and
``scheduler_state_dict``; each is written to a ``.tmp`` file and renamed,
so a preempted save leaves no torn file.

A JAX ``.ckpt`` is a plain pickle of numpy trees (yolo_tpu/training/
checkpoints.py:30-36), but its ``optimizer_state_dict`` holds optax
NamedTuples, and unpickling those would import optax and with it jax. The
unpickler here puts an inert :class:`ForeignObject` in place of any
optax/jax/flax class, which keeps the arguments it was built from: that is
how :func:`adam_state_from_jax` finds ``ScaleByAdamState(count, mu, nu)``.
Only open checkpoints you trust: unpickling can run code. Orbax snapshots
have no torch counterpart and are not read.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from yolo_tpu_torch.training.logging import print_checkpoint_saved

CHECKPOINT_VERSION = 1
_FOREIGN = ("optax", "jax", "jaxlib", "flax")
_MAP_KEYS = ("mAP50:95", "mAP50", "mAP75")


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


def _variables(payload: Dict[str, Any]) -> Dict[str, Any]:
    msd = payload["model_state_dict"]
    return {"params": msd["params"], "batch_stats": msd.get("batch_stats", {})}


def load_variables(path: str | Path) -> Dict[str, Any]:
    """Just the JAX model variables ``{'params', 'batch_stats'}`` of a ``.ckpt``."""
    return _variables(load_checkpoint(path))


def load_model(path: str | Path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(the port's state dict, the payload's epoch / val_loss / mAP keys) from
    a ``.pth`` (reference names) or a JAX ``.ckpt``, read once."""
    path = Path(path)
    if path.suffix == ".pth":
        payload = torch.load(str(path), map_location="cpu", weights_only=True)
        state_dict = payload.get("model_state_dict", payload)
    else:
        from yolo_tpu_torch.convert import state_dict_from_jax

        payload = load_checkpoint(path)
        state_dict = state_dict_from_jax(_variables(payload))
    meta = {k: payload[k] for k in ("epoch", "val_loss", *_MAP_KEYS) if k in payload}
    return state_dict, meta


# ------------------------------------------------------------------ saving
def _save(path: Path, payload: Dict[str, Any]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic on POSIX: no torn checkpoints on preemption


def _payload(epoch, model, optimizer, val_losses) -> Dict[str, Any]:
    payload = {
        "version": CHECKPOINT_VERSION,
        "epoch": epoch,
        "model_state_dict": model.state_dict(),
        "optimizer_state_dict": optimizer.state_dict(),
        "val_loss": float(val_losses["total"]),
    }
    if "mAP50:95" in val_losses:
        payload.update({k: float(val_losses[k]) for k in _MAP_KEYS})
    return payload


def save_checkpoint(checkpoint_path, epoch: int, model, optimizer, schedule,
                    train_losses: Dict[str, float], val_losses: Dict[str, float]) -> None:
    """Full checkpoint: model, optimizer and schedule (resume-capable)."""
    payload = _payload(epoch, model, optimizer, val_losses)
    payload["scheduler_state_dict"] = schedule.state_dict()
    payload["train_loss"] = float(train_losses["total"])
    _save(Path(checkpoint_path), payload)
    print_checkpoint_saved(checkpoint_path)


def save_best_model(checkpoint_path, epoch: int, model, optimizer,
                    val_losses: Dict[str, float], metric_name: str,
                    metric_value: float) -> None:
    """Best-by-validation-loss checkpoint (no schedule state, as the reference)."""
    _save(Path(checkpoint_path), _payload(epoch, model, optimizer, val_losses))
    print_checkpoint_saved(checkpoint_path, metric_name, metric_value)


def save_best_map_model(checkpoint_path, epoch: int, model, optimizer,
                        val_losses: Dict[str, float], map_value: float) -> None:
    """Best-by-mAP50:95 checkpoint."""
    _save(Path(checkpoint_path), _payload(epoch, model, optimizer, val_losses))
    print_checkpoint_saved(checkpoint_path, "mAP@0.5:0.95", map_value)


def find_resume_path(resume: Optional[str], checkpoint_dir: str | Path) -> Optional[Path]:
    """``--resume``: 'true' -> <dir>/yolo_latest.pth, else the path; None if unset."""
    if not resume:
        return None
    if resume in (True, "true", "True"):
        return Path(checkpoint_dir) / "yolo_latest.pth"
    return Path(resume)


# ---------------------------------------------------------------- resuming
def _find_foreign(obj, name: str):
    """The first stub of class ``name`` inside a stubbed optax state tree."""
    if isinstance(obj, ForeignObject):
        if type(obj).__name__ == name:
            return obj
        children = [*obj.args, *obj.kwargs.values(), obj.state]
    elif isinstance(obj, (tuple, list)):
        children = obj
    elif isinstance(obj, dict):
        children = obj.values()
    else:
        return None
    for child in children:
        found = _find_foreign(child, name)
        if found is not None:
            return found
    return None


def adam_state_from_jax(opt_state, model) -> Dict[torch.Tensor, Dict[str, torch.Tensor]]:
    """torch Adam state for ``model``'s trainable parameters from a JAX opt_state.

    optax's ``ScaleByAdamState(count, mu, nu)`` holds the moments as
    parameter trees; they go through the same per-parameter layout change as
    the weights (``convert.params_state_dict_from_jax``) into ``exp_avg`` and
    ``exp_avg_sq``, and ``count`` becomes ``step``.
    """
    from yolo_tpu_torch.convert import params_state_dict_from_jax

    adam = _find_foreign(opt_state, "ScaleByAdamState")
    if adam is None:
        raise ValueError("the checkpoint's optimizer state holds no ScaleByAdamState")
    fields = dict(zip(("count", "mu", "nu"), adam.args), **adam.kwargs)
    mu = params_state_dict_from_jax(fields["mu"])
    nu = params_state_dict_from_jax(fields["nu"])
    step = torch.tensor(float(fields["count"]), dtype=torch.float32)
    state = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if name not in mu:
            raise ValueError(f"the checkpoint's Adam state has no moments for {name}")
        state[p] = {
            "step": step.clone(),
            # empty_like keeps p's device and memory format (channels_last convs)
            "exp_avg": torch.empty_like(p).copy_(mu[name].reshape(p.shape)),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name].reshape(p.shape)),
        }
    return state


def resume(path: str | Path, model, optimizer, schedule) -> Dict[str, Any]:
    """Restore weights, BN statistics, optimizer and schedule from a checkpoint.

    ``.pth``: the port's own files (or a reference ``.pth``: weights only).
    ``.ckpt``: a JAX checkpoint; the weights and statistics through
    ``state_dict_from_jax``, Adam's moments and step through
    :func:`adam_state_from_jax`, the schedule from its step. Returns the
    payload's metadata (epoch, val_loss, mAP keys).
    """
    from yolo_tpu_torch.training.optim import set_schedule_step

    path = Path(path)
    if path.suffix == ".pth":
        payload = torch.load(str(path), map_location="cpu", weights_only=True)
        model.load_state_dict(payload.get("model_state_dict", payload))
        if payload.get("optimizer_state_dict") is not None:
            optimizer.load_state_dict(payload["optimizer_state_dict"])
        if payload.get("scheduler_state_dict") is not None:
            schedule.load_state_dict(payload["scheduler_state_dict"])
    else:
        from yolo_tpu_torch.convert import state_dict_from_jax

        payload = load_checkpoint(path)
        model.load_state_dict(state_dict_from_jax(_variables(payload)))
        if payload.get("optimizer_state_dict") is not None:
            optimizer.state.clear()
            optimizer.state.update(adam_state_from_jax(payload["optimizer_state_dict"], model))
        if "scheduler_state_dict" in payload:
            set_schedule_step(schedule, int(payload["scheduler_state_dict"]["step"]))
    return {k: v for k, v in payload.items()
            if k in ("epoch", "val_loss", "train_loss", *_MAP_KEYS)}
