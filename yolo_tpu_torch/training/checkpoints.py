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
Only open checkpoints you trust: unpickling can run code.

Under a mesh (``mesh=``, ``parallel.make_mesh``) the files hold the
**gathered** unsharded state (``parallel.full_state_dict``, the Adam
moments likewise), written by the first rank only; every rank reaches the
same barrier after it. :func:`resume` cuts the unsharded state (a ``.pth``
or a JAX ``.ckpt``, Adam moments like their params) to this rank's blocks.

JAX's orbax snapshots become ``torch.distributed.checkpoint`` (DCP)
snapshots, under the same names for ``--orbax-checkpoints`` / ``--resume
orbax``: :func:`save_checkpoint_orbax` writes ``<dir>/dcp/<step>/``
asynchronously (``dcp.async_save``) and keeps the last 3;
:func:`restore_checkpoint_orbax` loads one in place. A snapshot holds the
params, BN buffers, Adam state, the schedule's step, each Dropout
generator's state and the metrics. The fc1/fc2 shards enter it as
``DTensor``s on the model axis, so each rank writes its own block and
nothing is written twice.
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


def load_model(path: str | Path, backbone: Optional[str] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], Dict[str, Any]]:
    """(the port's state dict, ``create_model``'s layout keywords, the
    payload's epoch / val_loss / mAP keys) from a ``.pth`` (reference names)
    or a JAX ``.ckpt`` of either model, read once.

    The layout is ``convert.model_layout``'s: the backbone, the image size
    and the ResNet's stage sizes. ``backbone`` given, a checkpoint of the
    other one raises ``ValueError``.
    """
    from yolo_tpu_torch.convert import model_layout

    path = Path(path)
    if path.suffix == ".pth":
        payload = torch.load(str(path), map_location="cpu", weights_only=True)
        state_dict = payload.get("model_state_dict", payload)
    else:
        from yolo_tpu_torch.convert import state_dict_from_jax

        payload = load_checkpoint(path)
        state_dict = state_dict_from_jax(_variables(payload))
    layout = model_layout(state_dict)
    if backbone is not None and layout["backbone"] != backbone:
        raise ValueError(f"{path} holds a {layout['backbone']} model, not {backbone}; pass "
                         f"--backbone {layout['backbone']}")
    meta = {k: payload[k] for k in ("epoch", "val_loss", *_MAP_KEYS) if k in payload}
    return state_dict, layout, meta


# ------------------------------------------------------------------ saving
def _first_rank() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _save(path: Path, payload: Dict[str, Any]) -> None:
    """Write ``payload`` from the first rank; every rank waits for it."""
    path = Path(path)
    if _first_rank():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # atomic on POSIX: no torn checkpoints on preemption
    _barrier()


def _payload(epoch, model, optimizer, val_losses, mesh) -> Dict[str, Any]:
    from yolo_tpu_torch.parallel.mesh import full_optimizer_state_dict, full_state_dict

    payload = {
        "version": CHECKPOINT_VERSION,
        "epoch": epoch,
        "model_state_dict": full_state_dict(model, mesh),
        "optimizer_state_dict": full_optimizer_state_dict(optimizer, model, mesh),
        "val_loss": float(val_losses["total"]),
    }
    if "mAP50:95" in val_losses:
        payload.update({k: float(val_losses[k]) for k in _MAP_KEYS})
    return payload


def save_checkpoint(checkpoint_path, epoch: int, model, optimizer, schedule,
                    train_losses: Dict[str, float], val_losses: Dict[str, float],
                    mesh=None) -> None:
    """Full checkpoint: model, optimizer and schedule (resume-capable)."""
    payload = _payload(epoch, model, optimizer, val_losses, mesh)
    payload["scheduler_state_dict"] = schedule.state_dict()
    payload["train_loss"] = float(train_losses["total"])
    _save(Path(checkpoint_path), payload)
    print_checkpoint_saved(checkpoint_path)


def save_best_model(checkpoint_path, epoch: int, model, optimizer,
                    val_losses: Dict[str, float], metric_name: str,
                    metric_value: float, mesh=None) -> None:
    """Best-by-validation-loss checkpoint (no schedule state, as the reference)."""
    _save(Path(checkpoint_path), _payload(epoch, model, optimizer, val_losses, mesh))
    print_checkpoint_saved(checkpoint_path, metric_name, metric_value)


def save_best_map_model(checkpoint_path, epoch: int, model, optimizer,
                        val_losses: Dict[str, float], map_value: float, mesh=None) -> None:
    """Best-by-mAP50:95 checkpoint."""
    _save(Path(checkpoint_path), _payload(epoch, model, optimizer, val_losses, mesh))
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


def adam_state_from_jax(opt_state, model, mesh=None
                        ) -> Dict[torch.Tensor, Dict[str, torch.Tensor]]:
    """torch Adam state for ``model``'s trainable parameters from a JAX opt_state.

    optax's ``ScaleByAdamState(count, mu, nu)`` holds the moments as
    parameter trees; they go through the same per-parameter layout change as
    the weights (``convert.params_state_dict_from_jax``) into ``exp_avg`` and
    ``exp_avg_sq``, and ``count`` becomes ``step``. Under a mesh the
    moments of the fc1/fc2 shards are cut like their params.
    """
    from yolo_tpu_torch.convert import params_state_dict_from_jax
    from yolo_tpu_torch.parallel.mesh import local_shard

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
            "exp_avg": torch.empty_like(p).copy_(
                local_shard(model, mesh, name, mu[name]).reshape(p.shape)),
            "exp_avg_sq": torch.empty_like(p).copy_(
                local_shard(model, mesh, name, nu[name]).reshape(p.shape)),
        }
    return state


def resume(path: str | Path, model, optimizer, schedule, mesh=None) -> Dict[str, Any]:
    """Restore weights, BN statistics, optimizer and schedule from a checkpoint.

    ``.pth``: the port's own files (or a reference ``.pth``: weights only).
    ``.ckpt``: a JAX checkpoint; the weights and statistics through
    ``state_dict_from_jax``, Adam's moments and step through
    :func:`adam_state_from_jax`, the schedule from its step. Under a mesh
    every rank takes its blocks of the unsharded state. Returns the
    payload's metadata (epoch, val_loss, mAP keys).
    """
    from yolo_tpu_torch.parallel.mesh import load_full_state_dict, shard_optimizer_state_
    from yolo_tpu_torch.training.optim import set_schedule_step

    path = Path(path)
    if path.suffix == ".pth":
        payload = torch.load(str(path), map_location="cpu", weights_only=True)
        load_full_state_dict(model, payload.get("model_state_dict", payload), mesh)
        if payload.get("optimizer_state_dict") is not None:
            optimizer.load_state_dict(payload["optimizer_state_dict"])
            shard_optimizer_state_(optimizer, model, mesh)
        if payload.get("scheduler_state_dict") is not None:
            schedule.load_state_dict(payload["scheduler_state_dict"])
    else:
        from yolo_tpu_torch.convert import state_dict_from_jax

        payload = load_checkpoint(path)
        load_full_state_dict(model, state_dict_from_jax(_variables(payload)), mesh)
        if payload.get("optimizer_state_dict") is not None:
            optimizer.state.clear()
            optimizer.state.update(adam_state_from_jax(payload["optimizer_state_dict"], model,
                                                       mesh))
        if "scheduler_state_dict" in payload:
            set_schedule_step(schedule, int(payload["scheduler_state_dict"]["step"]))
    return {k: v for k, v in payload.items()
            if k in ("epoch", "val_loss", "train_loss", *_MAP_KEYS)}


# ---------------------------------------------------------- DCP snapshots
SNAPSHOTS_KEPT = 3
_METRIC_KEYS = ("train_loss", "val_loss", "best_val_loss", "best_map")


def _snapshot_root(checkpoint_dir) -> Path:
    return (Path(checkpoint_dir) / "dcp").absolute()


def _snapshot_state(trainer) -> Dict[str, Any]:
    """The snapshot's tree, sharing storage with the trainer's tensors so
    that ``dcp.load`` restores in place (Adam state is made where missing:
    zeros and step 0, which is what Adam's first step makes)."""
    from torch.distributed.tensor import DTensor, Shard

    from yolo_tpu_torch.models.layers import Dropout
    from yolo_tpu_torch.parallel.mesh import sharded_parameters

    model, mesh = trainer.model, trainer.mesh
    dims = sharded_parameters(model)

    def placed(name: str, t: torch.Tensor):
        dim = dims.get(name)
        if mesh is None or dim is None:
            return t
        return DTensor.from_local(t, mesh["model"], [Shard(dim)], run_check=False)

    names = {id(p): n for n, p in model.named_parameters()}
    optim = {}
    for p in trainer.params:
        entry = trainer.optimizer.state[p]
        if not entry:
            entry.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                         exp_avg_sq=torch.zeros_like(p))
        name = names[id(p)]
        optim[name] = {"step": entry["step"], "exp_avg": placed(name, entry["exp_avg"]),
                       "exp_avg_sq": placed(name, entry["exp_avg_sq"])}
    return {
        "model": {k: placed(k, v) for k, v in model.state_dict().items()},
        "optim": optim,
        "schedule_step": torch.tensor(trainer.schedule.last_epoch),
        "dropout": {name: m.generator_on(trainer.device).get_state()
                    for name, m in model.named_modules() if isinstance(m, Dropout)},
    }


def wait_for_snapshot(trainer) -> None:
    """Finish the trainer's pending snapshot, then keep the last
    :data:`SNAPSHOTS_KEPT` (the first rank deletes the older ones)."""
    import shutil

    pending = getattr(trainer, "pending_snapshot", None)
    if pending is None:
        return
    future, root = pending
    future.result()
    trainer.pending_snapshot = None
    if _first_rank():
        steps = sorted(int(p.name) for p in root.iterdir() if p.name.isdigit())
        for step in steps[:-SNAPSHOTS_KEPT]:
            shutil.rmtree(root / str(step), ignore_errors=True)


def save_checkpoint_orbax(checkpoint_dir, step: int, trainer,
                          metrics: Optional[Dict[str, float]] = None) -> None:
    """Start an async DCP snapshot of ``trainer`` at ``<dir>/dcp/<step>/``.

    The tensors are staged to host memory before this returns; the files
    are written in the background. The previous snapshot is finished first
    (:func:`wait_for_snapshot`); call that once more after the last one.
    """
    import torch.distributed.checkpoint as dcp

    wait_for_snapshot(trainer)
    root = _snapshot_root(checkpoint_dir)
    state = _snapshot_state(trainer)
    state["metrics"] = {k: torch.tensor(float((metrics or {}).get(k, 0.0)),
                                        dtype=torch.float64) for k in _METRIC_KEYS}
    group = None
    if trainer.mesh is not None:
        from yolo_tpu_torch.parallel.mesh import snapshot_group

        group = snapshot_group(trainer.mesh)
    future = dcp.async_save(state, checkpoint_id=str(root / str(int(step))),
                            process_group=group)
    trainer.pending_snapshot = (future, root)


def restore_checkpoint_orbax(checkpoint_dir, trainer, step: Optional[int] = None):
    """Load a :func:`save_checkpoint_orbax` snapshot into ``trainer`` in place
    (the latest without ``step``). Returns (step, metrics)."""
    import torch.distributed.checkpoint as dcp

    from yolo_tpu_torch.models.layers import Dropout
    from yolo_tpu_torch.training.optim import set_schedule_step

    root = _snapshot_root(checkpoint_dir)
    if step is None:
        steps = [int(p.name) for p in root.iterdir() if p.name.isdigit()] \
            if root.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no DCP snapshot under {root}")
        step = max(steps)
    state = _snapshot_state(trainer)
    state["metrics"] = {k: torch.zeros((), dtype=torch.float64) for k in _METRIC_KEYS}
    dcp.load(state, checkpoint_id=str(root / str(int(step))))
    set_schedule_step(trainer.schedule, int(state["schedule_step"]))
    for name, m in trainer.model.named_modules():
        if isinstance(m, Dropout):
            m.generator_on(trainer.device).set_state(state["dropout"][name])
    return int(step), {k: float(v) for k, v in state["metrics"].items()}
