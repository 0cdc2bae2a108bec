"""Train and eval steps, and the epoch loop with the reference's checkpoint cadence.

Port of yolo_tpu/training/trainer.py. One optimizer step runs eagerly:
uint8 NHWC images -> ``device_normalize`` on the device -> NCHW
(channels_last on the GPU) -> forward, under bf16 autocast with ``use_amp``
-> loss in float32 -> backward -> ``clip_grad_norm_`` -> Adam -> schedule.
BN statistics update in the forward (train mode). The loss parts stay on
the device; the epoch loop syncs with the host only at ``log_interval`` and
at the end of the epoch (the reference syncs five scalars every batch).
``validate(compute_map=True)`` adds the evaluator's keys
(metrics/map.py). With the tracer on (``utils/tracing.py``) a step records
the spans ``train.input``, ``train.forward`` (model and loss),
``train.backward``, ``train.clip`` and ``train.optimizer`` (Adam and the
schedule), in that order.

With ``mesh`` (``parallel.make_mesh``, one process a device; JAX
trainer.py:77-199, 240-297): the head is cut by ``parallel.shard_head``,
the BN statistics are the global batch's (``parallel.sync_batch_norm``),
and the model is wrapped in ``DistributedDataParallel`` over the data group
(``broadcast_buffers=False``: the synchronized BN keeps the buffers equal;
``gradient_as_bucket_view``: the gradients live in DDP's all-reduce
buckets, not in a second copy).
Every rank takes its rows of a global batch (``parallel.batch_slice``), or
its loader yields them (``DataLoader(shard_by_process=...)``). The
gradient is clipped on its global norm, every element counted once: the
replicated gradients' squares plus the fc1/fc2 shards' squares summed over
the model group, as optax's ``clip_by_global_norm`` sees the global
arrays. Logged loss parts are averaged over the data group; ``validate``
sums each part and the valid count over the data group.
"""

from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from yolo_tpu_torch.data.loader import pad_batch
from yolo_tpu_torch.data.transforms import device_normalize
from yolo_tpu_torch.metrics.map import evaluate_model
from yolo_tpu_torch.ops.loss import yolo_loss
from yolo_tpu_torch.training.checkpoints import (
    save_best_map_model,
    save_best_model,
    save_checkpoint,
    save_checkpoint_orbax,
    wait_for_snapshot,
)
from yolo_tpu_torch.training.logging import (
    log_batch_metrics,
    log_epoch_metrics,
    print_epoch_header,
    print_loss_metrics,
    print_map_metrics,
)
from yolo_tpu_torch.utils import tracing

LOSS_KEYS = ("total", "coord", "conf_obj", "conf_noobj", "class")


def _to_host(totals: Dict[str, torch.Tensor], count: int) -> Dict[str, float]:
    """Mean loss parts as floats, with one device-to-host copy."""
    values = (torch.stack([totals[k] for k in LOSS_KEYS]) / max(count, 1)).tolist()
    return dict(zip(LOSS_KEYS, values))


class Trainer:
    """Owns the train and eval steps of one model on one device.

    Args:
        model: a port ``YOLOv1`` already on ``device`` (channels_last on a GPU).
        optimizer, schedule: from ``training.optim.make_optimizer``.
        lambda_coord, lambda_noobj: loss weights (reference 5.0 / 0.5).
        device: where the steps run.
        use_amp: bf16 autocast for the forward (the loss stays float32).
        clip_norm: global gradient-norm limit (reference 10.0).
        mesh: a ``parallel.make_mesh`` mesh, or None for one device. The
            optimizer must have no state yet (resume after building the
            Trainer, through ``training.checkpoints.resume(..., mesh)``).
    """

    def __init__(self, model, optimizer, schedule, lambda_coord: float = 5.0,
                 lambda_noobj: float = 0.5, device: torch.device | str = "cuda",
                 use_amp: bool = False, clip_norm: float = 10.0, mesh=None):
        self.model, self.optimizer, self.schedule = model, optimizer, schedule
        self.lambda_coord, self.lambda_noobj = lambda_coord, lambda_noobj
        self.device = torch.device(device)
        self.use_amp, self.clip_norm = use_amp, clip_norm
        self.memory_format = (torch.channels_last if self.device.type == "cuda"
                              else torch.contiguous_format)
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.mesh, self.forward_model, self.sharded = mesh, model, set()
        self.last_grad_norm: Optional[torch.Tensor] = None
        if mesh is not None:
            from torch.nn.parallel import DistributedDataParallel

            from yolo_tpu_torch.parallel.mesh import (shard_head, sharded_parameters,
                                                      sync_batch_norm)

            if optimizer.state:
                raise ValueError("Trainer(mesh=...) needs an optimizer without state; resume "
                                 "after building the Trainer")
            sync_batch_norm(shard_head(model, mesh), mesh)
            names = sharded_parameters(model)
            self.sharded = {id(p) for n, p in model.named_parameters() if n in names}
            with warnings.catch_warnings():  # broadcast_buffers is deprecated in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                self.forward_model = DistributedDataParallel(
                    model, device_ids=[self.device] if self.device.type == "cuda" else None,
                    process_group=mesh.get_group("data"), broadcast_buffers=False,
                    gradient_as_bucket_view=True)

    @property
    def step(self) -> int:
        """Optimizer steps taken (the schedule's count)."""
        return self.schedule.last_epoch

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        x = device_normalize(x) if x.dtype == torch.uint8 else x.float()
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def _rows(self, *arrays):
        """This rank's rows of global batches (the batches themselves without a mesh)."""
        if self.mesh is None:
            return arrays
        from yolo_tpu_torch.parallel.mesh import batch_slice

        return tuple(batch_slice(self.mesh, a) for a in arrays)

    def _inputs(self, images, targets):
        """The batch on the device: normalized NCHW images and float32 targets."""
        x = self._images(images)
        return x, torch.as_tensor(targets).to(self.device, torch.float32, non_blocking=True)

    def _loss(self, images, targets, sample_mask=None, model=None):
        return self._device_loss(*self._inputs(images, targets), sample_mask, model)

    def _device_loss(self, images, targets, sample_mask=None, model=None):
        """(total, parts) of the batch as :meth:`_inputs` puts it on the device."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.use_amp):
            out = (model or self.model)(images)
        m = self.model
        return yolo_loss(out.float(), targets, S=m.S, B=m.B, C=m.num_classes,
                         lambda_coord=self.lambda_coord, lambda_noobj=self.lambda_noobj,
                         sample_mask=sample_mask)

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the gradients, each element counted once:
        the fc1/fc2 shards' squares are summed over the model group."""
        from yolo_tpu_torch.parallel.mesh import all_reduce_

        norms = {False: [], True: []}
        for p in self.params:
            if p.grad is not None:
                norms[id(p) in self.sharded].append(torch.linalg.vector_norm(p.grad, 2.0))
        sq = [torch.stack(v).square().sum() if v else torch.zeros((), device=self.device)
              for v in (norms[False], norms[True])]
        group = self.mesh.get_group("model") if self.mesh is not None else None
        return (sq[0] + all_reduce_(sq[1], group)).sqrt()

    def _clip(self) -> torch.Tensor:
        if not self.sharded:
            return torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        total = self.grad_norm()
        coef = torch.clamp(self.clip_norm / (total + 1e-6), max=1.0)
        for p in self.params:
            if p.grad is not None:
                p.grad.mul_(coef)
        return total

    def train_step(self, images, targets, local: bool = False) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch; returns the loss parts (device scalars).

        Under a mesh the batch is the global one, of which this rank takes its
        rows, or with ``local`` this rank's rows already. The gradients stay
        in ``.grad`` (after clipping) until the next step, and the norm they
        had before clipping in ``last_grad_norm``.
        """
        if not local:
            images, targets = self._rows(images, targets)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with tracing.span("train.input"):
            images, targets = self._inputs(images, targets)
        with tracing.span("train.forward"):
            total, parts = self._device_loss(images, targets, model=self.forward_model)
        with tracing.span("train.backward"):
            total.backward()
        with tracing.span("train.clip"):
            self.last_grad_norm = self._clip()
        with tracing.span("train.optimizer"):
            self.optimizer.step()
            self.schedule.step()
        return {k: v.detach() for k, v in parts.items()}

    def _host_mean(self, totals: Dict[str, torch.Tensor], count: int) -> Dict[str, float]:
        """Mean loss parts as floats, averaged over the data group."""
        if self.mesh is None or self.mesh["data"].size() == 1:
            return _to_host(totals, count)
        from yolo_tpu_torch.parallel.mesh import all_reduce_

        n_data = self.mesh["data"].size()
        summed = all_reduce_(torch.stack([totals[k] for k in LOSS_KEYS]),
                             self.mesh.get_group("data"))
        return _to_host(dict(zip(LOSS_KEYS, summed / n_data)), count)

    @torch.no_grad()
    def eval_step(self, images, targets, sample_mask=None) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self._loss(images, targets, sample_mask)[1]

    def _sharded_eval_step(self, images, targets, n_valid: int) -> Dict[str, torch.Tensor]:
        """The loss parts of a global batch whose first ``n_valid`` rows are real."""
        from yolo_tpu_torch.parallel.mesh import all_reduce_

        mask = np.arange(images.shape[0]) < n_valid
        images, targets, mask = self._rows(images, targets, mask)
        mask = torch.from_numpy(mask).to(self.device)
        parts = self.eval_step(images, targets, mask)
        count = mask.sum().float()
        sums = torch.stack([parts[k] for k in LOSS_KEYS]) * count.clamp(min=1.0)
        sums = all_reduce_(torch.cat([sums, count[None]]), self.mesh.get_group("data"))
        return dict(zip(LOSS_KEYS, sums[:-1] / sums[-1].clamp(min=1.0)))

    def train_epoch(self, dataloader, epoch: int, writer=None,
                    log_interval: int = 10) -> Dict[str, float]:
        """One epoch; returns the mean loss parts."""
        totals = {k: torch.zeros((), device=self.device) for k in LOSS_KEYS}
        num_batches = 0
        start = time.time()
        n_loader = len(dataloader)
        local = getattr(dataloader, "shard_by_process", None) is not None
        for batch_idx, (images, targets) in enumerate(dataloader):
            parts = self.train_step(images, targets, local=local)
            for k in LOSS_KEYS:
                totals[k] += parts[k]
            num_batches += 1
            if (batch_idx + 1) % log_interval == 0:
                host = self._host_mean(parts, 1)
                print(
                    f"Epoch [{epoch}] Batch [{batch_idx + 1}/{n_loader}] "
                    f"Loss: {host['total']:.4f} "
                    f"(coord: {host['coord']:.4f}, conf_obj: {host['conf_obj']:.4f}, "
                    f"conf_noobj: {host['conf_noobj']:.4f}, class: {host['class']:.4f}) "
                    f"Time: {time.time() - start:.2f}s"
                )
                log_batch_metrics(writer, host, epoch, batch_idx, n_loader)
                start = time.time()
        return self._host_mean(totals, num_batches)

    def validate(self, dataloader, compute_map: bool = False,
                 num_classes: Optional[int] = None) -> Dict[str, float]:
        """Validation loss pass, and with ``compute_map`` the mAP suite.

        Every image counts once: a ragged final batch is zero-padded to the
        loader's batch size and masked out with ``sample_mask``
        (trainer.py:240-297). The mAP pass is ``evaluate_model``'s precise
        path at confidence 0.01 and NMS 0.4, under bf16 autocast with
        ``use_amp``. Under a mesh each rank evaluates its rows of the
        (padded) global batch, and the parts' sums and the valid count are
        all-reduced over the data group: a rank whose rows are all padding
        adds 0.
        """
        totals = {k: torch.zeros((), device=self.device) for k in LOSS_KEYS}
        num_batches = 0
        full_batch = getattr(dataloader, "batch_size", None)
        for images, targets in dataloader:
            n = images.shape[0]
            mask = None
            if full_batch is not None and n < full_batch:
                images, targets, n = pad_batch(images, targets, full_batch)
                mask = torch.arange(full_batch, device=self.device) < n
            if self.mesh is None:
                parts = self.eval_step(images, targets, mask)
            else:
                parts = self._sharded_eval_step(images, targets, n)
            for k in LOSS_KEYS:
                totals[k] += parts[k]
            num_batches += 1
        results = _to_host(totals, num_batches)  # the same on every rank

        if compute_map:
            print("\n  Computing mAP metrics...")
            m = self.model
            map_results = evaluate_model(
                m, dataloader, num_classes=num_classes or m.num_classes, conf_threshold=0.01,
                nms_threshold=0.4, S=m.S, B=m.B, device=self.device, use_amp=self.use_amp,
                mesh=self.mesh)
            for key in ("mAP50:95", "mAP50", "mAP75", "precision", "recall"):
                results[key] = map_results[key]
            for key in ("mAP50:95_small", "mAP50:95_medium", "mAP50:95_large"):
                if key in map_results:
                    results[key] = map_results[key]
        return results


def train(
    trainer: Trainer,
    train_loader,
    val_loader,
    num_epochs: int,
    checkpoint_dir,
    save_frequency: int = 5,
    writer=None,
    compute_map: bool = False,
    map_frequency: int = 5,
    num_classes: int = 20,
    start_epoch: int = 1,
    best_val_loss_init: Optional[float] = None,
    best_map_init: Optional[float] = None,
    profile_dir: Optional[str] = None,
    use_orbax: bool = False,
) -> Dict[str, float]:
    """Epoch loop with the reference's checkpoint cadence (trainer.py:299-423).

    Saves yolo_latest.pth every epoch, yolo_epoch_{N}.pth every
    ``save_frequency`` epochs, yolo_best.pth when the validation loss
    improves and yolo_best_map.pth when mAP50:95 does (under a mesh, the
    gathered state from the first rank); ``use_orbax`` adds an async DCP
    snapshot every epoch, after the best-metric updates so that a resume
    restores the best-so-far tracking (``checkpoints.save_checkpoint_orbax``);
    ``profile_dir`` gets a ``torch.profiler`` trace of the first epoch.
    Returns {best_val_loss, final_train_loss[, best_mAP50:95]}.
    """
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    best_val_loss = best_val_loss_init if best_val_loss_init is not None else float("inf")
    best_map = best_map_init if best_map_init is not None else 0.0
    final_train_loss = None
    model, optimizer = trainer.model, trainer.optimizer

    for epoch in range(start_epoch, num_epochs + 1):
        print_epoch_header(epoch, num_epochs)
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        if profile_dir is not None and epoch == start_epoch:
            train_losses = _profiled_epoch(trainer, train_loader, epoch, writer, profile_dir)
        else:
            train_losses = trainer.train_epoch(train_loader, epoch, writer)
        print_loss_metrics("Training", train_losses, epoch)

        print("\nValidating...")
        should_map = compute_map and (epoch % map_frequency == 0 or epoch == num_epochs)
        val_losses = trainer.validate(val_loader, compute_map=should_map,
                                      num_classes=num_classes)
        print_loss_metrics("Validation", val_losses, epoch)
        print_map_metrics(val_losses)

        lr = optimizer.param_groups[0]["lr"]
        print(f"Learning rate: {lr:.6f}")
        log_epoch_metrics(writer, train_losses, val_losses, lr, epoch)

        mesh = trainer.mesh
        save_checkpoint(checkpoint_dir / "yolo_latest.pth", epoch, model, optimizer,
                        trainer.schedule, train_losses, val_losses, mesh)
        if epoch % save_frequency == 0:
            save_checkpoint(checkpoint_dir / f"yolo_epoch_{epoch}.pth", epoch, model,
                            optimizer, trainer.schedule, train_losses, val_losses, mesh)
        if val_losses["total"] < best_val_loss:
            best_val_loss = val_losses["total"]
            save_best_model(checkpoint_dir / "yolo_best.pth", epoch, model, optimizer,
                            val_losses, "val_loss", best_val_loss, mesh)
        if "mAP50:95" in val_losses and val_losses["mAP50:95"] > best_map:
            best_map = val_losses["mAP50:95"]
            save_best_map_model(checkpoint_dir / "yolo_best_map.pth", epoch, model,
                                optimizer, val_losses, best_map, mesh)
        if use_orbax:
            save_checkpoint_orbax(checkpoint_dir, epoch, trainer, {
                "train_loss": train_losses["total"], "val_loss": val_losses["total"],
                "best_val_loss": best_val_loss, "best_map": best_map})
        final_train_loss = train_losses["total"]
    wait_for_snapshot(trainer)

    results = {"best_val_loss": best_val_loss, "final_train_loss": final_train_loss}
    if best_map > 0:
        results["best_mAP50:95"] = best_map
    return results


def _profiled_epoch(trainer: Trainer, loader, epoch: int, writer, profile_dir) -> Dict:
    """One epoch under ``torch.profiler``; the Chrome trace goes to ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        losses = trainer.train_epoch(loader, epoch, writer)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"train_epoch{epoch}.trace.json"))
    print(f"Profiler trace: {out / f'train_epoch{epoch}.trace.json'}")
    return losses
