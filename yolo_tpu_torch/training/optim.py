"""Adam with L2 weight decay, gradient clipping and a per-step schedule.

Port of yolo_tpu/training/optim.py, the reference recipe (train.py:177-192):

- ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``:
  torch adds ``wd * p`` to the gradient before the moments (L2, not AdamW),
  as optax's ``add_decayed_weights`` before ``scale_by_adam`` does;
- ``torch.nn.utils.clip_grad_norm_(trainable, 10.0)`` before each step
  (the Trainer calls it), as ``clip_by_global_norm`` heads the optax chain;
- the learning rate is multiplied by ``decay_factor`` at each milestone,
  counted in optimizer STEPS: the update made at step count ``k`` (0-based)
  uses ``lr * decay**#{m <= k}``, which is optax's
  ``piecewise_constant_schedule`` at the update count;
- ``freeze_backbone`` sets ``requires_grad=False`` on the backbone's
  parameters and leaves them out of Adam; BN statistics still update in
  train mode, as in torch and the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn


class PiecewiseConstant:
    """``decay ** (number of milestones <= step)``: LambdaLR's factor, picklable."""

    def __init__(self, milestones_steps: Sequence[int], decay_factor: float):
        self.milestones = sorted(int(m) for m in milestones_steps)
        self.decay_factor = decay_factor

    def __call__(self, step: int) -> float:
        return self.decay_factor ** sum(step >= m for m in self.milestones)


def trainable_parameters(model: nn.Module) -> List[nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(
    model: nn.Module,
    lr: float = 1e-4,
    weight_decay: float = 5e-4,
    milestones_steps: Sequence[int] = (),
    decay_factor: float = 0.1,
    freeze_backbone: bool = False,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """(Adam over the trainable parameters, its per-step schedule).

    Step the schedule once after every ``optimizer.step()``.
    """
    if freeze_backbone:
        for p in model.backbone.parameters():
            p.requires_grad_(False)
    optimizer = torch.optim.Adam(trainable_parameters(model), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer, PiecewiseConstant(milestones_steps, decay_factor))
    return optimizer, schedule


def set_schedule_step(schedule: torch.optim.lr_scheduler.LambdaLR, step: int) -> None:
    """Move a schedule (and its optimizer's lr) to after ``step`` updates."""
    schedule.last_epoch = int(step)
    lrs = [base * fn(step) for base, fn in zip(schedule.base_lrs, schedule.lr_lambdas)]
    for group, lr in zip(schedule.optimizer.param_groups, lrs):
        group["lr"] = lr
    schedule._last_lr = lrs
