"""Training: ``optim`` (Adam, clipping, per-step schedule), ``trainer``
(train/eval steps and the epoch loop), ``checkpoints`` (``.pth`` files, JAX
``.ckpt`` resume) and ``logging`` (metric writer, console printers).

The JAX package's ``yolo_tpu.training`` names resolve here on first use
(the submodule is imported then), so loading checkpoints for inference
stays light. JAX's ``TrainState`` has no counterpart: the ``Trainer`` holds
the module and the optimizer.
"""

from importlib import import_module

_LAZY = {
    "MetricWriter": "logging",
    "Trainer": "trainer",
    "load_checkpoint": "checkpoints",
    "log_batch_metrics": "logging",
    "log_epoch_metrics": "logging",
    "log_hyperparameters": "logging",
    "make_optimizer": "optim",
    "print_checkpoint_saved": "logging",
    "print_epoch_header": "logging",
    "print_loss_metrics": "logging",
    "print_map_metrics": "logging",
    "save_best_map_model": "checkpoints",
    "save_best_model": "checkpoints",
    "save_checkpoint": "checkpoints",
    "train": "trainer",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_LAZY)
