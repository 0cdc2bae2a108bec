"""Training: ``optim`` (Adam, clipping, per-step schedule), ``trainer``
(train/eval steps and the epoch loop), ``checkpoints`` (``.pth`` files, JAX
``.ckpt`` resume) and ``logging`` (metric writer, console printers).

Nothing is imported here, so loading checkpoints for inference stays light.
"""
