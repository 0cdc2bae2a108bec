"""Train YOLOv1 with the PyTorch/CUDA port: ``python -m yolo_tpu_torch.train``.

The flags and flow of the repository's ``train.py`` (reference
src/train.py:268-295): VOC 2007 trainval + 2012 train for training, 2012 val
for validation, Adam 1e-4 with weight decay 5e-4, the learning rate x0.1 at
epochs 75 and 105, checkpoints ``yolo_latest``/``yolo_epoch_N``/``yolo_best``
as ``.pth``. ``--device`` defaults to ``cuda`` and fails without a card;
``--use-amp`` means bf16 autocast. ``--resume`` takes the port's ``.pth``
or a JAX ``.ckpt`` (weights, BN statistics, Adam moments and step).

``--compute-map`` adds the mAP suite to the validation pass every
``--map-frequency`` epochs (and the last) and keeps ``yolo_best_map.pth``
by mAP50:95. ``--backbone yolov1`` trains the 24-conv model; ``--remat``
(``block``, the bare flag, or ``stage``) recomputes the ResNet's
activations in the backward pass, with the BN running statistics updated
once a step.

Parallelism: one process a device under ``torchrun`` (``python -m
torch.distributed.run --nproc-per-node N -m yolo_tpu_torch.train ...``).
``--mesh-data`` x ``--mesh-model`` must fill the world (``--mesh-data``
defaults to the world over ``--mesh-model``); ``--batch-size`` is the
global batch and must divide by ``--mesh-data``; each data rank loads its
``batch-size / mesh-data`` images of the shuffled stream (JAX's
``--remote`` keeps the batch per host instead). ``--remote`` is accepted
for parity with JAX's flag and changes nothing: the process group is
joined whenever torchrun started more than one rank, and ``--batch-size``
stays the global batch. Only the first rank prints, logs and writes checkpoints
(the gathered, unsharded state). ``--orbax-checkpoints`` adds an async
``torch.distributed.checkpoint`` snapshot every epoch under
``<checkpoint-dir>/dcp/<epoch>`` (the last 3 kept); ``--resume orbax``
restores the latest.

Refused with a message: ``--download-data`` needs a network; ``--remat``
and ``--pretrained-backbone`` need ``--backbone resnet``.
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train YOLOv1 (PyTorch/CUDA port)")
    p.add_argument("--data-root", default="./data", help="VOC dataset root")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-workers", type=int, default=32)
    p.add_argument("--worker-type", default="auto", choices=["auto", "thread", "process"],
                   help="data-loader workers: spawned processes, threads, or auto "
                        "(processes iff the host has more than one CPU)")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--epochs", type=int, default=135)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--lr-decay-epochs", default="75,105")
    p.add_argument("--lr-decay-factor", type=float, default=0.1)
    p.add_argument("--lambda-coord", type=float, default=5.0)
    p.add_argument("--lambda-noobj", type=float, default=0.5)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--save-frequency", type=int, default=10)
    p.add_argument("--resume", default=None,
                   help="'true' for <checkpoint-dir>/yolo_latest.pth, 'orbax' for the latest "
                        "DCP snapshot, or a .pth/.ckpt path")
    p.add_argument("--log-dir", default="runs")
    p.add_argument("--experiment-name", default=None)
    p.add_argument("--tensorboard", action="store_true",
                   help="accepted no-op; logging is on by default")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="disable the TensorBoard/JSONL metric writer")
    p.add_argument("--compute-map", action="store_true",
                   help="compute the mAP suite during validation")
    p.add_argument("--map-frequency", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--download-data", action="store_true", help="needs a network; refused")
    p.add_argument("--remote", action="store_true",
                   help="accepted for parity; changes nothing (every torchrun world of more "
                        "than one rank joins the process group; --batch-size stays global)")
    p.add_argument("--use-amp", action="store_true", help="bf16 autocast for the forward")
    p.add_argument("--backbone", default="resnet", choices=["resnet", "yolov1"])
    p.add_argument("--pretrained-backbone", default=None,
                   help="path to a torchvision resnet50 .pth for transfer learning")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis size (default: the world / --mesh-model)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis size for the FC head")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the first training epoch to DIR")
    p.add_argument("--remat", nargs="?", const="block", default="none",
                   choices=["none", "block", "stage"],
                   help="recompute the ResNet's activations in the backward pass: 'block' "
                        "(bare --remat) around each bottleneck, 'stage' around each stage")
    p.add_argument("--orbax-checkpoints", action="store_true",
                   help="also write async DCP snapshots every epoch "
                        "(<checkpoint-dir>/dcp/<epoch>); resume with --resume orbax")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.backbone != "resnet" and (args.remat != "none" or args.pretrained_backbone):
        raise SystemExit("--remat and --pretrained-backbone (a torchvision resnet50) need "
                         "--backbone resnet")
    if args.download_data:
        raise SystemExit("--download-data needs a network; put the VOC tree under --data-root")


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)

    import torch

    from yolo_tpu_torch.parallel.distributed import run_on_mesh

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")
    return run_on_mesh(functools.partial(_train, args), args.device, args.mesh_data,
                       args.mesh_model, args.batch_size)


def _train(args, mesh, device, first: bool):
    import torch

    from yolo_tpu_torch.data import DataLoader, create_voc_datasets
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.models.layers import Dropout
    from yolo_tpu_torch.training.checkpoints import find_resume_path, resume
    from yolo_tpu_torch.training.logging import (
        MetricWriter,
        count_params,
        log_hyperparameters,
        print_dataset_info,
        print_model_info,
        print_tensorboard_info,
        print_training_config,
    )
    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer, train

    checkpoint_dir = Path(args.checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    writer = None
    if mesh is not None:
        print(f"Mesh: {mesh} (backend {torch.distributed.get_backend()})")
    if first and not args.no_tensorboard:
        from datetime import datetime

        exp_name = args.experiment_name or ("yolo_" + datetime.now().strftime("%Y%m%d_%H%M%S"))
        log_dir = Path(args.log_dir) / exp_name
        writer = MetricWriter(log_dir)
        print_tensorboard_info(log_dir, args.log_dir)

    size = (args.image_size, args.image_size)
    print("\nCreating training dataset (VOC 2007 trainval + VOC 2012 train)...")
    train_dataset = create_voc_datasets([("2007", "trainval"), ("2012", "train")],
                                        root=args.data_root, augment=not args.no_augment,
                                        target_size=size, normalize_host=False)
    print("Creating validation dataset (VOC 2012 val)...")
    val_dataset = create_voc_datasets([("2012", "val")], root=args.data_root, augment=False,
                                      target_size=size, normalize_host=False)
    print_dataset_info(len(train_dataset), len(val_dataset), not args.no_augment)
    # Under a mesh each data rank loads its rows of every global batch; the
    # validation loader yields global batches, which the Trainer slices.
    shard, rank_batch = None, args.batch_size
    if mesh is not None and mesh["data"].size() > 1:
        shard = (mesh.get_local_rank("data"), mesh["data"].size())
        rank_batch = args.batch_size // shard[1]
    train_loader = DataLoader(train_dataset, batch_size=rank_batch, shuffle=True,
                              num_workers=args.num_workers, drop_last=True, seed=args.seed,
                              worker_type=args.worker_type, shard_by_process=shard)
    # drop_last=False: every validation image counts (the ragged batch is masked).
    val_loader = DataLoader(val_dataset, batch_size=args.batch_size, shuffle=False,
                            num_workers=args.num_workers, drop_last=False,
                            worker_type=args.worker_type)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = create_model(args.backbone, args.num_classes, 7, 2, device=device,
                         generator=generator, image_size=args.image_size, remat=args.remat)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.manual_seed(args.seed)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    if args.pretrained_backbone:
        from yolo_tpu_torch.convert import state_dict_from_torchvision_resnet50

        sd = torch.load(args.pretrained_backbone, map_location="cpu", weights_only=True)
        missing, _ = model.load_state_dict(state_dict_from_torchvision_resnet50(sd),
                                           strict=False)
        if any(k.startswith("backbone.") for k in missing):
            raise SystemExit(f"{args.pretrained_backbone} lacks backbone weights: "
                             f"{[k for k in missing if k.startswith('backbone.')][:5]}")
        print(f"Loaded pretrained backbone from {args.pretrained_backbone}")

    milestones_epochs = [int(x) for x in args.lr_decay_epochs.split(",") if x.strip()]
    steps_per_epoch = len(train_loader)
    optimizer, schedule = make_optimizer(
        model, args.lr, args.weight_decay, [m * steps_per_epoch for m in milestones_epochs],
        args.lr_decay_factor, freeze_backbone=args.freeze_backbone)
    print_model_info(*count_params(model, args.freeze_backbone))
    trainer = Trainer(model, optimizer, schedule, lambda_coord=args.lambda_coord,
                      lambda_noobj=args.lambda_noobj, device=device, use_amp=args.use_amp,
                      mesh=mesh)

    start_epoch, best_val_loss, best_map = 1, None, None
    resume_path = None
    if args.resume == "orbax":
        from yolo_tpu_torch.training.checkpoints import restore_checkpoint_orbax

        try:
            step, metrics = restore_checkpoint_orbax(checkpoint_dir, trainer)
        except FileNotFoundError as exc:
            raise SystemExit(f"--resume orbax: {exc}")
        start_epoch = step + 1
        best_val_loss = metrics.get("best_val_loss", metrics.get("val_loss"))
        best_map = metrics.get("best_map") or None
        print(f"\nResumed from DCP snapshot {step}, starting at {start_epoch} "
              f"(optimizer step {trainer.step})")
    else:
        resume_path = find_resume_path(args.resume, checkpoint_dir)
    if resume_path is not None:
        if resume_path.exists():
            print(f"\nResuming from checkpoint: {resume_path}")
            try:
                meta = resume(resume_path, model, optimizer, schedule, mesh)
            except ValueError as exc:
                raise SystemExit(f"Cannot resume from {resume_path}: {exc}")
            start_epoch = int(meta.get("epoch", 0)) + 1
            best_val_loss = meta.get("val_loss")
            best_map = meta.get("mAP50:95")
            print(f"Resumed from epoch {meta.get('epoch', 0)}, starting at {start_epoch}"
                  f" (optimizer step {trainer.step})")
        else:
            print(f"\nWarning: resume checkpoint not found at {resume_path}")
            print("Starting training from scratch")

    print_training_config(args)
    hparams = {k: v for k, v in vars(args).items() if isinstance(v, (int, float, str, bool))}
    try:
        final_metrics = train(
            trainer, train_loader, val_loader, num_epochs=args.epochs,
            checkpoint_dir=checkpoint_dir, save_frequency=args.save_frequency, writer=writer,
            compute_map=args.compute_map, map_frequency=args.map_frequency,
            num_classes=args.num_classes, start_epoch=start_epoch,
            best_val_loss_init=best_val_loss, best_map_init=best_map,
            profile_dir=args.profile, use_orbax=args.orbax_checkpoints,
        )
        log_hyperparameters(writer, hparams, final_metrics)
    finally:
        if writer is not None:
            writer.close()
        train_loader.close()
        val_loader.close()
    print("\nTraining completed!")
    return final_metrics


if __name__ == "__main__":
    main()
