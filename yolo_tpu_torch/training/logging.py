"""Console + TensorBoard-compatible metric logging.

Port of yolo_tpu/training/logging.py (parity with reference
src/yolo/training/logging.py:13-264): the same console printers and the
same TensorBoard scalar layout (``batch/loss_*`` at global_step, per-epoch
train/val/lr/mAP/size scalars, hparams summary). Written on top of the
``tensorboard`` package's event writer when it imports, and always mirrored
to ``metrics.jsonl``, so headless environments get machine-readable
metrics. :func:`count_params` counts an ``nn.Module``'s parameters.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricWriter:
    """Minimal SummaryWriter: add_scalar / add_hparams / flush / close.

    Writes real tfevents files when the ``tensorboard`` package is available,
    and always mirrors scalars to ``metrics.jsonl`` in the log dir.
    """

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )

            self._Event = Event
            self._Summary = Summary
            self._tb = EventFileWriter(str(self.log_dir))
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step)}) + "\n"
        )
        if self._tb is not None:
            summary = self._Summary(
                value=[self._Summary.Value(tag=tag, simple_value=value)]
            )
            event = self._Event(
                wall_time=time.time(), step=int(step), summary=summary
            )
            self._tb.add_event(event)

    def add_hparams(self, hparams: Dict, metrics: Dict) -> None:
        """Log an hparams run summary.

        Writes the real TensorBoard hparams-plugin protos (experiment /
        session-start / session-end + metric scalars in a timestamped
        sub-run), matching what the reference's ``writer.add_hparams``
        produces (src/yolo/training/logging.py:241-264), plus the JSONL
        mirror for headless environments.
        """
        record = {
            "hparams": {k: _jsonable(v) for k, v in hparams.items()},
            "final_metrics": {k: _jsonable(v) for k, v in metrics.items()},
        }
        self._jsonl.write(json.dumps({"hparams_summary": record}) + "\n")
        if self._tb is None:
            return
        try:
            self._write_hparams_protos(hparams, metrics)
        except Exception:
            # Plugin protos unavailable: scalar mirror keeps the data visible.
            for key, val in metrics.items():
                try:
                    self.add_scalar(f"hparams/{key}", float(val), 0)
                except (TypeError, ValueError):
                    pass

    def _write_hparams_protos(self, hparams: Dict, metrics: Dict) -> None:
        from tensorboard.plugins.hparams import api_pb2
        from tensorboard.plugins.hparams import summary as hp_summary
        from tensorboard.summary.writer.event_file_writer import (
            EventFileWriter,
        )

        def _hparam_value(v):
            if isinstance(v, bool):
                return api_pb2.DataType.DATA_TYPE_BOOL, bool(v)
            if isinstance(v, (int, float)):
                return api_pb2.DataType.DATA_TYPE_FLOAT64, float(v)
            return api_pb2.DataType.DATA_TYPE_STRING, str(v)

        clean = {k: _hparam_value(v) for k, v in hparams.items()}
        numeric_metrics = {}
        for k, v in metrics.items():
            try:
                numeric_metrics[k] = float(v)
            except (TypeError, ValueError):
                continue

        exp = hp_summary.experiment_pb(
            hparam_infos=[
                api_pb2.HParamInfo(name=k, type=t) for k, (t, _) in clean.items()
            ],
            metric_infos=[
                api_pb2.MetricInfo(name=api_pb2.MetricName(tag=k))
                for k in numeric_metrics
            ],
        )
        ssi = hp_summary.session_start_pb(
            hparams={k: v for k, (_, v) in clean.items()}
        )
        sei = hp_summary.session_end_pb(api_pb2.Status.STATUS_SUCCESS)

        # Like torch's add_hparams: the session is a timestamped child run so
        # the plugin pairs its metrics with the session scalars.
        sub_dir = self.log_dir / time.strftime("%b%d_%H-%M-%S")
        sub_dir.mkdir(parents=True, exist_ok=True)
        sub_writer = EventFileWriter(str(sub_dir))
        try:
            for summary in (exp, ssi, sei):
                sub_writer.add_event(
                    self._Event(
                        wall_time=time.time(), step=0,
                        summary=self._to_summary_proto(summary),
                    )
                )
            for key, val in numeric_metrics.items():
                sub_writer.add_event(
                    self._Event(
                        wall_time=time.time(), step=0,
                        summary=self._Summary(
                            value=[
                                self._Summary.Value(tag=key, simple_value=val)
                            ]
                        ),
                    )
                )
        finally:
            sub_writer.close()

    def _to_summary_proto(self, summary):
        """hparams summaries are tensorboard Summary protos already; the
        event writer needs the compat proto type, so round-trip if needed."""
        if isinstance(summary, self._Summary):
            return summary
        clone = self._Summary()
        clone.ParseFromString(summary.SerializeToString())
        return clone

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


# ----------------------------------------------------------------- TB loggers
def log_batch_metrics(
    writer: Optional[MetricWriter],
    loss_dict: Dict[str, float],
    epoch: int,
    batch_idx: int,
    num_batches: int,
) -> None:
    """Per-batch loss components at global step (reference logging.py:153-178)."""
    if writer is None:
        return
    global_step = (epoch - 1) * num_batches + batch_idx
    for key, value in loss_dict.items():
        writer.add_scalar(f"batch/loss_{key}", float(value), global_step)


def log_epoch_metrics(
    writer: Optional[MetricWriter],
    train_losses: Dict[str, float],
    val_losses: Dict[str, float],
    learning_rate: float,
    epoch: int,
) -> None:
    """Per-epoch scalars incl. mAP/size metrics (reference logging.py:181-238).

    Tag-for-tag parity with the reference's epoch scalar layout
    (``epoch/train_loss_*``, ``epoch/val_loss_*``, ``epoch/learning_rate``,
    ``epoch/mAP*`` + size variants), so TB runs diff cleanly against a
    reference run.
    """
    if writer is None:
        return
    loss_keys = ("total", "coord", "conf_obj", "conf_noobj", "class")
    for key in loss_keys:
        if key in train_losses:
            writer.add_scalar(
                f"epoch/train_loss_{key}", float(train_losses[key]), epoch
            )
    for key in loss_keys:
        if key in val_losses:
            writer.add_scalar(
                f"epoch/val_loss_{key}", float(val_losses[key]), epoch
            )
    writer.add_scalar("epoch/learning_rate", float(learning_rate), epoch)
    if "mAP50:95" in val_losses:
        # mAP50/mAP75 are absent when the evaluator ran with custom
        # iou_thresholds that exclude 0.5/0.75 (metrics/map.py) — log only
        # what exists.
        for key in ("mAP50:95", "mAP50", "mAP75", "precision", "recall"):
            if key in val_losses:
                writer.add_scalar(
                    f"epoch/{key}", float(val_losses[key]), epoch
                )
        for size in ("small", "medium", "large"):
            if f"mAP50:95_{size}" in val_losses:
                writer.add_scalar(
                    f"epoch/mAP50:95_{size}",
                    float(val_losses[f"mAP50:95_{size}"]),
                    epoch,
                )


def log_hyperparameters(
    writer: Optional[MetricWriter], hparams: Dict, final_metrics: Dict
) -> None:
    """Run summary (reference logging.py:241-264)."""
    if writer is None:
        return
    writer.add_hparams(hparams, final_metrics)


# -------------------------------------------------------------- console output
def print_epoch_header(epoch: int, num_epochs: int) -> None:
    print(f"\n{'=' * 60}\nEpoch {epoch}/{num_epochs}\n{'=' * 60}")


def print_loss_metrics(phase: str, losses: Dict[str, float], epoch: int) -> None:
    print(
        f"{phase} — epoch {epoch}: loss {losses['total']:.4f} "
        f"(coord: {losses['coord']:.4f}, conf_obj: {losses['conf_obj']:.4f}, "
        f"conf_noobj: {losses['conf_noobj']:.4f}, class: {losses['class']:.4f})"
    )


def print_map_metrics(val_losses: Dict[str, float]) -> None:
    if "mAP50:95" not in val_losses:
        return
    print(
        f"  mAP@0.5:0.95: {val_losses['mAP50:95']:.4f} | "
        f"mAP@0.5: {val_losses['mAP50']:.4f} | mAP@0.75: {val_losses['mAP75']:.4f}"
    )
    if "precision" in val_losses:
        print(
            f"  precision: {val_losses['precision']:.4f} | "
            f"recall: {val_losses['recall']:.4f}"
        )
    for size in ("small", "medium", "large"):
        key = f"mAP50:95_{size}"
        if key in val_losses:
            print(f"  {key}: {val_losses[key]:.4f}")


def print_checkpoint_saved(
    path, metric_name: Optional[str] = None, metric_value: Optional[float] = None
) -> None:
    if metric_name is not None:
        print(f"Saved checkpoint: {path} ({metric_name}: {metric_value:.4f})")
    else:
        print(f"Saved checkpoint: {path}")


def print_model_info(total_params: int, trainable_params: int) -> None:
    """Model parameter summary (reference logging.py:84-96)."""
    print("\nCreating model...")
    print(f"Total parameters: {total_params:,}")
    print(f"Trainable parameters: {trainable_params:,}")
    print(f"Frozen parameters: {total_params - trainable_params:,}")


def count_params(model, freeze_backbone: bool = False):
    """(total, trainable) parameter counts of an ``nn.Module`` with a ``backbone``."""
    total = sum(p.numel() for p in model.parameters())
    frozen = (
        sum(p.numel() for p in model.backbone.parameters()) if freeze_backbone else 0
    )
    return total, total - frozen


def print_dataset_info(
    train_size: int, val_size: int, augmented: bool
) -> None:
    print(
        f"Datasets — train: {train_size} images (augment={augmented}), "
        f"val: {val_size} images"
    )


def print_training_config(args) -> None:
    print("\nTraining configuration:")
    for key in sorted(vars(args)):
        print(f"  {key}: {getattr(args, key)}")


def print_tensorboard_info(log_dir, root_log_dir) -> None:
    print(f"TensorBoard logging to {log_dir} (run: tensorboard --logdir {root_log_dir})")
