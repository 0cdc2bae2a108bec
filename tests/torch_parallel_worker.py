"""Rank bodies of the parallel CPU tests: gloo worlds spawned from a test.

``torch.multiprocessing.spawn`` imports this module (not the test file) in
every child, so the children load torch and the port only, never JAX. A
test writes its inputs with ``torch.save`` and calls :func:`spawn`; every
rank runs one task and writes ``rank{r}.pt`` beside the inputs, which the
test reads back.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

STAGES, SIZE = (1, 1, 1, 1), 64


def start(task: str, n_data: int, n_model: int, workdir: Path):
    """Start ``task`` on a gloo world of ``n_data * n_model`` CPU ranks (the
    test can compute its references meanwhile); :func:`finish` waits."""
    import torch.multiprocessing as mp

    world = n_data * n_model
    ctx = mp.start_processes(_main, args=(world, str(workdir), task, n_data, n_model),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, task, world, Path(workdir), time.monotonic()


def finish(handle, timeout: float = 400.0):
    """Each rank's output of a :func:`start`, in rank order."""
    ctx, task, world, workdir, t0 = handle
    while not ctx.join(timeout=1.0):
        if time.monotonic() > t0 + timeout:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task} on a world of {world} took over {timeout} s")
    outs = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for name in [f"rank{r}.pt" for r in range(world)] + ["inputs.pt", "store"]:
        (workdir / name).unlink(missing_ok=True)  # checkpoint-sized: keep the tmp dir small
    return outs


def spawn(task: str, n_data: int, n_model: int, workdir: Path, timeout: float = 400.0):
    """:func:`start` then :func:`finish`."""
    return finish(start(task, n_data, n_model, workdir), timeout)


def _main(rank: int, world: int, workdir: str, task: str, n_data: int, n_model: int):
    import torch.distributed as dist

    from yolo_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{workdir}/store", world_size=world,
                           rank=rank)
    try:
        mesh = make_mesh(n_data, n_model, "cpu")
        cfg = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
        out = TASKS[task](mesh, cfg, Path(workdir))
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tiny_model(state_dict=None, fused_bn=False):
    from yolo_tpu_torch.models import create_model

    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE, fused_bn=fused_bn)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def make_trainer(model, mesh, optimizer="adam", lr=1e-4, clip_norm=10.0):
    """A CPU Trainer with the reference's Adam recipe, or plain SGD."""
    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer

    if optimizer == "adam":
        opt, schedule = make_optimizer(model, lr, 5e-4, milestones_steps=[])
    else:
        opt = torch.optim.SGD(model.parameters(), lr=lr)
        schedule = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
    return Trainer(model, opt, schedule, device="cpu", clip_norm=clip_norm, mesh=mesh)


def _dropout(model):
    from yolo_tpu_torch.models.layers import Dropout

    return next(m for m in model.modules() if isinstance(m, Dropout))


def run_steps(trainer, cfg):
    """A train step on the global batch for each global dropout mask of
    ``cfg["masks"]``; returns (loss parts a step, pre-clip grad norms)."""
    losses, norms = [], []
    drop = _dropout(trainer.model)
    for mask in cfg["masks"]:
        drop.fixed_mask = torch.from_numpy(mask)
        parts = trainer.train_step(cfg["images"], cfg["targets"])
        losses.append({k: float(v) for k, v in parts.items()})
        norms.append(float(trainer.last_grad_norm))
    drop.fixed_mask = None
    return losses, norms


# ----------------------------------------------------------------- tasks
def task_mesh(mesh, cfg, workdir, model):
    """Coordinates, group sizes, batch rows, shard shapes, and the gathered
    state of ``model`` (a Trainer's, sharded, not stepped yet) against the
    unsharded one, bit for bit."""
    from yolo_tpu_torch.parallel import batch_slice, full_state_dict
    from yolo_tpu_torch.parallel.mesh import bn_group, coordinates

    full = full_state_dict(model, mesh)
    return {
        "coords": coordinates(mesh),
        "groups": (mesh.get_group("data").size(), mesh.get_group("model").size(),
                   bn_group(mesh).size()),
        "rows": batch_slice(mesh, np.arange(8 * 3).reshape(8, 3)),
        "shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()
                   if "fc_layers" in k},
        "full_equal": sorted(full) == sorted(cfg["state_dict"]) and all(
            torch.equal(full[k], v) for k, v in cfg["state_dict"].items()),
    }


def task_train(mesh, cfg, workdir):
    """Each of ``cfg["runs"]`` (fused_bn mode, optimizer, lr, clip_norm) from
    the same weights: losses and grad norms a step (every rank), the fused-BN
    all-reduces, the gathered state (first rank), and the validation passes
    of the run's ``"val"`` loaders after its steps."""
    from yolo_tpu_torch.ops import fused_bn
    from yolo_tpu_torch.parallel import full_state_dict

    first = torch.distributed.get_rank() == 0
    out = []
    for run in cfg["runs"]:
        model = tiny_model(cfg["state_dict"], run["mode"])
        trainer = make_trainer(model, mesh, run["optimizer"], run["lr"], run["clip_norm"])
        if not out:
            info = task_mesh(mesh, cfg, workdir, model)
        fused_bn.ALL_REDUCES = 0
        losses, norms = run_steps(trainer, cfg)
        result = {"losses": losses, "norms": norms, "all_reduces": fused_bn.ALL_REDUCES}
        state = full_state_dict(model, mesh)
        if first:  # the gathered state is the same on every rank
            result["state"] = state
        result["val"] = [trainer.validate(loader) for loader in run.get("val", ())]
        out.append(result)
    return {"mesh": info, "runs": out,
            "resume": task_resume(mesh, cfg, workdir) if "ckpt" in cfg else None}


def task_snapshot(mesh, cfg, workdir):
    """A DCP snapshot after a step, restored into a differently seeded
    trainer on the same mesh, and the gathered ``.pth``; the second step of
    the restored run against the first run's second step."""
    from yolo_tpu_torch.parallel import full_state_dict
    from yolo_tpu_torch.training.checkpoints import (restore_checkpoint_orbax,
                                                     save_checkpoint,
                                                     save_checkpoint_orbax,
                                                     wait_for_snapshot)

    def trainer_from(state_dict):
        model = tiny_model(state_dict)
        _dropout(model).manual_seed(11)
        return make_trainer(model, mesh)

    a = trainer_from(cfg["state_dict"])
    a.train_step(cfg["images"], cfg["targets"])
    for step in range(1, 5):  # four snapshots of one state: the last 3 are kept
        save_checkpoint_orbax(workdir / "ck", step, a, {"val_loss": 1.5, "best_map": 0.25})
    wait_for_snapshot(a)
    save_checkpoint(workdir / "ck" / "yolo_latest.pth", 1, a.model, a.optimizer, a.schedule,
                    {"total": 1.0}, {"total": 1.5}, mesh)
    before = {k: v.clone() for k, v in full_state_dict(a.model, mesh).items()}
    a.train_step(cfg["images"], cfg["targets"])

    other = tiny_model()  # seed 0 init: not the state saved
    b = trainer_from(other.state_dict())
    step, metrics = restore_checkpoint_orbax(workdir / "ck", b)
    restored = {k: v.clone() for k, v in full_state_dict(b.model, mesh).items()}
    b.train_step(cfg["images"], cfg["targets"])
    same = lambda x, y: sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)  # noqa: E731
    out = {"step": step, "metrics": metrics, "restored_equal": same(before, restored),
           "schedule": b.step, "second_step_equal": same(full_state_dict(a.model, mesh),
                                                         full_state_dict(b.model, mesh))}
    if torch.distributed.get_rank() == 0:
        out["saved"] = before
    return out


def task_resume(mesh, cfg, workdir):
    """``resume`` of a JAX ``.ckpt`` onto the mesh: the gathered weights and
    Adam moments, and the step."""
    from yolo_tpu_torch.parallel import full_state_dict
    from yolo_tpu_torch.parallel.mesh import full_optimizer_state_dict
    from yolo_tpu_torch.training.checkpoints import resume

    trainer = make_trainer(tiny_model(), mesh)
    meta = resume(cfg["ckpt"], trainer.model, trainer.optimizer, trainer.schedule, mesh)
    names = {i: n for i, (n, _) in enumerate(trainer.model.named_parameters())}
    osd = full_optimizer_state_dict(trainer.optimizer, trainer.model, mesh)
    state = full_state_dict(trainer.model, mesh)
    out = {"meta": meta, "step": trainer.step}
    if torch.distributed.get_rank() == 0:  # the gathered state is the same on every rank
        out.update(state=state, moments={names[i]: (e["exp_avg"], e["exp_avg_sq"])
                                         for i, e in osd["state"].items()})
    return out


class _GridLookup:
    """A ``forward_fn`` that returns this rank's rows of given grids, one
    global batch a call (JAX's grids fed to the port's evaluator)."""

    def __init__(self, mesh, grids):
        self.mesh, self.grids, self.calls = mesh, grids, 0

    def __call__(self, images):
        from yolo_tpu_torch.parallel import batch_slice

        grid = batch_slice(self.mesh, torch.from_numpy(self.grids[self.calls]))
        self.calls += 1
        assert grid.shape[0] == images.shape[0]
        return grid


def task_eval(mesh, cfg, workdir):
    """evaluate_model on the mesh (the port's forward on both paths, and
    JAX's grids), and the sharded int8 engine: each rank's detections,
    gathered, and the single-process engine on the rank's rows."""
    from yolo_tpu_torch.metrics import evaluate_model
    from yolo_tpu_torch.parallel import batch_slice
    from yolo_tpu_torch.serving.engine import (default_impl, gather_detections,
                                               make_int8_engine_fn,
                                               make_sharded_int8_engine_fn)

    model = tiny_model(cfg["state_dict"])
    loader = ListLoader(cfg["batches"], cfg["batch_size"])
    common = dict(verbose=False, device="cpu", mesh=mesh)
    out = {"keys": {p: evaluate_model(model, loader, precise=p, **common)
                    for p in (True, False)},
           "jax_grid_keys": evaluate_model(None, loader, forward_fn=_GridLookup(
               mesh, cfg["grids"]), **common)}
    images, thr = torch.from_numpy(cfg["engine_images"]), cfg["thr"]
    predict = make_sharded_int8_engine_fn(mesh, 7, 2, 20, impl=default_impl())
    local = predict(cfg["q"], images, thr, 0.4)
    single = make_int8_engine_fn(7, 2, 20, impl=default_impl())(
        cfg["q"], batch_slice(mesh, images), thr, 0.4)
    out["local_equal"] = all(torch.equal(a, b) for a, b in zip(local, single))
    out["gathered"] = gather_detections(mesh, local)
    return out


TASKS = {"train": task_train, "snapshot": task_snapshot,
         "resume": task_resume, "eval": task_eval}



class ListLoader:
    """A loader of fixed batches with the ``batch_size`` the Trainer pads to."""

    def __init__(self, batches, batch_size: int):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)
