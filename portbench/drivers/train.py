"""Training: ``Trainer.train_step`` in a closed loop over a pool of batches.

Parameters: ``batch``, ``pool_batches`` (seeded uint8 images and encoded
targets with ``boxes_per_image`` boxes, in pinned host memory, copied in
each step), ``checked_steps``, the optimizer (``lr``, ``weight_decay``,
``betas``, ``eps``), ``clip_norm``, ``use_amp``, ``fused_bn``, the loss
weights. One Trainer is built; its first ``checked_steps`` steps, on pool
batches that all differ, are the ones the reference follows (the loss of
each, the update gradient of the first as Adam's state holds it, the change
of the parameters over all of them); the window then steps on through the
pool with the same object and ends in a synchronize.
"""

from __future__ import annotations

import time

import torch

from portbench import compare, systems, traffic


def _batches(run):
    p, cfg = run.params, run.model_config()
    n = int(p["pool_batches"]) * int(p["batch"])
    images = traffic.uint8_images(run.seed_for("pool"), n, cfg["image_size"], run.device)
    targets = torch.from_numpy(traffic.yolo_targets(
        run.seed_for("targets"), n, cfg["S"], cfg["B"], cfg["num_classes"],
        p["boxes_per_image"]))
    return images, targets


def dropout_masks(run, steps: int):
    """The masks the model's dropout draws in its first ``steps`` steps from
    the seed the harness gives it (``torch.rand(shape) < keep``)."""
    p, cfg = run.params, run.model_config()
    gen = torch.Generator(device=run.device).manual_seed(run.seed_for("dropout"))
    return [torch.rand((int(p["batch"]), cfg["fc_hidden"]), generator=gen, device=run.device)
            < 1.0 - cfg["dropout"] for _ in range(steps)]


def _norms(tensors) -> dict:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, values.cpu().tolist()))


def drive(run) -> None:
    from yolo_tpu_torch.models.layers import Dropout
    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer

    p = run.params
    model = systems.build_model(run, fused_bn=p["fused_bn"])
    if run.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.manual_seed(run.seed_for("dropout"))
    opt, schedule = make_optimizer(model, lr=p["lr"], weight_decay=p["weight_decay"])
    for group in opt.param_groups:
        group["betas"], group["eps"] = tuple(p["betas"]), p["eps"]
    trainer = Trainer(model, opt, schedule, lambda_coord=p["lambda_coord"],
                      lambda_noobj=p["lambda_noobj"], device=run.device,
                      use_amp=bool(p["use_amp"]), clip_norm=p["clip_norm"])
    step = trainer.train_step
    if "wrap_step" in run.hooks:
        step = run.hooks["wrap_step"](step)
    images, targets = _batches(run)
    batch = int(p["batch"])
    pool = list(zip(traffic.host_batches(images, batch), traffic.host_batches(targets, batch)))
    del images, targets
    names = {id(q): n for n, q in model.named_parameters()}

    checked = int(p["checked_steps"])
    losses, grad = [], None
    for s in range(checked):
        losses.append(step(*pool[s])["total"])
        if s == 0:
            b1 = opt.param_groups[0]["betas"][0]
            grad = _norms({names[id(q)]: (opt.state[q]["exp_avg"] / (1 - b1)
                                          if "exp_avg" in opt.state.get(q, {})
                                          else torch.zeros(()))
                           for q in trainer.params})
    start = systems.seeded_weights(run)
    update = _norms({n: q.detach() - start[n] for n, q in model.named_parameters()})
    del start
    prog = {"losses": [float(v) for v in losses], "grad": grad, "update": update}
    run.setup_done()

    n = 0
    with run.window():
        t0 = time.perf_counter()
        while True:
            step(*pool[(checked + n) % len(pool)])
            n += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        elapsed = time.perf_counter() - t0
    run.metrics["train_images_per_s"] = n * batch / elapsed
    run.window_counts.update(steps=n, images=n * batch, seconds=elapsed)
    run.attempted = n * batch
    run.read_memory_peak()
    del trainer, model, opt, schedule, step, pool
    systems.free_device()
    check(run, prog)


def reference_readings(run, control: bool = False) -> dict:
    """The reference's losses, first update gradient and change, as norms a leaf."""
    p, cfg = run.params, run.model_config()
    checked = int(p["checked_steps"])
    images, targets = _batches(run)
    batch = int(p["batch"])
    sd = systems.seeded_weights(run)
    hyper = {k: p[k] for k in ("lr", "weight_decay", "betas", "eps", "clip_norm",
                               "lambda_coord", "lambda_noobj")}
    out = run.reference().train_steps(cfg, sd, list(images.split(batch))[:checked],
                                      list(targets.split(batch))[:checked], hyper,
                                      dropout_masks(run, checked), control=control)
    update = _norms({n: out["params"][n] - sd[n] for n in out["params"]})
    return {"losses": out["losses"], "grad": _norms(out["first_grad"]), "update": update}


def check(run, prog) -> None:
    ref = reference_readings(run)
    run.notes.append(f"losses: program {prog['losses']}, reference {ref['losses']}; "
                     f"step loss gaps {compare.step_loss_gaps(prog, ref)}; leaves counted in "
                     f"update_gap {len(compare.counted_leaves(ref['grad']))} of "
                     f"{len(ref['grad'])}")
    run.checks.update({k: (v, run.limit(k)) for k, v in compare.training(prog, ref).items()})

