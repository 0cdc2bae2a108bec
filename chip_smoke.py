#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Drives the port's main path (yolo_tpu_torch: ResNet50 YOLOv1 forward ->
decode -> per-class greedy NMS through the hand-written CUDA kernel) at full
width, 448x448, float32, 20 classes, with random weights from a seed. Phases:

1. environment: card name and power limit, torch, compute capability 9.0;
   TF32 off for convolutions and matmuls (exact float32);
2. build: nvcc compiles yolo_tpu_torch/csrc/*.cu for sm_90a;
3. kernel vs plain: the NMS kernel's keep masks against its plain torch twin
   on CPU copies, over seeded batches (K = 98, 162, 392; eps 1e-6 and 0;
   t 0.4 and 0.5; tie storms; all-invalid rows), timed with CUDA events;
4. slice: YOLOInference.predict_batch_arrays on 16 seeded uint8 images with
   the median decoded score as threshold; the NMS launch count must grow,
   keep masks must equal decode + the plain NMS on CPU copies, and one
   image's raw grid must match the same model on the CPU;
5. entry point: the predict CLI on a saved .pth and a few seeded JPEGs;
6. timing (information only): img/s at batch 1, 16 and 64.

Any failure raises and exits nonzero. The last lines are the kernels' JSON
record, the card line, and {"ok": true, "device": {...}}. Needs one CUDA
card and nvcc; fails without them, and fails outside the repository.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
S, B, C = 7, 2, 20
SIZE = 448
SLICE_BATCH = 16
IOU_T = 0.4
# A float32 forward on the card (TF32 off) and on the CPU sum in different
# orders; the difference stays within a few ulps per layer.
RAW_ATOL_REL, RAW_ATOL_ABS = 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_kernels(fn, iters: int):
    """(device ms per call by kernel name, wall ms per call) from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / iters
    per_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.key] = evt.device_time_total / 1000.0 / iters
    return per_kernel, wall


# ---------------------------------------------------------------- phase 1
def phase_environment() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"[1] card: {card}")
    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, capability {cap}, "
        f"{torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (capability 9.0), got {cap}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from yolo_tpu_torch.utils import kernels

    cached = kernels.library_path().is_file()
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.load()
    how = "reused the library built earlier from these sources" if cached else "compiled"
    log(f"[2] {how}: {path.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.find_nvcc()})")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[2]   {line.strip()}")


# ---------------------------------------------------------------- phase 3
def _case(seed: int, n: int, K: int, ties: bool):
    """Seeded detections (numpy). ``ties``: 3 score levels incl. both signed
    zeros, boxes drawn from 4 per image. The last row (of several) is all invalid."""
    r = np.random.default_rng(seed)
    boxes = r.uniform(0.05, 0.95, size=(n, K, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.4
    scores = r.uniform(size=(n, K)).astype(np.float32)
    if ties:
        boxes = np.take_along_axis(
            boxes, r.integers(0, 4, size=(n, K, 1)).repeat(4, axis=2), axis=1)
        scores = np.array([0.0, -0.0, 0.5], np.float32)[r.integers(0, 3, size=(n, K))]
    cls = r.integers(0, 4, size=(n, K)).astype(np.int32)
    valid = r.uniform(size=(n, K)) < 0.75
    if n > 1:
        valid[-1] = False
    return boxes, scores, cls, valid


def phase_kernel_vs_plain() -> dict:
    import torch

    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.decode import Detections

    dev = torch.device("cuda")
    cases = [(n, 98, False) for n in (1, SLICE_BATCH, 64, 256)]
    cases += [(256, 162, False), (256, 392, False), (256, 98, True), (256, 392, True)]
    n_cases, mismatches, timings = 0, 0, {}
    for ci, (n, K, ties) in enumerate(cases):
        arrays = _case(1000 + ci, n, K, ties)
        cpu = Detections(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
        gpu = Detections(*(t.to(dev) for t in cpu))
        for eps in (1e-6, 0.0):
            for t in (0.4, 0.5):
                got = cuda_nms.nms(gpu, t, eps=eps).valid
                torch.cuda.synchronize()
                ref = cuda_nms.nms(cpu, t, eps=eps).valid
                bad = int((got.cpu() != ref).sum())
                mismatches += bad
                n_cases += 1
                log(f"[3] n={n:3d} K={K:3d} ties={ties!s:5} eps={eps:g} t={t}: "
                    f"kept {int(ref.sum())}/{int(cpu.valid.sum())}, mismatches {bad}")
        if not ties:
            args = (gpu.boxes, gpu.scores, gpu.class_ids, gpu.valid)
            k_ms = cuda_ms(lambda: cuda_nms.nms(gpu, IOU_T), iters=200)
            p_ms = cuda_ms(lambda: cuda_nms.nms_reference(*args, IOU_T, 1e-6), iters=5)
            per_kernel, _ = profile_kernels(lambda: cuda_nms.nms(gpu, IOU_T), iters=20)
            dev_ms = sum(v for k, v in per_kernel.items() if "nms_kernel" in k)
            timings[(n, K)] = (k_ms, p_ms)
            log(f"[3] time n={n} K={K}: kernel wrapper {k_ms:.4f} ms/call, plain twin "
                f"on the card {p_ms:.3f} ms/call (CUDA events); kernel device time "
                f"{dev_ms:.4f} ms/launch (torch.profiler)")
    if mismatches:
        raise AssertionError(f"kernel and plain twin disagree on {mismatches} candidates")
    log(f"[3] {n_cases} cases: kernel == plain twin on every keep mask")
    return {"max_abs_err": float(mismatches), "timings": timings}


# ---------------------------------------------------------------- phase 4
def phase_slice():
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.cuda_nms import nms_reference
    from yolo_tpu_torch.ops.decode import Detections, decode_predictions, threshold_mask
    from yolo_tpu_torch.ops.nms import batched_nms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    model = create_model("resnet", C, S, B, device=dev, generator=g, image_size=SIZE)
    n_params = sum(p.numel() for p in model.parameters())
    engine = YOLOInference(model, dev, image_size=SIZE)
    images_np = np.random.default_rng(7).integers(
        0, 256, size=(SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    images = torch.from_numpy(images_np).to(dev)
    log(f"[4] ResNet50 YOLOv1, {n_params} parameters, {SIZE}x{SIZE} fp32, batch {SLICE_BATCH}")

    with torch.inference_mode():
        raw = engine.model(device_normalize(images).permute(0, 3, 1, 2))
        all_scores = decode_predictions(raw, S, B, C, float("-inf")).scores
    thr = float(all_scores.float().median())
    thr_cli = float(all_scores.float().quantile(0.9))  # fewer lines to print

    cuda_nms.LAUNCHES = 0
    out = engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=IOU_T)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    if launches < 1:
        raise AssertionError("the slice did not launch the NMS kernel")

    host = Detections(*(t.cpu() for t in out))
    for name, t in zip(("boxes", "scores"), (host.boxes, host.scores)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    if tuple(host.boxes.shape) != (SLICE_BATCH, S * S * B, 4):
        raise AssertionError(f"boxes shape {tuple(host.boxes.shape)}")
    pre = host._replace(valid=threshold_mask(host.scores, thr))
    plain = batched_nms(pre, IOU_T).valid
    twin = nms_reference(pre.boxes, pre.scores, pre.class_ids, pre.valid, IOU_T, 1e-6)
    if not (torch.equal(host.valid, plain) and torch.equal(host.valid, twin)):
        raise AssertionError("slice keep masks differ from decode + plain NMS on the CPU")
    log(f"[4] threshold {thr:.6g} (median score): {int(pre.valid.sum())} candidates, "
        f"{int(host.valid.sum())} kept by NMS; NMS launches in the slice: {launches}; "
        f"keep masks == decode + plain batched_nms and == plain twin on CPU copies")
    # Random weights give tiny boxes that rarely overlap at IoU 0.4; lower
    # NMS thresholds make the kernel suppress, and must still agree.
    for t in (0.1, 0.01):
        low = engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=t)
        ref = batched_nms(pre, t).valid
        if not torch.equal(low.valid.cpu(), ref):
            raise AssertionError(f"slice keep masks differ from plain NMS at IoU {t}")
        log(f"[4] NMS threshold {t}: {int(ref.sum())} kept of {int(pre.valid.sum())}; "
            f"keep masks == decode + plain batched_nms")

    cpu_model = copy.deepcopy(engine.model).to("cpu", memory_format=torch.contiguous_format)
    with torch.inference_mode():
        ref = cpu_model(device_normalize(torch.from_numpy(images_np[:1])).permute(0, 3, 1, 2))
    err = float((raw[:1].cpu() - ref).abs().max())
    tol = RAW_ATOL_REL * float(ref.abs().max()) + RAW_ATOL_ABS
    log(f"[4] raw (7, 7, 30) grid, GPU vs CPU: max abs err {err:.3g} "
        f"(tolerance {tol:.3g}; max |ref| {float(ref.abs().max()):.3g})")
    if not err <= tol:
        raise AssertionError(f"GPU and CPU forwards differ by {err} > {tol}")
    del cpu_model
    return engine, thr, thr_cli, launches


# ---------------------------------------------------------------- phase 5
def phase_entry_point(engine, thr: float) -> None:
    import torch
    from PIL import Image

    from yolo_tpu_torch import predict
    from yolo_tpu_torch.ops import cuda_nms

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "yolo_random.pth"
        torch.save(engine.model.state_dict(), ckpt)
        img_dir, out_dir = tmp / "images", tmp / "predictions"
        img_dir.mkdir()
        r = np.random.default_rng(11)
        for k in range(3):
            Image.fromarray(r.integers(0, 256, size=(375, 500, 3), dtype=np.uint8)).save(
                img_dir / f"image{k}.jpg")
        before = cuda_nms.LAUNCHES
        predict.main(["--checkpoint", str(ckpt), "--image-dir", str(img_dir),
                      "--output", str(out_dir), "--device", "cuda",
                      f"--conf-threshold={thr}"])
        written = sorted(p.name for p in out_dir.iterdir())
        if written != [f"image{k}_pred.jpg" for k in range(3)]:
            raise AssertionError(f"predict CLI wrote {written}")
        if cuda_nms.LAUNCHES <= before:
            raise AssertionError("the predict CLI did not launch the NMS kernel")
    log(f"[5] python -m yolo_tpu_torch.predict --device cuda: wrote {written}")


# ---------------------------------------------------------------- phase 6
def phase_timing(engine, thr: float, card: str) -> None:
    import torch

    r = np.random.default_rng(5)
    for batch in (1, 16, 64):
        images = torch.from_numpy(
            r.integers(0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
        run = lambda: engine.predict_batch_arrays(images, thr, IOU_T)  # noqa: E731
        ms = cuda_ms(run, iters=10)
        log(f"[6] {card}: fp32 slice (uint8 on the card -> forward -> decode -> NMS "
            f"kernel), batch {batch}: {ms:.3f} ms/batch, {batch * 1000.0 / ms:.1f} img/s "
            f"(CUDA events, 10 iterations after 3 warm-up)")
        per_kernel, wall = profile_kernels(run, iters=3)
        busy = sum(per_kernel.values())
        nms_ms = sum(v for k, v in per_kernel.items() if "nms_kernel" in k)
        log(f"[6]   torch.profiler, batch {batch}: device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall per batch (idle {100 * (1 - busy / wall):.1f}%); "
            f"NMS kernel {nms_ms:.4f} ms ({100 * nms_ms / busy:.2f}% of busy)")
        for name, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[6]     {v:8.3f} ms  {name[:110]}")


def main() -> None:
    if not (REPO / "yolo_tpu_torch" / "csrc" / "nms.cu").is_file():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(yolo_tpu_torch/ is not beside this script)")
    sys.path.insert(0, str(REPO))
    import torch

    card = phase_environment()
    phase_build()
    kv = phase_kernel_vs_plain()
    engine, thr, thr_cli, launches = phase_slice()
    phase_entry_point(engine, thr_cli)
    phase_timing(engine, thr, card)

    k_ms, p_ms = kv["timings"][(SLICE_BATCH, 98)]
    record = {"kernels": [{
        "name": "nms",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_tpu/ops/pallas_nms.py:42",
        "launches": launches,
        "max_abs_err": kv["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
