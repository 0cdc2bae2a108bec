#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Drives the port's paths at full width (ResNet50 YOLOv1, 448x448, 20
classes, random weights from a seed): inference (forward -> decode ->
per-class greedy NMS through the hand-written CUDA kernel, float32),
training (Trainer.train_step with the train-mode BatchNorm through the four
hand-written fused-BN kernels), int8 serving (fold -> calibrate ->
quantize -> the quantize+space-to-depth stem kernel and the int8 conv +
requant kernel for every conv -> decode -> NMS), and int8 serving with the
stage-chain hooks (each stage's stride-1 bottlenecks through the fused
chain kernel, or each identity block through the fused bottleneck kernel).
Phases:

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
6. timing (information only): img/s at batch 1, 16 and 64;
7. fused-BN kernels vs plain twins: every kernel at the (M, C) of the
   training slice's BN layers at batch 16, float32 and bf16, residual and
   ReLU on and off, against the twins on the same card; reductions run
   twice and must be identical; wrapper times by CUDA events, device times
   by torch.profiler, and the GB/s those reach (by the wrapper's time where
   the profiler records no device activity);
8. training slice: one fp32 train step of the fused ("full") model and of
   the same weights unfused, on one dropout mask: losses, gradients and BN
   running buffers agree; each fused-BN kernel launched 53 times per step
   (the launch counts are zeroed just before); 3 more steps, a bf16
   autocast step, and a "stats"-mode step that launches only the stats
   kernel;
9. entry points: the train CLI on a synthetic VOC tree (1 epoch, then
   --resume true for a second), and bench_train --fused-bn;
10. timing (information only): the host's cost of one BN layer per mode;
   then train step ms, img/s, idle share, the host's time to issue a step,
   synchronizing calls per step, top kernels and peak memory for fused_bn
   False / "stats" / "full", fp32 at batch 16 and 32, bf16 at batch 32 and
   64;
11. int8 kernels vs plain twins: the stem front at batch 1, 16 and 64 on
   448x448 uint8 and float32 images, and the int8 conv at every distinct
   conv geometry and epilogue of the full-width engine at batch 2 (plus the
   direct 7x7 stem), int8 output and int32 accumulator, bit for bit against
   the twins on the card; kernel, twin and torch._int_mm times;
12. int8 slice: YOLOInference(optimize="int8") calibrated on two seeded
   batches of 8, predict_batch_arrays on 16 seeded uint8 images: the stem
   kernel launched once and the conv kernel 58 times per forward (counts
   zeroed just before), keep masks equal the twin path's on the card, the
   grid correlates > 0.98 with the fp32 slice's; save_engine -> a fresh
   engine gives identical detections; the predict CLI with --int8
   --save-engine, then --engine;
13. timing (information only): int8 and fp32 img/s at batch 1, 16, 64 and
   256, the idle share, and each kernel's share of device time;
14. fused bottleneck kernels vs plain twins: at each stage's full-width
   chain geometry (seeded q-params), batch 2 and 16, the chain kernel on the
   stage's whole chain (layer1's downsample block included) and the block
   kernel on the stage's identity block, bit for bit against the twins on
   the card; kernel, twin and per-conv (int8 conv kernel) times beside the
   bound; resident blocks against tiles at batch 1;
15. stage-chain slice: build_int8_predict with impl["layer1".."layer4"] =
   chain_int8 on the phase-12 model: one served batch launches the stem
   kernel once, the conv kernel 18 times and the chain kernel 4 times
   (counts zeroed just before); its grid equals the default engine's bit for
   bit and its keep masks are equal; then every identity block through
   block_int8 (1 / 22 / 12 launches), the same grid; then
   python -m yolo_tpu_torch.bench_int8 --variants int8,chain;
16. timing (information only): default vs chained int8 img/s at batch 1,
   16, 64 and 256, in turns, with the idle share;
17. Winograd kernel vs plain twin: at each distinct stride-1 3x3 conv of
   the full-width engine (seeded q-params), batch 2 and 16, leaky or ReLU
   as the engine uses them, bit for bit; kernel, twin, direct int8 conv and
   16 x torch._int_mm times beside the bound; the ablation modes (taps,
   dots, dots-raw) against their twins at head.conv1 geometry; then
   python -m yolo_tpu_torch.experiments.wino_ablate at its defaults;
18. Winograd slice: YOLOInference(optimize="int8", wino=<all 16 convs>) on
   the phase-12 model: one served batch launches the stem kernel once, the
   int8 conv kernel 42 times and the Winograd kernel 16 times (counts
   zeroed just before); its grid equals the same engine's with the twin for
   every Winograd conv, bit for bit, with equal keep masks, and correlates
   with the default engine's; save_engine -> a fresh engine reinstalls the
   hooks and gives identical detections; predict --int8 --engine <it>; then
   python -m yolo_tpu_torch.bench_int8 --variants int8,wino;
19. timing (information only): default vs wino (all 16) vs wino
   (head_conv1, 3, 4) img/s at batch 1, 16, 64 and 256, in turns;
20. fused Adam update (csrc/adam_update.cu) vs its plain twin, bit for bit,
   at (512, 256) and fc1's (50176, 4096); check_vs_torch_adam (the kernel
   against step 8 of the port's Adam + clip_grad_norm_, rtol 1e-6); then
   python -m yolo_tpu_torch.experiments.opt_update_microbench (kernel, twin,
   torch.optim.Adam fused and foreach, in ms and GB/s);
21. int8 dot + requant (csrc/int8_dot.cu) vs its twin, bit for bit, in the
   five (K, N) cases at M = 4096 and M = 2**20 + 17 (a ragged tail; K = 300
   rows only 4-byte aligned); then python -m
   yolo_tpu_torch.experiments.mosaic_int8_dot (kernel and torch._int_mm);
22. bf16 3x3 conv + BN statistics (csrc/bf16_conv_stats.cu) vs its twin at
   the layer3 and layer4 identity-conv2 geometries, batch 2 and 128: y
   within one bf16 ulp of max|twin|, the sums within 1e-5 of sum|acc| (of
   sum acc^2), identical from run to run; then python -m
   yolo_tpu_torch.experiments.conv_bn_fuse_bench (cuDNN conv, cuDNN conv +
   batch_norm, the kernel, the kernel with stats + normalize, the kernel
   with stats alone);
23. bf16 fused bottleneck (csrc/bf16_bottleneck.cu) vs its twin at layer1's
   widths (256 / 64), batch 2 and 64, H = W = 112 and 13: within 2 bf16 ulps
   of max|twin|, no NaN; then python -m
   yolo_tpu_torch.experiments.fused_block_pallas (kernel, twin, cuDNN's three
   bf16 convs).
Phases 20-23 drive each harness through its main() with its kernel's
launch count zeroed just before and read just after.

Any failure raises and exits nonzero. The last lines are the kernels' JSON
record, the card line, and {"ok": true, "device": {...}}. Needs one CUDA
card and nvcc; fails without them, and fails outside the repository.
"""

from __future__ import annotations

import copy
import json
import shutil
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


# H100 SXM data sheet, dense, at the full 700 W.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_FLOPS_S = 67e12
BF16_FLOPS_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, ops: float, ops_per_s: float):
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """(device ms per call by kernel name, wall ms per call) from torch.profiler.

    CUPTI now and then records no device activity for a whole session; the
    profile is then taken once more, and if that too sees no kernel the dict
    is empty and callers report the device times as not measured (the CUDA
    event times they print do not depend on the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_kernel, wall = {}, float("nan")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000.0 / iters
        for evt in prof.key_averages():
            # Kernels only: record_function ranges ("Optimizer.step#Adam.step") are
            # also listed on the device and would count the same time twice. A
            # kernel's name has a signature, "void f<...{lambda()#1}...>(...)".
            is_range = "#" in evt.key and "(" not in evt.key
            if evt.device_type == torch.autograd.DeviceType.CUDA and not is_range:
                per_kernel[evt.key] = evt.device_time_total / 1000.0 / iters
        if any(v > 0 for v in per_kernel.values()):
            break
        per_kernel = {}
        log("torch.profiler saw no device time; profiling once more")
    return per_kernel, wall


def profiled(ms: float, fmt: str = ".4f") -> str:
    """A device time from ``profile_kernels``, or "not measured" where it saw none."""
    return f"{ms:{fmt}} ms" if ms > 0 else "not measured (torch.profiler saw no device time)"


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
    # ptxas -v: "Function properties for <mangled>", then the stack/spill
    # line, then "Used N registers"; one line per kernel here.
    demangle = shutil.which("c++filt")
    kernel, spills = "?", ""
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Function properties for" in line:
            kernel = line.split("Function properties for", 1)[1].strip()
            if demangle:
                kernel = subprocess.run([demangle, kernel], capture_output=True, text=True,
                                        check=True).stdout.strip()
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            log(f"[2]   {kernel[:90]}: {line.split(':', 1)[1].strip()}; {spills}")
        elif "error" in line:
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
            keep = cuda_nms.nms(cpu, IOU_T).valid
            # One selection step per kept box, each an argmax and an IoU
            # against K candidates (~12 float32 operations per candidate).
            ops = int(keep.sum()) * K * 12
            in_bytes = n * K * (16 + 4 + 4 + 1) + n * K
            timings[(n, K)] = (k_ms, p_ms, *bound(in_bytes, ops, FP32_FLOPS_S))
            log(f"[3] time n={n} K={K}: kernel wrapper {k_ms:.4f} ms/call, plain twin "
                f"on the card {p_ms:.3f} ms/call (CUDA events); kernel device time per "
                f"launch {profiled(dev_ms)} (torch.profiler)")
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
        if not busy > 0:
            log(f"[6]   torch.profiler, batch {batch}: device busy {profiled(busy)}")
            continue
        nms_ms = sum(v for k, v in per_kernel.items() if "nms_kernel" in k)
        log(f"[6]   torch.profiler, batch {batch}: device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall per batch (idle {100 * (1 - busy / wall):.1f}%); "
            f"NMS kernel {nms_ms:.4f} ms ({100 * nms_ms / busy:.2f}% of busy)")
        for name, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[6]     {v:8.3f} ms  {name[:110]}")


# ---------------------------------------------------------------- phase 7
# (name, N, C, H, W, residual): the BN layers of the training slice at batch
# 16, covering C = 64 ... 2048 and M = 802,816 (the stem) ... 3,136.
BN_SHAPES = [
    ("stem bn1", 16, 64, 224, 224, False),
    ("layer1.0.bn1", 16, 64, 112, 112, False),
    ("layer1.0.bn3", 16, 256, 112, 112, True),
    ("layer2.0.bn1", 16, 128, 112, 112, False),
    ("layer2.0.bn3", 16, 512, 56, 56, True),
    ("layer3.0.bn1", 16, 256, 56, 56, False),
    ("layer3.0.bn3", 16, 1024, 28, 28, True),
    ("layer4.0.bn1", 16, 512, 28, 28, False),
    ("layer4.0.bn3", 16, 2048, 14, 14, True),
]
BN_KERNELS = ("stats", "normalize", "bwd_reduce", "bwd_dx")
# The CUDA kernels (csrc/fused_bn.cu) behind each wrapper, as the profiler names them.
BN_BODIES = {"stats": ("::stats_partial<", "::finalize<true>"),
             "normalize": ("::normalize<",),
             "bwd_reduce": ("::bwd_reduce_partial<", "::finalize<false>"),
             "bwd_dx": ("::bwd_dx<",)}
HBM_PEAK_GBS = HBM_BYTES_S / 1e9


def _bn_tol(dtype):
    """Kernel vs twin on one card: the sums run in another order and nvcc
    contracts x*mul+add into an FMA, so float32 agrees to a few ulps of the
    operands (rtol 1e-5, atol 1e-5 of the largest value); a bf16 result may
    round to the neighbouring value (one bf16 ulp, 2**-7)."""
    import torch

    return (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 2.0**-7)


def _bn_err(got, ref, dtype, what) -> float:
    rtol, atol = _bn_tol(dtype)
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bound = rtol * ref.abs() + atol * float(ref.abs().max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{what}: kernel and twin differ by {float(err.max()):.3g}")
    return float(err.max())


def phase_fused_bn_kernels() -> dict:
    import torch

    from yolo_tpu_torch.ops import fused_bn as fb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    max_err = dict.fromkeys(BN_KERNELS, 0.0)
    timings = {}
    n_checks = 0

    def rand(shape, dtype, lo=None, hi=None):
        if lo is None:
            t = torch.randn(shape, generator=gen, device=dev)
        else:
            t = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
        return t.to(dtype)

    for name, n, c, h, w, has_res in BN_SHAPES:
        m = n * h * w
        for dtype in (torch.float32, torch.bfloat16):
            cl = dict(memory_format=torch.channels_last)
            x = (rand((n, c, h, w), dtype) * 2 + 1).contiguous(**cl)
            res = rand((n, c, h, w), dtype).contiguous(**cl)
            g = rand((n, c, h, w), dtype).contiguous(**cl)
            mul, add = rand(c, torch.float32, 0.5, 1.5), rand(c, torch.float32, -0.5, 0.5)
            r, a3 = rand(c, torch.float32, 0.5, 2.0), rand(c, torch.float32, -0.1, 0.1)

            mean, var = fb.bn_stats(x)
            again = fb.bn_stats(x)
            if not (torch.equal(mean, again[0]) and torch.equal(var, again[1])):
                raise AssertionError(f"{name}: bn_stats differs from run to run")
            rm, rv = fb.bn_stats_reference(x)
            max_err["stats"] = max(max_err["stats"], _bn_err(mean, rm, torch.float32, name),
                                   _bn_err(var, rv, torch.float32, name))
            for relu in (True, False):
                for rr in (None, res):
                    out = fb.bn_normalize(x, mul, add, rr, relu)
                    ref = fb.bn_normalize_reference(x, mul, add, rr, relu)
                    max_err["normalize"] = max(max_err["normalize"],
                                               _bn_err(out, ref, dtype, f"{name} normalize"))
                    n_checks += 1
                out = fb.bn_normalize(x, mul, add, None, True)
                s1, s2 = fb.bn_bwd_reduce(g, out, x, mean, r, relu)
                t1, t2 = fb.bn_bwd_reduce(g, out, x, mean, r, relu)
                if not (torch.equal(s1, t1) and torch.equal(s2, t2)):
                    raise AssertionError(f"{name}: bn_bwd_reduce differs from run to run")
                q1, q2 = fb.bn_bwd_reduce_reference(g, out, x, mean, r, relu)
                max_err["bwd_reduce"] = max(max_err["bwd_reduce"],
                                            _bn_err(s1, q1, torch.float32, f"{name} reduce"),
                                            _bn_err(s2, q2, torch.float32, f"{name} reduce"))
                for want_dres in (False, True):
                    dx, dres = fb.bn_bwd_dx(g, out, x, mul, r, a3, relu, want_dres)
                    rdx, rdres = fb.bn_bwd_dx_reference(g, out, x, mul, r, a3, relu, want_dres)
                    max_err["bwd_dx"] = max(max_err["bwd_dx"],
                                            _bn_err(dx, rdx, dtype, f"{name} dx"))
                    if want_dres and not torch.equal(dres, rdres):
                        raise AssertionError(f"{name}: dres differs from the twin's")
                    n_checks += 1
            torch.cuda.synchronize()

            # Time each kernel and its twin as the training slice calls them:
            # ReLU on, the residual where the layer has one.
            rr = res if has_res else None
            out = fb.bn_normalize(x, mul, add, rr, True)
            calls = {
                "stats": (lambda: fb.bn_stats(x), lambda: fb.bn_stats_reference(x)),
                "normalize": (lambda: fb.bn_normalize(x, mul, add, rr, True),
                              lambda: fb.bn_normalize_reference(x, mul, add, rr, True)),
                "bwd_reduce": (lambda: fb.bn_bwd_reduce(g, out, x, mean, r, True),
                               lambda: fb.bn_bwd_reduce_reference(g, out, x, mean, r, True)),
                "bwd_dx": (lambda: fb.bn_bwd_dx(g, out, x, mul, r, a3, True, has_res),
                           lambda: fb.bn_bwd_dx_reference(g, out, x, mul, r, a3, True,
                                                          has_res)),
            }
            tag = "f32" if dtype == torch.float32 else "bf16"
            # One torch call computing bn_stats' function: torch.var_mean.
            timings[(name, tag, "library_stats")] = cuda_ms(
                lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0), iters=20)
            per_kernel, _ = profile_kernels(lambda: [kern() for kern, _ in calls.values()],
                                            iters=5)
            line = []
            for kname, (kern, twin) in calls.items():
                k_ms = cuda_ms(kern, iters=20)
                p_ms = cuda_ms(twin, iters=5)
                dev_ms = sum(v for k, v in per_kernel.items()
                             if any(body in k for body in BN_BODIES[kname]))
                # Without a profiled device time the rate is taken from the
                # wrapper's CUDA event time, which also holds launch gaps.
                t_ms, how = (dev_ms, "device") if dev_ms > 0 else (k_ms, "wrapper")
                gbs = fb.bytes_moved(kname, m, c, x.element_size(), relu=True,
                                     residual=has_res) / (t_ms * 1e6)
                timings[(name, tag, kname)] = (k_ms, p_ms, gbs)
                line.append(f"{kname} {profiled(dev_ms)} device ({gbs:.0f} GB/s by {how} time, "
                            f"{100 * gbs / HBM_PEAK_GBS:.0f}% of peak), {k_ms:.4f} ms per "
                            f"wrapper call vs twin {p_ms:.4f} ms")
            log(f"[7] {name} (M={m}, C={c}, {tag}): " + "; ".join(line))
            del x, res, g, out
    n_red = len(BN_SHAPES) * 2 * 3
    log(f"[7] {n_checks} normalize/dx cases and {n_red} stats/reduce cases: kernels == twins within "
        f"tolerance; reductions identical from run to run; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in max_err.items()))
    return {"max_abs_err": max_err, "timings": timings}


# ---------------------------------------------------------------- phase 8
# Fused ("full") vs unfused step on the same weights, fp32, TF32 off. The
# forward is well conditioned: the loss parts agree to rtol 1e-4 and the BN
# running buffers to rtol 1e-4 (atol 1e-5). The backward of this randomly
# initialised ResNet50 is not: through 53 BN backward passes (each removes
# the batch mean and the x-hat projection of the gradient, which cancels)
# float32 rounding alone moves the stem's gradient by a few percent of its
# largest element (measured on the CPU at 224x224: cuDNN-free torch fp32 vs
# float64, 3.1e-2). So each named gradient of both fp32 steps is held
# against a float64 step on the same card: the fused step's relative L2
# error must be no larger than twice the unfused step's, plus 1e-5.
GRAD_NAMES = ("backbone.extractor.0.weight", "backbone.extractor.5.0.bn3.weight",
              "head.fc_layers.4.weight")


def _slice_batch(n: int):
    from yolo_tpu_torch.data import encode_target

    r = np.random.default_rng(23)
    images = r.integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)
    targets = []
    for _ in range(n):
        boxes = r.uniform(0.1, 0.9, size=(4, 4)).astype(np.float32)
        boxes[:, 2:] *= 0.5
        targets.append(encode_target(boxes, r.integers(0, C, size=4).tolist(), S, B, C))
    return images, np.stack(targets)


def _trainer(model, use_amp=False):
    import torch

    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer

    optimizer, schedule = make_optimizer(model, 1e-4, 5e-4, milestones_steps=[])
    return Trainer(model, optimizer, schedule, device=torch.device("cuda"), use_amp=use_amp)


def _model(fused_bn, state_dict=None):
    import torch

    from yolo_tpu_torch.models import create_model

    dev = torch.device("cuda")
    model = create_model("resnet", C, S, B, device=dev, image_size=SIZE, fused_bn=fused_bn,
                         generator=torch.Generator(device=dev).manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(memory_format=torch.channels_last)


def _float64_grads(model, images, targets) -> dict:
    """Gradients of one float64 train-mode step, clipped as the Trainer clips."""
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.ops.loss import yolo_loss

    model.train()
    x = device_normalize(images).permute(0, 3, 1, 2).double()
    x = x.contiguous(memory_format=torch.channels_last)
    total, _ = yolo_loss(model(x), targets.double(), S=S, B=B, C=C)
    total.backward()
    torch.nn.utils.clip_grad_norm_(list(model.parameters()), 10.0)
    return {k: p.grad for k, p in model.named_parameters() if k in GRAD_NAMES}


def phase_train_slice() -> dict:
    import torch

    from yolo_tpu_torch.ops import fused_bn as fb

    fused = _model("full")
    n_params = sum(p.numel() for p in fused.parameters())
    init_sd = {k: v.detach().clone() for k, v in fused.state_dict().items()}
    plain = _model(False, fused.state_dict())
    ref64 = _model(False, fused.state_dict()).double()
    images_np, targets_np = _slice_batch(SLICE_BATCH)
    images = torch.from_numpy(images_np).cuda()
    targets = torch.from_numpy(targets_np).cuda()
    mask = torch.rand((SLICE_BATCH, 4096), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3)) < 0.5
    for model in (fused, plain, ref64):
        model.head.fc_layers[3].fixed_mask = mask
    t_fused, t_plain = _trainer(fused), _trainer(plain)
    log(f"[8] ResNet50 YOLOv1, {n_params} parameters, {SIZE}x{SIZE} fp32 (TF32 off), "
        f"channels_last, batch {SLICE_BATCH}, "
        f"{sum(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())} BN layers")

    for k in fb.LAUNCHES:
        fb.LAUNCHES[k] = 0
    fb.RELAYOUTS = 0
    parts_f = t_fused.train_step(images, targets)
    torch.cuda.synchronize()
    step1 = dict(fb.LAUNCHES)
    parts_p = t_plain.train_step(images, targets)
    torch.cuda.synchronize()
    log(f"[8] launches in one fused step: {step1}; relayout copies: {fb.RELAYOUTS}")
    if step1 != dict.fromkeys(fb.LAUNCHES, 53):
        raise AssertionError(f"a fused step must launch each kernel 53 times, got {step1}")
    if fb.LAUNCHES != step1:
        raise AssertionError("the unfused step launched fused-BN kernels")
    grads64 = _float64_grads(ref64, images, targets)
    del ref64

    pf = {k: float(v) for k, v in parts_f.items()}
    pp = {k: float(v) for k, v in parts_p.items()}
    for k in pf:
        if not abs(pf[k] - pp[k]) <= 1e-4 * abs(pp[k]) + 1e-6:
            raise AssertionError(f"loss part {k}: fused {pf[k]} vs unfused {pp[k]}")
    log("[8] step-1 loss parts, fused vs unfused: " + ", ".join(
        f"{k} {pf[k]:.6f}/{pp[k]:.6f} (rel {abs(pf[k] - pp[k]) / max(abs(pp[k]), 1e-30):.2e})"
        for k in pf))
    grads_f = dict(fused.named_parameters())
    grads_p = dict(plain.named_parameters())
    for name in GRAD_NAMES:
        g64 = grads64[name]
        gf, gp = grads_f[name].grad.double(), grads_p[name].grad.double()
        e_f = float((gf - g64).norm() / g64.norm())
        e_p = float((gp - g64).norm() / g64.norm())
        scale = float(g64.abs().max())
        m_f = float((gf - g64).abs().max()) / scale
        m_p = float((gp - g64).abs().max()) / scale
        log(f"[8] grad {name}: relative L2 error vs float64, fused {e_f:.2e}, unfused "
            f"{e_p:.2e}; max abs error of max |grad| {scale:.3g}: fused {m_f:.2e}, "
            f"unfused {m_p:.2e}")
        if not e_f <= 2 * e_p + 1e-5:
            raise AssertionError(f"gradient {name}: the fused step is further from float64 "
                                 f"({e_f:.3g}) than twice the unfused step ({e_p:.3g})")
    sd_f, sd_p = fused.state_dict(), plain.state_dict()
    worst = (0.0, "")
    n_buffers = 0
    for key, want in sd_p.items():
        if "running_" not in key and "num_batches" not in key:
            continue
        got = sd_f[key]
        n_buffers += 1
        if "num_batches" in key:
            if int(got) != int(want) or int(got) != 1:
                raise AssertionError(f"{key}: {int(got)} vs {int(want)}")
            continue
        err = (got - want).abs()
        if not bool((err <= 1e-4 * want.abs() + 1e-5).all()):
            raise AssertionError(f"{key}: fused and unfused differ by {float(err.max())}")
        rel = float((err / want.abs().clamp(min=1e-6)).max())
        worst = max(worst, (rel, key))
    log(f"[8] {n_buffers} BN running buffers agree after the step (worst relative diff "
        f"{worst[0]:.2e} at {worst[1]})")
    del plain, t_plain, grads_p, sd_p
    fused.head.fc_layers[3].fixed_mask = None

    losses = []
    for _ in range(3):
        losses.append(float(t_fused.train_step(images, targets)["total"]))
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    if launches != dict.fromkeys(fb.LAUNCHES, 4 * 53):
        raise AssertionError(f"4 fused steps must launch each kernel 212 times, got {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    log(f"[8] 3 more fused steps: losses {[round(v, 4) for v in losses]}; launches in the "
        f"4 steps {launches}; relayout copies {fb.RELAYOUTS}")

    # bf16 autocast and "stats" steps from the step-1 weights, on the same
    # dropout mask: a bf16 forward stays within 5e-2 of the fp32 loss, and
    # the "stats" forward computes the fp32 one (rtol 1e-4).
    del t_fused
    fused.load_state_dict(init_sd)
    fused.head.fc_layers[3].fixed_mask = mask
    before = dict(fb.LAUNCHES)
    loss = float(_trainer(fused, use_amp=True).train_step(images, targets)["total"])
    torch.cuda.synchronize()
    grew = {k: fb.LAUNCHES[k] - before[k] for k in before}
    if not abs(loss - pf["total"]) <= 5e-2 * pf["total"] or grew != dict.fromkeys(before, 53):
        raise AssertionError(f"bf16 step: loss {loss} (fp32 {pf['total']}), launches {grew}")
    log(f"[8] bf16 autocast fused step from the step-1 weights: loss {loss:.4f} (fp32 "
        f"{pf['total']:.4f}), launches {grew}")

    del fused
    stats_model = _model("stats", init_sd)
    stats_model.head.fc_layers[3].fixed_mask = mask
    del init_sd
    before = dict(fb.LAUNCHES)
    loss = float(_trainer(stats_model).train_step(images, targets)["total"])
    torch.cuda.synchronize()
    grew = {k: fb.LAUNCHES[k] - before[k] for k in before}
    if not abs(loss - pf["total"]) <= 1e-4 * pf["total"] or grew != {
            "stats": 53, "normalize": 0, "bwd_reduce": 0, "bwd_dx": 0}:
        raise AssertionError(f"stats-mode step: loss {loss} (full {pf['total']}), "
                             f"launches {grew}")
    log(f"[8] 'stats'-mode step from the step-1 weights: loss {loss:.6f} (full "
        f"{pf['total']:.6f}), launches {grew}")
    del stats_model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 9
def _write_voc(root: Path, n: int = 4) -> None:
    """A synthetic VOCdevkit: 2007 trainval, 2012 train/val, seeded JPEGs."""
    from PIL import Image

    r = np.random.default_rng(29)
    for year, splits in (("2007", {"trainval": slice(None)}),
                         ("2012", {"train": slice(0, n // 2 + 1), "val": slice(n // 2 + 1, None),
                                   "trainval": slice(None)})):
        voc = root / "VOCdevkit" / f"VOC{year}"
        for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
            (voc / sub).mkdir(parents=True, exist_ok=True)
        ids = [f"{year}_{k:06d}" for k in range(n)]
        for img_id in ids:
            Image.fromarray(r.integers(0, 256, size=(375, 500, 3), dtype=np.uint8)).save(
                voc / "JPEGImages" / f"{img_id}.jpg")
            x0, y0 = int(r.integers(0, 300)), int(r.integers(0, 200))
            (voc / "Annotations" / f"{img_id}.xml").write_text(
                "<annotation><size><width>500</width><height>375</height></size><object>"
                f"<name>dog</name><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
                f"<xmax>{x0 + 150}</xmax><ymax>{y0 + 120}</ymax></bndbox></object></annotation>")
        for split, part in splits.items():
            (voc / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids[part]))


def phase_train_entry_points() -> None:
    import torch

    from yolo_tpu_torch import bench_train, train
    from yolo_tpu_torch.ops import fused_bn as fb

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        _write_voc(tmp / "voc")
        args = ["--data-root", str(tmp / "voc"), "--device", "cuda", "--batch-size", "2",
                "--image-size", str(SIZE), "--num-workers", "2", "--worker-type", "thread",
                "--checkpoint-dir", str(tmp / "ck"), "--log-dir", str(tmp / "runs")]
        t0 = time.perf_counter()
        train.main([*args, "--epochs", "1"])
        written = sorted(p.name for p in (tmp / "ck").iterdir())
        if written != ["yolo_best.pth", "yolo_latest.pth"]:
            raise AssertionError(f"train CLI wrote {written}")
        first = torch.load(tmp / "ck" / "yolo_latest.pth", map_location="cpu",
                           weights_only=True)["scheduler_state_dict"]["last_epoch"]
        log(f"[9] python -m yolo_tpu_torch.train --device cuda --epochs 1: wrote {written} "
            f"after {first} steps ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        train.main([*args, "--epochs", "2", "--resume", "true"])
        ck = torch.load(tmp / "ck" / "yolo_latest.pth", map_location="cpu", weights_only=True)
        steps = {float(v["step"]) for v in ck["optimizer_state_dict"]["state"].values()}
        if ck["epoch"] != 2 or ck["scheduler_state_dict"]["last_epoch"] != 2 * first \
                or steps != {2.0 * first}:
            raise AssertionError(f"resume: epoch {ck['epoch']}, schedule "
                                 f"{ck['scheduler_state_dict']['last_epoch']}, Adam steps {steps}")
        log(f"[9] --resume true --epochs 2: epoch 2 from step {first} to {2 * first} "
            f"(schedule and Adam) ({time.perf_counter() - t0:.1f} s)")
        del ck
        before = fb.LAUNCHES["stats"]
        bench_train.main(["--batch", str(SLICE_BATCH), "--fused-bn", "--data-root",
                          str(tmp / "voc"), "--num-workers", "2"])
        if fb.LAUNCHES["stats"] <= before:
            raise AssertionError("bench_train --fused-bn did not launch the stats kernel")
        log(f"[9] python -m yolo_tpu_torch.bench_train --batch {SLICE_BATCH} --fused-bn: "
            f"stats kernel launched {fb.LAUNCHES['stats'] - before} times")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 10
def _is_bn_kernel(name: str) -> bool:
    """The fused-BN kernels, torch's native BN kernels and cuDNN's
    (``batch_norm_*``, ``batchnorm_fwtr_nhwc_*``, ``bn_fw_tr_*``)."""
    flat = name.lower().replace("_", "")
    return (any(b in name for bodies in BN_BODIES.values() for b in bodies)
            or "batchnorm" in flat or "bn_" in name.lower())


def _sync_points(fn) -> list:
    """``file:line`` of each host-device synchronization in one call of ``fn``
    (torch's sync debug mode, which warns at every synchronizing op)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def _bn_layer_host_us(mode, dtype) -> float:
    """Host microseconds for one train-mode BN(+ReLU) layer's forward and
    backward at a tiny shape, where the host, not the card, sets the pace."""
    import torch

    from yolo_tpu_torch.models.layers import FusedBatchNormAct

    dev = torch.device("cuda")
    if mode is None:
        layer = torch.nn.Sequential(torch.nn.BatchNorm2d(64, device=dev), torch.nn.ReLU())
    else:
        layer = FusedBatchNormAct(64, True, mode, device=dev)
    layer.train()
    x = torch.randn((2, 64, 8, 8), device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    g = torch.ones_like(x)

    def once():
        with torch.autocast("cuda", torch.bfloat16, enabled=dtype == torch.bfloat16):
            y = layer(x)
        y.backward(g)

    for _ in range(5):
        once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        once()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / 200


def phase_train_timing(card: str) -> None:
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        modes = {"False": None, "'stats'": "stats", "'full'": "full"}
        us = {k: _bn_layer_host_us(m, dtype) for k, m in modes.items()}
        log(f"[10] host cost of one train-mode BN+ReLU layer, forward and backward, "
            f"{str(dtype)[6:]}: " + ", ".join(f"fused_bn={k} {v:.1f} us" for k, v in us.items())
            + " (x53 layers per step)")
    configs = [(False, 16), (False, 32), (True, 32), (True, 64)]  # (bf16, batch)
    r = np.random.default_rng(31)
    for fused_bn in (False, "stats", "full"):
        model = _model(fused_bn)
        for use_amp, batch in configs:
            trainer = _trainer(model, use_amp=use_amp)
            images = torch.from_numpy(
                r.integers(0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
            targets = torch.from_numpy(_slice_batch(1)[1].repeat(batch, 0)).cuda()
            step = lambda: trainer.train_step(images, targets)  # noqa: E731
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            allocs = torch.cuda.memory_stats()
            ms = cuda_ms(step, iters=5, warmup=1)
            # Host time to issue one step, with no sync until the end: when it
            # is close to the step time, the host (or a sync) sets the pace.
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            host_ms = (time.perf_counter() - t0) * 1000.0 / 3
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            after = torch.cuda.memory_stats()
            mallocs = after["num_device_alloc"] - allocs["num_device_alloc"]
            retries = after["num_alloc_retries"] - allocs["num_alloc_retries"]
            syncs = _sync_points(step)
            per_kernel, wall = profile_kernels(step, iters=2)
            busy = sum(per_kernel.values())
            kind = "bf16 autocast" if use_amp else "fp32"
            # Idle share: kernel time (torch.profiler) against the step time measured
            # without the profiler (CUDA events); the profiler's own host work
            # slows the profiled steps (their wall time is printed too).
            idle = f"idle {100 * max(0.0, 1 - busy / ms):.1f}%" if busy > 0 else "idle not measured"
            log(f"[10] {card}: train step, fused_bn={fused_bn!r}, {kind}, batch {batch}: "
                f"{ms:.2f} ms, {batch * 1000.0 / ms:.1f} img/s (CUDA events, 5 steps after 2 "
                f"warm-up); peak memory {peak:.2f} GiB; kernels busy {profiled(busy, '.2f')} "
                f"per step ({idle}; {wall:.2f} ms wall per step under torch.profiler)")
            log(f"[10]   host issues a step in {host_ms:.2f} ms; {len(syncs)} synchronizing "
                f"calls per step{' at ' + ', '.join(sorted(set(syncs))[:4]) if syncs else ''}; "
                f"{mallocs} cudaMalloc and {retries} allocator retries in 9 steps")
            if busy > 0:
                bn = sum(v for k, v in per_kernel.items() if _is_bn_kernel(k))
                log(f"[10]   BN kernels (fused, torch's or cuDNN's) {bn:.2f} ms "
                    f"({100 * bn / busy:.1f}% of busy)")
            for name, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]:
                log(f"[10]     {v:8.3f} ms  {name[:110]}")
            del trainer, images
        del model
        torch.cuda.empty_cache()

# ---------------------------------------------------------------- phase 11
def engine_convs(n: int, size: int = SIZE) -> list:
    """(name, (N, H, W, Cin), Cout, k, stride, pad, mode) of every int8 conv
    of the full-width s2d engine, in the order int8_forward runs them (58)."""
    convs = [("stem", (n, size // 2, size // 2, 12), 64, 4, 1, ((2, 1), (2, 1)), "relu")]
    h, cin = size // 4, 64
    for si, blocks in enumerate((3, 4, 6, 3)):
        p = 64 * 2**si
        for bi in range(blocks):
            s = 2 if si > 0 and bi == 0 else 1
            tag = f"layer{si + 1}.{bi}"
            ho = (h - 1) // s + 1
            convs.append((f"{tag}.conv1", (n, h, h, cin), p, 1, 1, 0, "relu"))
            convs.append((f"{tag}.conv2", (n, h, h, p), p, 3, s, 1, "relu"))
            if bi == 0:
                convs.append((f"{tag}.downsample", (n, h, h, cin), 4 * p, 1, s, 0, "none"))
            convs.append((f"{tag}.conv3", (n, ho, ho, p), 4 * p, 1, 1, 0, "residual"))
            h, cin = ho, 4 * p
    for i, s in ((1, 1), (2, 2), (3, 1), (4, 1)):
        convs.append((f"head.conv{i}", (n, h, h, cin), 1024, 3, s, 1, "leaky"))
        h, cin = (h - 1) // s + 1, 1024
    convs.append(("fc1", (n, 1, 1, h * h * cin), 4096, 1, 1, 0, "float"))
    return convs


def _distinct(convs) -> list:
    seen, out = set(), []
    for c in convs:
        key = (c[1][1:], *c[2:])
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def _conv_operands(conv, seed: int):
    """Seeded int8 x and HWIO weight, m and t that scale the accumulator to
    about +-200 (so rounding and both clips occur), res and r, on the card."""
    import torch

    from yolo_tpu_torch.serving import cuda_int8

    _, (n, h, w, cin), cout, k, stride, pad, _ = conv
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand_i8 = lambda shape: torch.randint(  # noqa: E731
        -127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    ho, wo = cuda_int8.out_size(h, w, k, k, stride, pad)
    m = (torch.rand(cout, generator=g, device="cuda") + 0.5) / float(40 * np.sqrt(k * k * cin))
    t = torch.rand(cout, generator=g, device="cuda") * 6 - 3
    return (rand_i8((n, h, w, cin)), rand_i8((k, k, cin, cout)), m, t,
            rand_i8((n, ho, wo, cout)), torch.tensor(0.85, device="cuda"))


def _conv_call(conv, ops_, mode=None, plain=False):
    from yolo_tpu_torch.serving import cuda_int8

    x, wq, m, t, res, r, wk = ops_
    mode = mode or conv[6]
    extra = dict(res=res, r=r) if mode == "residual" else {}
    if plain:
        return lambda: cuda_int8.conv_int8_reference(x, wq, m, t, conv[4], conv[5], mode,
                                                     **extra)
    return lambda: cuda_int8.conv_int8(x, wq, m, t, conv[4], conv[5], mode, wk=wk, **extra)


def phase_int8_kernels(card: str) -> dict:
    import torch

    from yolo_tpu_torch.serving import cuda_int8, cuda_stem

    dev = torch.device("cuda")
    out = {"stem": {}, "conv": {}, "stem_err": 0.0, "conv_err": 0.0}
    # --- kernel #6: the stem front, bit for bit at the slice's batches.
    r = np.random.default_rng(41)
    s_img = torch.tensor(0.0173, dtype=torch.float32, device=dev)
    for batch in (1, SLICE_BATCH, 64):
        for dtype in ("uint8", "float32"):
            if dtype == "uint8":
                host = r.integers(0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)
            else:
                host = r.normal(0, 1.5, size=(batch, SIZE, SIZE, 3)).astype(np.float32)
            images = torch.from_numpy(host).to(dev)
            got = cuda_stem.quant_s2d(images, s_img)
            ref = cuda_stem.quant_s2d_reference(images, s_img)
            bad = int((got != ref).sum())
            out["stem_err"] = max(out["stem_err"],
                                  float((got.int() - ref.int()).abs().max()))
            if bad:
                raise AssertionError(f"stem kernel differs from its twin in {bad} values "
                                     f"(batch {batch}, {dtype})")
            k_ms = cuda_ms(lambda: cuda_stem.quant_s2d(images, s_img), iters=20)
            p_ms = cuda_ms(lambda: cuda_stem.quant_s2d_reference(images, s_img), iters=5)
            per_kernel, _ = profile_kernels(lambda: cuda_stem.quant_s2d(images, s_img), iters=10)
            dev_ms = sum(v for k, v in per_kernel.items() if "quant_s2d_kernel" in k)
            n_bytes = cuda_stem.bytes_moved(batch, SIZE, SIZE, images.element_size())
            b_ms, b_by = bound(n_bytes, 0, FP32_FLOPS_S)
            out["stem"][(batch, dtype)] = (k_ms, p_ms, b_ms, b_by, dev_ms)
            log(f"[11] stem front, batch {batch}, {dtype}: == twin bit for bit; kernel "
                f"{profiled(dev_ms)} device, wrapper {k_ms:.4f} ms, twin {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.1f} MB)")
            del images, got, ref

    # --- kernel #7: every distinct conv geometry and epilogue at batch 2, the
    # int8 output and the int32 accumulator against the float64 twin.
    convs = _distinct(engine_convs(2)) + [
        ("stem (direct 7x7)", (2, SIZE, SIZE, 3), 64, 7, 2, 3, "relu")]
    for ci, conv in enumerate(convs):
        x, wq, m, t, res, rr = _conv_operands(conv, 100 + ci)
        ops_ = (x, wq, m, t, res, rr, cuda_int8.pack_weight(wq))
        acc_ref = cuda_int8.conv_acc_reference(x, wq, conv[4], conv[5])
        for mode in (conv[6], "acc"):
            got = _conv_call(conv, ops_, mode)()
            extra = dict(res=res, r=rr) if mode == "residual" else {}
            ref = cuda_int8.requant_reference(acc_ref, m, t, mode, **extra)
            if got.dtype == ref.dtype:
                out["conv_err"] = max(out["conv_err"],
                                      float((got.double() - ref.double()).abs().max()))
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                diff = (got.double() - ref.double()).abs()
                raise AssertionError(f"int8 conv {conv[0]} ({mode}) differs from its twin in "
                                     f"{int((diff > 0).sum())} values, max {float(diff.max())}")
        del acc_ref, got, ref, ops_
    log(f"[11] int8 conv: {len(convs)} distinct geometries (every conv of the engine at "
        f"batch 2 and the direct stem), own epilogue and int32 accumulator == twin bit for bit")

    # Times at the slice's batch: every distinct geometry's kernel; the twin
    # and torch._int_mm (the accumulator of a 1x1 conv) where named.
    for ci, conv in enumerate(_distinct(engine_convs(SLICE_BATCH))):
        x, wq, m, t, res, rr = _conv_operands(conv, 200 + ci)
        ops_ = (x, wq, m, t, res, rr, cuda_int8.pack_weight(wq))
        (n, h, w, cin), cout, k, stride, pad, mode = conv[1:]
        k_ms = cuda_ms(_conv_call(conv, ops_), iters=10)
        ops, n_bytes = cuda_int8.work(n, h, w, cin, cout, k, k, stride, pad, mode)
        b_ms, b_by = bound(n_bytes, ops, INT8_OPS_S)
        p_ms = lib_ms = None
        line = ""
        if conv[0] in ("layer1.1.conv1", "layer4.1.conv1", "layer2.0.conv2"):
            p_ms = cuda_ms(_conv_call(conv, ops_, plain=True), iters=3, warmup=1)
            line = f"; twin {p_ms:.3f} ms"
        if k == 1 and stride == 1 and conv[0] != "fc1" and conv[0] in (
                "layer1.1.conv1", "layer4.1.conv1"):
            a, b = x.reshape(-1, cin), ops_[6].t()  # (M, K) row-major, (K, N) column-major
            lib_ms = cuda_ms(lambda: torch._int_mm(a, b), iters=10)
            acc = _conv_call(conv, ops_, "acc")().reshape(-1, cout)
            if not torch.equal(torch._int_mm(a, b), acc):
                raise AssertionError(f"torch._int_mm and the kernel's accumulator differ "
                                     f"at {conv[0]}")
            line += f"; torch._int_mm (accumulator only) {lib_ms:.4f} ms"
        out["conv"][conv[0]] = (k_ms, p_ms, b_ms, b_by, lib_ms, ops)
        log(f"[11] {card}: int8 conv {conv[0]} {tuple(conv[1])} -> {cout}, {k}x{k}/s{stride} "
            f"{mode}, batch {SLICE_BATCH}: {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOPS; bound "
            f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / k_ms:.1f}%){line}")
        del ops_, x, wq, res
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 12
def _int8_model():
    import torch

    from yolo_tpu_torch.models import create_model

    dev = torch.device("cuda")
    return create_model("resnet", C, S, B, device=dev, image_size=SIZE,
                        generator=torch.Generator(device=dev).manual_seed(0))


def _counts():
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.serving import cuda_int8, cuda_stem

    return cuda_stem.LAUNCHES, cuda_int8.LAUNCHES, cuda_nms.LAUNCHES


def _zero_counts():
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.serving import cuda_int8, cuda_stem

    cuda_stem.LAUNCHES = cuda_int8.LAUNCHES = cuda_nms.LAUNCHES = 0


def phase_int8_slice():
    import torch
    from PIL import Image

    from yolo_tpu_torch import predict
    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.ops.decode import decode_predictions
    from yolo_tpu_torch.serving.engine import (default_impl, int8_forward, make_int8_engine_fn,
                                               plain_conv)

    dev = torch.device("cuda")
    model = _int8_model()
    r = np.random.default_rng(43)
    calib = [device_normalize(torch.from_numpy(
        r.integers(0, 256, size=(8, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)) for _ in range(2)]
    t0 = time.perf_counter()
    engine = YOLOInference(model, dev, image_size=SIZE, optimize="int8", calibration=calib)
    torch.cuda.synchronize()
    log(f"[12] int8 engine built (fold, bf16 calibration on 2x8 images, quantize, weight "
        f"packing) in {time.perf_counter() - t0:.1f} s")
    q = engine._int8_state["q"]
    images = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        grid = int8_forward(q, images, S=S, impl=default_impl())
    thr = float(decode_predictions(grid, S, B, C, float("-inf")).scores.float().median())

    _zero_counts()
    out = engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=IOU_T)
    torch.cuda.synchronize()
    launches = _counts()
    if launches[:2] != (1, 58) or launches[2] < 1:
        raise AssertionError(f"one int8 forward must launch the stem kernel once and the conv "
                             f"kernel 58 times (and NMS), got {launches}")
    twin = make_int8_engine_fn(S, B, C, conv=plain_conv)(q, images, thr, IOU_T)
    with torch.inference_mode():
        twin_grid = int8_forward(q, images, S=S, conv=plain_conv)
    grid_diff = float((grid - twin_grid).abs().max())
    if not torch.equal(out.valid, twin.valid):
        raise AssertionError("int8 keep masks differ from the twin path's on the card")
    if tuple(out.boxes.shape) != (SLICE_BATCH, S * S * B, 4) or not bool(
            torch.isfinite(out.scores).all() and torch.isfinite(out.boxes).all()):
        raise AssertionError("int8 detections: wrong shape or non-finite values")
    log(f"[12] int8 slice, batch {SLICE_BATCH}, threshold {thr:.6g} (median score): launches "
        f"stem {launches[0]}, conv {launches[1]}, NMS {launches[2]}; {int(out.valid.sum())} "
        f"kept; keep masks == the twin path's on the card (grid max |diff| {grid_diff:.3g})")

    with torch.inference_mode():
        fp32 = YOLOInference(model, dev, image_size=SIZE)
        ref = fp32.model(device_normalize(images).permute(0, 3, 1, 2))
    corr = float(np.corrcoef(grid.double().cpu().numpy().ravel(),
                             ref.double().cpu().numpy().ravel())[0, 1])
    log(f"[12] int8 grid vs the exact fp32 slice's on the same images: correlation {corr:.6f} "
        f"(max |fp32| {float(ref.abs().max()):.4g}, max |int8 - fp32| "
        f"{float((grid - ref).abs().max()):.4g})")
    if not corr > 0.98:
        raise AssertionError(f"int8/fp32 grid correlation {corr} <= 0.98")
    del fp32, ref

    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        tmp = Path(tmp)
        engine.save_engine(tmp / "engine.npz")
        loaded = YOLOInference(model, dev, image_size=SIZE, optimize="int8",
                               engine_artifact=str(tmp / "engine.npz"))
        again = loaded.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=IOU_T)
        if not all(torch.equal(a, b) for a, b in zip(again, out)):
            raise AssertionError("the reloaded engine's detections differ")
        log(f"[12] save_engine -> {(tmp / 'engine.npz').stat().st_size / 1e6:.1f} MB; a "
            f"fresh engine from it gives identical detections")
        del loaded

        ckpt = tmp / "yolo_random.pth"
        torch.save(model.state_dict(), ckpt)
        img_dir = tmp / "images"
        img_dir.mkdir()
        r = np.random.default_rng(11)
        for k in range(8):
            Image.fromarray(r.integers(0, 256, size=(375, 500, 3), dtype=np.uint8)).save(
                img_dir / f"image{k}.jpg")
        artifact = tmp / "cli_engine.npz"
        base = ["--checkpoint", str(ckpt), "--image-dir", str(img_dir), "--device", "cuda",
                "--conf-threshold=0.99"]
        for flags in (["--int8", "--save-engine", str(artifact)], ["--engine", str(artifact)]):
            out_dir = tmp / f"out{len(flags)}"
            before = _counts()
            predict.main([*base, "--output", str(out_dir), *flags])
            grew = [a - b for a, b in zip(_counts(), before)]
            written = sorted(p.name for p in out_dir.iterdir())
            if written != [f"image{k}_pred.jpg" for k in range(8)] or grew[:2] != [1, 58]:
                raise AssertionError(f"predict {flags}: wrote {written}, launches {grew}")
            log(f"[12] python -m yolo_tpu_torch.predict {' '.join(flags[:1])}"
                f"{' --save-engine' if '--save-engine' in flags else ''}: wrote 8 images, "
                f"launches stem/conv/NMS {grew}")
        if not artifact.is_file():
            raise AssertionError("predict --save-engine wrote no artifact")
    return engine, model, thr, launches


# ---------------------------------------------------------------- phase 13
def phase_int8_timing(engine, model, thr: float, card: str) -> None:
    import torch

    from yolo_tpu_torch.inference import YOLOInference

    fp32 = YOLOInference(model, torch.device("cuda"), image_size=SIZE)
    r = np.random.default_rng(47)
    for batch in (1, 16, 64, 256):
        images = torch.from_numpy(
            r.integers(0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
        rates = {}
        for name, eng in (("int8", engine), ("fp32", fp32), ("int8 again", engine)):
            run = lambda: eng.predict_batch_arrays(images, thr, IOU_T)  # noqa: E731
            ms = cuda_ms(run, iters=3 if batch == 256 else 10, warmup=2)
            rates[name] = (ms, batch * 1000.0 / ms)
        log(f"[13] {card}: batch {batch}: " + "; ".join(
            f"{k} {ms:.3f} ms/batch, {v:.1f} img/s" for k, (ms, v) in rates.items())
            + " (CUDA events; uint8 images on the card -> decode -> NMS kernel)")
        per_kernel, wall = profile_kernels(
            lambda: engine.predict_batch_arrays(images, thr, IOU_T), iters=2)
        busy = sum(per_kernel.values())
        if not busy > 0:
            log(f"[13]   int8, batch {batch}: device busy {profiled(busy)}")
            continue
        share = {name: sum(v for k, v in per_kernel.items() if body in k) for name, body in
                 (("int8 conv", "int8_conv_kernel"), ("stem front", "quant_s2d_kernel"),
                  ("NMS", "nms_kernel"))}
        ms = rates["int8"][0]
        log(f"[13]   int8, batch {batch}: device busy {busy:.3f} ms per batch (idle "
            f"{100 * max(0.0, 1 - busy / ms):.1f}% of the CUDA-event time; {wall:.3f} ms wall "
            f"under torch.profiler); " + ", ".join(
                f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in share.items())
            + f", other {busy - sum(share.values()):.3f} ms")
        for name, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]:
            log(f"[13]     {v:8.3f} ms  {name[:110]}")
        del images
    del fp32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 14
# (stage, H = W, Cin, C, P, blocks in the chain, first block has a downsample)
CHAINS = (("layer1", 112, 64, 256, 64, 3, True), ("layer2", 56, 512, 512, 128, 3, False),
          ("layer3", 28, 1024, 1024, 256, 5, False), ("layer4", 14, 2048, 2048, 512, 2, False))


def _rand_qblock(g, cin: int, c: int, p: int, ds: bool) -> dict:
    """Seeded q-params of one bottleneck on the card, as engine.to_device
    returns them; m and t scale each accumulator to about +-130."""
    import torch

    from yolo_tpu_torch.serving.engine import to_device

    def conv(k, ci, co):
        return {"wq": torch.randint(-127, 128, (k, k, ci, co), generator=g, device="cuda",
                                    dtype=torch.int8),
                "m": (torch.rand(co, generator=g, device="cuda") + 0.5)
                / float(40 * np.sqrt(k * k * ci)),
                "t": torch.rand(co, generator=g, device="cuda") * 6 - 3}

    qb = {"conv1": conv(1, cin, p), "conv2": conv(3, p, p), "conv3": conv(1, p, c),
          "downsample": conv(1, cin, c) if ds else None}
    r = torch.tensor(0.7 if ds else 0.9, device="cuda")
    qb.update({"ds_rescale": r, "rx": None} if ds else {"rx": r})
    return to_device(qb, "cuda")


def _per_conv(x, qblocks):
    """The same blocks through the per-conv path: one int8 conv kernel launch per conv."""
    from yolo_tpu_torch.serving.engine import _block

    for qb in qblocks:
        x = _block(x, qb, 1)
    return x


def phase_chain_kernels(card: str) -> dict:
    import torch

    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    g = torch.Generator(device="cuda").manual_seed(51)
    rand_i8 = lambda shape: torch.randint(  # noqa: E731
        -127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    out = {"chain": {}, "block": {}, "chain_err": 0.0, "block_err": 0.0}
    for stage, h, cin, c, p, nb, ds in CHAINS:
        qbs = [_rand_qblock(g, cin if b == 0 else c, c, p, ds and b == 0) for b in range(nb)]
        ident = qbs[1] if ds else qbs[0]  # the stage's identity block, for the block kernel
        t = cb.pick_tile(h, h)[0]
        tiles = (-(-h // t)) ** 2
        cb.chain_int8(rand_i8((1, h, h, cin)), qbs)
        torch.cuda.synchronize()
        log(f"[14] {stage} batch 1: the chain kernel keeps {cb.LAST_GRID} thread blocks "
            f"resident for {tiles} tiles of {t}x{t} on the card's SMs; the block kernel "
            f"launches {tiles} blocks")
        for batch in (2, SLICE_BATCH):
            x, xi = rand_i8((batch, h, h, cin)), rand_i8((batch, h, h, c))
            checks = (("chain", lambda: cb.chain_int8(x, qbs),
                       lambda: cb.chain_int8_reference(x, qbs)),
                      ("block", lambda: cb.block_int8(xi, ident),
                       lambda: cb.block_int8_reference(xi, ident)))
            for name, kernel, twin in checks:
                got, ref = kernel(), twin()
                grid = cb.LAST_GRID
                err = float((got.int() - ref.int()).abs().max())
                out[f"{name}_err"] = max(out[f"{name}_err"], err)
                if got.shape != ref.shape or not torch.equal(got, ref):
                    raise AssertionError(f"{name} kernel at {stage}, batch {batch}, differs from "
                                         f"its twin in {int((got != ref).sum())} values")
            log(f"[14] {stage} batch {batch}: chain of {nb} blocks ({cin}->{c}, P {p}, "
                f"{h}x{h}; {grid} resident thread blocks) and its identity block == twins "
                f"bit for bit")
            del got, ref
        # Times at the slice's batch: kernel, twin (float64 conv) and the per-conv
        # path (3 or 4 int8 conv kernel launches per block) on the same inputs.
        for name, blocks, xin, cin_ in (("chain", qbs, x, cin), ("block", [ident], xi, c)):
            kernel = (lambda: cb.chain_int8(xin, blocks)) if name == "chain" else (
                lambda: cb.block_int8(xin, blocks[0]))
            k_ms = cuda_ms(kernel, iters=10)
            conv_ms = cuda_ms(lambda: _per_conv(xin, blocks), iters=10)
            p_ms = cuda_ms(lambda: cb.chain_int8_reference(xin, blocks), iters=2, warmup=1)
            ops, n_bytes = cb.work(SLICE_BATCH, h, h, cin_, c, p, len(blocks),
                                   blocks[0]["downsample"] is not None)
            b_ms, b_by = bound(n_bytes, ops, INT8_OPS_S)
            out[name][stage] = (k_ms, p_ms, b_ms, b_by, conv_ms, ops)
            log(f"[14] {card}: {name} kernel, {stage}, {len(blocks)} block(s), batch "
                f"{SLICE_BATCH}: {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOPS; bound {b_ms:.4f} ms "
                f"by {b_by}, {100 * b_ms / k_ms:.1f}%); per-conv path {conv_ms:.4f} ms "
                f"(fused / per-conv {k_ms / conv_ms:.3f}); twin {p_ms:.2f} ms; library: none "
                f"(no PyTorch call computes a fused int8 bottleneck)")
        del qbs, ident, x, xi
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 15
def _chain_counts():
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.serving import cuda_bottleneck, cuda_int8, cuda_stem

    return (cuda_stem.LAUNCHES, cuda_int8.LAUNCHES, cuda_bottleneck.LAUNCHES["chain"],
            cuda_bottleneck.LAUNCHES["bottleneck"], cuda_nms.LAUNCHES)


def _zero_chain_counts():
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.serving import cuda_bottleneck, cuda_int8, cuda_stem

    cuda_stem.LAUNCHES = cuda_int8.LAUNCHES = cuda_nms.LAUNCHES = 0
    cuda_bottleneck.LAUNCHES.update(chain=0, bottleneck=0)


def phase_chain_slice(model):
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.ops.decode import decode_predictions
    from yolo_tpu_torch.serving import cuda_bottleneck as cb
    from yolo_tpu_torch.serving.engine import (_block, build_int8_predict, default_impl,
                                               int8_forward, make_int8_engine_fn)

    dev = torch.device("cuda")
    r = np.random.default_rng(43)
    calib = [device_normalize(torch.from_numpy(
        r.integers(0, 256, size=(8, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)) for _ in range(2)]
    layers = [f"layer{i}" for i in range(1, 5)]
    chain_impl = {**default_impl(), **{name: cb.chain_int8 for name in layers}}
    chained, q = build_int8_predict(model, calib, impl=chain_impl)
    default = make_int8_engine_fn(S, B, C, impl=default_impl())
    images = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        want = int8_forward(q, images, S=S, impl=default_impl())
    thr = float(decode_predictions(want, S, B, C, float("-inf")).scores.float().median())
    ref = default(q, images, thr, IOU_T)

    def blocks_hook(x, qblocks):
        """Identity blocks one launch each; layer1's downsample block on _block."""
        for qb in qblocks:
            x = cb.block_int8(x, qb) if qb["downsample"] is None else _block(x, qb, 1)
        return x

    blocks_impl = {**default_impl(), **{name: blocks_hook for name in layers}}
    runs = (("chains on layers 1-4", chained, chain_impl, (1, 18, 4, 0)),
            ("identity blocks via block_int8", make_int8_engine_fn(S, B, C, impl=blocks_impl),
             blocks_impl, (1, 22, 0, 12)))
    launches = {}
    for name, fn, impl, expect in runs:
        _zero_chain_counts()
        dets = fn(q, images, thr, IOU_T)
        torch.cuda.synchronize()
        launches[name] = _chain_counts()
        if launches[name][:4] != expect or launches[name][4] < 1:
            raise AssertionError(f"{name}: launches stem/conv/chain/block/NMS "
                                 f"{launches[name]}, expected {expect} and NMS")
        with torch.inference_mode():
            grid = int8_forward(q, images, S=S, impl=impl)
        if not torch.equal(grid, want):
            raise AssertionError(f"{name}: grid differs from the default int8 engine's by up "
                                 f"to {float((grid - want).abs().max())}")
        if not all(torch.equal(a, b) for a, b in zip(dets, ref)):
            raise AssertionError(f"{name}: detections differ from the default int8 engine's")
        log(f"[15] {name}, batch {SLICE_BATCH}: launches stem {launches[name][0]}, int8 conv "
            f"{launches[name][1]}, chain {launches[name][2]}, block {launches[name][3]}, NMS "
            f"{launches[name][4]}; grid == the default int8 engine's bit for bit; "
            f"{int(dets.valid.sum())} kept, keep masks and detections equal")

    cmd = [sys.executable, "-m", "yolo_tpu_torch.bench_int8", "--batch", str(SLICE_BATCH),
           "--variants", "int8,chain", "--chain-stages", "1,2,3,4"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench_int8 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    for line in proc.stdout.strip().splitlines():
        log(f"[15]   {line}")
    log(f"[15] python -m yolo_tpu_torch.bench_int8 {' '.join(cmd[3:])}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return chained, default, q, thr, launches


# ---------------------------------------------------------------- phase 16
def phase_chain_timing(chained, default, q, thr: float, card: str) -> None:
    import torch

    r = np.random.default_rng(53)
    for batch in (1, 16, 64, 256):
        images = torch.from_numpy(
            r.integers(0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
        rates = {}
        for name, fn in (("default", default), ("chained", chained), ("chained again", chained),
                         ("default again", default)):
            ms = cuda_ms(lambda: fn(q, images, thr, IOU_T), iters=3 if batch == 256 else 10,
                         warmup=2)
            rates[name] = (ms, batch * 1000.0 / ms)
        log(f"[16] {card}: batch {batch}: " + "; ".join(
            f"{k} {ms:.3f} ms/batch, {v:.1f} img/s" for k, (ms, v) in rates.items())
            + " (CUDA events around the engine's predict on uint8 images on the card)")
        for name, fn in (("default", default), ("chained", chained)):
            per_kernel, wall = profile_kernels(lambda: fn(q, images, thr, IOU_T), iters=2)
            busy = sum(per_kernel.values())
            if not busy > 0:
                log(f"[16]   {name}, batch {batch}: device busy {profiled(busy)}")
                continue
            ms = min(rates[name][0], rates[f"{name} again"][0])
            share = {k: sum(v for n, v in per_kernel.items() if body in n) for k, body in
                     (("chain", "int8_chain_kernel"), ("int8 conv", "int8_conv_kernel"))}
            log(f"[16]   {name}, batch {batch}: device busy {busy:.3f} ms per batch (idle "
                f"{100 * max(0.0, 1 - busy / ms):.1f}% of the faster CUDA-event time; "
                f"{wall:.3f} ms wall under torch.profiler); " + ", ".join(
                    f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in share.items()))
        del images
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 17
# (name, H = W, C, K, leaky): the distinct stride-1 3x3 convs of the
# full-width engine (head_conv3 and head_conv4 share a geometry).
WINO_CONVS = (("layer1 conv2", 112, 64, 64, False), ("layer2 conv2", 56, 128, 128, False),
              ("layer3 conv2", 28, 256, 256, False), ("layer4 conv2", 14, 512, 512, False),
              ("head.conv1", 14, 2048, 1024, True), ("head.conv3", 7, 1024, 1024, True))


def _rand_qwino(g, c: int, k: int) -> dict:
    """Seeded Winograd q-params on the card (wino_quantize's layout plus the
    packed taps): mw scales each output to about +-100, some taps clip."""
    import torch

    from yolo_tpu_torch.serving.cuda_wino import pack_taps

    uq = torch.randint(-127, 128, (16, c, k), generator=g, device="cuda", dtype=torch.int8)
    return {"uq": uq, "uk": pack_taps(uq),
            "mw": (torch.rand((16, 1, k), generator=g, device="cuda") + 0.5) * (6e-3 / c**0.5),
            "t": torch.rand(k, generator=g, device="cuda") * 6 - 3,
            "dinv": torch.rand((16, 1, 1), generator=g, device="cuda") * 0.4 + 0.2}


def _wino_bound(n: int, h: int, c: int, k: int, mode: str = "full"):
    from yolo_tpu_torch.serving import cuda_wino

    dots, taps, n_bytes = cuda_wino.work(n, h, h, c, k, mode)
    return max(bound(n_bytes, dots, INT8_OPS_S), (taps / FP32_FLOPS_S * 1e3, "operations"))


def phase_wino_kernels(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import wino_ablate
    from yolo_tpu_torch.serving import cuda_int8, cuda_wino

    g = torch.Generator(device="cuda").manual_seed(61)
    rand_i8 = lambda shape: torch.randint(  # noqa: E731
        -127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    out = {"conv": {}, "modes": {}, "err": 0.0, "mode_err": 0.0}
    for name, h, c, k, leaky in WINO_CONVS:
        qc = {"wino": _rand_qwino(g, c, k)}
        for batch in (2, SLICE_BATCH):
            x = rand_i8((batch, h, h, c))
            got = cuda_wino.conv3x3_wino(x, qc, leaky)
            ref = cuda_wino.conv3x3_wino_reference(x, qc, leaky)
            out["err"] = max(out["err"], float((got.int() - ref.int()).abs().max()))
            if got.shape != ref.shape or not torch.equal(got, ref):
                raise AssertionError(f"wino kernel at {name}, batch {batch}, differs from its "
                                     f"twin in {int((got != ref).sum())} values")
        # Times at the slice's batch: kernel, twin, the direct int8 conv kernel
        # on the same conv, and 16 torch._int_mm at the tap-dot shape.
        k_ms = cuda_ms(lambda: cuda_wino.conv3x3_wino(x, qc, leaky), iters=10)
        p_ms = cuda_ms(lambda: cuda_wino.conv3x3_wino_reference(x, qc, leaky), iters=2, warmup=1)
        wq = rand_i8((3, 3, c, k))
        wk = cuda_int8.pack_weight(wq)
        m = (torch.rand(k, generator=g, device="cuda") + 0.5) / float(40 * np.sqrt(9 * c))
        t = torch.rand(k, generator=g, device="cuda") * 6 - 3
        mode = "leaky" if leaky else "relu"
        d_ms = cuda_ms(lambda: cuda_int8.conv_int8(x, wq, m, t, 1, 1, mode, wk=wk), iters=10)
        th, tw = cuda_wino.tiles(h, h)
        a = rand_i8((SLICE_BATCH * th * tw, c))
        b = qc["wino"]["uk"][0].t()  # (C, K), column-major
        lib_ms = cuda_ms(lambda: [torch._int_mm(a, b) for _ in range(16)], iters=5)
        b_ms, b_by = _wino_bound(SLICE_BATCH, h, c, k)
        dots, _, _ = cuda_wino.work(SLICE_BATCH, h, h, c, k)
        out["conv"][name] = (k_ms, p_ms, b_ms, b_by, lib_ms, d_ms)
        log(f"[17] {card}: wino {name} {h}x{h}, {c}->{k}, {'leaky' if leaky else 'relu'}: == twin "
            f"bit for bit at batch 2 and {SLICE_BATCH}; batch {SLICE_BATCH}: kernel {k_ms:.4f} ms "
            f"({dots / k_ms / 1e9:.1f} int8 TOPS of tap dots; bound {b_ms:.4f} ms by {b_by}, "
            f"{100 * b_ms / k_ms:.1f}%), direct int8 conv kernel {d_ms:.4f} ms (wino / direct "
            f"{k_ms / d_ms:.3f}), twin {p_ms:.3f} ms, 16 x torch._int_mm ({a.shape[0]}, {c}) x "
            f"({c}, {k}) {lib_ms:.4f} ms (accumulators only)")
        del x, got, ref, qc, wq, wk, a

    # The ablation modes at head-conv1 geometry, against their twins.
    _, h, c, k, _ = WINO_CONVS[4]
    qw = _rand_qwino(g, c, k)
    x = rand_i8((SLICE_BATCH, h, h, c))
    for mode in cuda_wino.MODES:
        got, ref = cuda_wino.wino_ablate(x, qw, mode), cuda_wino.wino_ablate_reference(x, qw, mode)
        out["mode_err"] = max(out["mode_err"], float((got.int() - ref.int()).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"wino mode {mode} differs from its twin in "
                                 f"{int((got != ref).sum())} values")
        k_ms = cuda_ms(lambda: cuda_wino.wino_ablate(x, qw, mode), iters=10)
        p_ms = cuda_ms(lambda: cuda_wino.wino_ablate_reference(x, qw, mode), iters=2, warmup=1)
        b_ms, b_by = _wino_bound(SLICE_BATCH, h, c, k, mode)
        out["modes"][mode] = (k_ms, p_ms, b_ms, b_by)
        log(f"[17] {card}: wino mode {mode}, head.conv1 geometry, batch {SLICE_BATCH}: == twin "
            f"bit for bit; kernel {k_ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}), twin "
            f"{p_ms:.3f} ms")
    del x, qw

    # The ablation's own entry point at its defaults (batch 256, 14x14,
    # 1024 -> 1024): the path of the ablation modes, counted.
    cuda_wino.LAUNCHES.update(dict.fromkeys(cuda_wino.MODES, 0))
    out["ablation"] = wino_ablate.run()
    out["ablation_launches"] = dict(cuda_wino.LAUNCHES)
    if min(out["ablation_launches"].values()) < 1:
        raise AssertionError(f"wino_ablate launched {out['ablation_launches']}")
    ab = out["ablation"]
    log(f"[17] python -m yolo_tpu_torch.experiments.wino_ablate (batch 256): launches "
        f"{out['ablation_launches']}; full {ab['full']:.4f} ms, taps + dots "
        f"{ab['taps'] + ab['dots']:.4f} ms (full / (taps + dots) "
        f"{ab['full'] / (ab['taps'] + ab['dots']):.3f}), dots-raw {ab['dots-raw']:.4f} ms")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 18
def _wino_counts():
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.serving import cuda_int8, cuda_stem, cuda_wino

    return cuda_stem.LAUNCHES, cuda_int8.LAUNCHES, cuda_wino.LAUNCHES["full"], cuda_nms.LAUNCHES


def _zero_wino_counts():
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.serving import cuda_int8, cuda_stem, cuda_wino

    cuda_stem.LAUNCHES = cuda_int8.LAUNCHES = cuda_nms.LAUNCHES = 0
    cuda_wino.LAUNCHES.update(dict.fromkeys(cuda_wino.MODES, 0))


def phase_wino_slice(model):
    import torch
    from PIL import Image

    from yolo_tpu_torch import predict
    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.ops.decode import decode_predictions
    from yolo_tpu_torch.serving.engine import default_impl, int8_forward, make_int8_engine_fn
    from yolo_tpu_torch.serving.winograd import (conv3x3_wino_rq, valid_points,
                                                 wino_impl_hooks, wino_points_of)

    dev = torch.device("cuda")
    wino = valid_points((3, 4, 6, 3))
    r = np.random.default_rng(43)
    calib = [device_normalize(torch.from_numpy(
        r.integers(0, 256, size=(8, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)) for _ in range(2)]
    t0 = time.perf_counter()
    engine = YOLOInference(model, dev, image_size=SIZE, optimize="int8", calibration=calib,
                           wino=wino)
    torch.cuda.synchronize()
    log(f"[18] wino engine built on {len(wino)} convs ({', '.join(wino)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    q = engine._int8_state["q"]
    images = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)
    kernel_impl = wino_impl_hooks(wino, default_impl())
    twin_impl = wino_impl_hooks(wino, default_impl(), conv=conv3x3_wino_rq)
    with torch.inference_mode():
        grid = int8_forward(q, images, S=S, impl=kernel_impl)
        twin_grid = int8_forward(q, images, S=S, impl=twin_impl)
        default_grid = int8_forward(q, images, S=S, impl=default_impl())
    thr = float(decode_predictions(grid, S, B, C, float("-inf")).scores.float().median())

    _zero_wino_counts()
    out = engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=IOU_T)
    torch.cuda.synchronize()
    launches = _wino_counts()
    if launches[:3] != (1, 42, 16) or launches[3] < 1:
        raise AssertionError(f"one wino forward must launch stem / int8 conv / wino 1 / 42 / 16 "
                             f"(and NMS), got {launches}")
    if not torch.equal(grid, twin_grid):
        raise AssertionError(f"wino grid differs from the twin path's by up to "
                             f"{float((grid - twin_grid).abs().max())}")
    twin = make_int8_engine_fn(S, B, C, impl=twin_impl)(q, images, thr, IOU_T)
    if not torch.equal(out.valid, twin.valid):
        raise AssertionError("wino keep masks differ from the twin path's on the card")
    if tuple(out.boxes.shape) != (SLICE_BATCH, S * S * B, 4) or not bool(
            torch.isfinite(out.scores).all() and torch.isfinite(out.boxes).all()):
        raise AssertionError("wino detections: wrong shape or non-finite values")
    corr = float(np.corrcoef(grid.double().cpu().numpy().ravel(),
                             default_grid.double().cpu().numpy().ravel())[0, 1])
    log(f"[18] wino slice, batch {SLICE_BATCH}, threshold {thr:.6g} (median score): launches stem "
        f"{launches[0]}, int8 conv {launches[1]}, wino {launches[2]}, NMS {launches[3]}; "
        f"{int(out.valid.sum())} kept; grid == the twin path's bit for bit, keep masks equal; "
        f"grid vs the default int8 engine's: correlation {corr:.6f}, max |diff| "
        f"{float((grid - default_grid).abs().max()):.4g} (max |default| "
        f"{float(default_grid.abs().max()):.4g})")
    if not corr > 0.95:
        raise AssertionError(f"wino/default grid correlation {corr} <= 0.95")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_wino_") as tmp:
        tmp = Path(tmp)
        engine.save_engine(tmp / "wino.npz")
        loaded = YOLOInference(model, dev, image_size=SIZE, optimize="int8",
                               engine_artifact=str(tmp / "wino.npz"))
        _zero_wino_counts()
        again = loaded.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=IOU_T)
        torch.cuda.synchronize()
        reloaded = _wino_counts()
        if wino_points_of(loaded._int8_state["q"]) != wino or reloaded[:3] != (1, 42, 16):
            raise AssertionError(f"the reloaded wino engine lost its hooks: launches {reloaded}")
        if not all(torch.equal(a, b) for a, b in zip(again, out)):
            raise AssertionError("the reloaded wino engine's detections differ")
        log(f"[18] save_engine -> {(tmp / 'wino.npz').stat().st_size / 1e6:.1f} MB; a fresh "
            f"engine from it reinstalls the 16 hooks (launches {reloaded[:3]}) and gives "
            f"identical detections")
        del loaded

        ckpt = tmp / "yolo_random.pth"
        torch.save(model.state_dict(), ckpt)
        img_dir = tmp / "images"
        img_dir.mkdir()
        r = np.random.default_rng(11)
        for k in range(4):
            Image.fromarray(r.integers(0, 256, size=(375, 500, 3), dtype=np.uint8)).save(
                img_dir / f"image{k}.jpg")
        before = _wino_counts()
        predict.main(["--checkpoint", str(ckpt), "--image-dir", str(img_dir), "--device", "cuda",
                      "--conf-threshold=0.99", "--output", str(tmp / "out"), "--int8",
                      "--engine", str(tmp / "wino.npz")])
        grew = [a - b for a, b in zip(_wino_counts(), before)]
        written = sorted(p.name for p in (tmp / "out").iterdir())
        if written != [f"image{k}_pred.jpg" for k in range(4)] or grew[:3] != [1, 42, 16]:
            raise AssertionError(f"predict --engine <wino>: wrote {written}, launches {grew}")
        log(f"[18] python -m yolo_tpu_torch.predict --int8 --engine <wino artifact>: wrote 4 "
            f"images, launches stem/conv/wino/NMS {grew}")

    cmd = [sys.executable, "-m", "yolo_tpu_torch.bench_int8", "--batch", str(SLICE_BATCH),
           "--variants", "int8,wino"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench_int8 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    for line in proc.stdout.strip().splitlines():
        log(f"[18]   {line}")
    log(f"[18] python -m yolo_tpu_torch.bench_int8 {' '.join(cmd[3:])}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    del engine
    return q, thr, launches


# ---------------------------------------------------------------- phase 19
def phase_wino_timing(q, thr: float, card: str) -> None:
    import torch

    from yolo_tpu_torch.serving.engine import default_impl, make_int8_engine_fn
    from yolo_tpu_torch.serving.winograd import HEAD_POINTS, valid_points, wino_impl_hooks

    fns = {"default": make_int8_engine_fn(S, B, C, impl=default_impl()),
           "wino(all 16)": make_int8_engine_fn(S, B, C, impl=wino_impl_hooks(
               valid_points((3, 4, 6, 3)), default_impl())),
           "wino(head_conv1,3,4)": make_int8_engine_fn(S, B, C, impl=wino_impl_hooks(
               HEAD_POINTS, default_impl()))}
    order = list(fns) + list(reversed(fns))
    r = np.random.default_rng(59)
    for batch in (1, 16, 64, 256):
        images = torch.from_numpy(
            r.integers(0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
        rates = {}
        for name in order:
            ms = cuda_ms(lambda: fns[name](q, images, thr, IOU_T),
                         iters=3 if batch == 256 else 10, warmup=2)
            rates.setdefault(name, []).append((ms, batch * 1000.0 / ms))
        log(f"[19] {card}: batch {batch}: " + "; ".join(
            f"{k} " + ", ".join(f"{ms:.3f} ms/batch {v:.1f} img/s" for ms, v in runs)
            for k, runs in rates.items())
            + " (CUDA events, in turns; uint8 images on the card -> decode -> NMS kernel)")
        if batch in (16, 256):
            per_kernel, wall = profile_kernels(lambda: fns["wino(all 16)"](q, images, thr, IOU_T),
                                               iters=2)
            busy = sum(per_kernel.values())
            if not busy > 0:
                log(f"[19]   wino(all 16), batch {batch}: device busy {profiled(busy)}")
            else:
                share = {k: sum(v for n, v in per_kernel.items() if body in n) for k, body in
                         (("wino", "int8_wino_kernel"), ("int8 conv", "int8_conv_kernel"))}
                ms = min(v[0] for v in rates["wino(all 16)"])
                log(f"[19]   wino(all 16), batch {batch}: device busy {busy:.3f} ms per batch "
                    f"(idle {100 * max(0.0, 1 - busy / ms):.1f}% of the faster CUDA-event time; "
                    f"{wall:.3f} ms wall under torch.profiler); " + ", ".join(
                        f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in share.items()))
        del images
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 20
def _harness(module, phase: int) -> tuple:
    """(results, launches) of the harness's entry point at its defaults
    (``python -m <module>``), its kernel's count zeroed just before."""
    module.LAUNCHES = 0
    log(f"[{phase}] python -m {module.__name__}")
    res = module.main([])
    if module.LAUNCHES < 1:
        raise AssertionError(f"{module.__name__} launched its kernel {module.LAUNCHES} times")
    return res, module.LAUNCHES


def phase_adam(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import opt_update_microbench as om

    out = {"err": 0.0}
    g = torch.Generator(device="cuda").manual_seed(71)
    for shape in ((512, 256), (om.ROWS, om.COLS)):
        p, m, v, grad = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
        v.abs_()
        scalars = om.bias_scalars(0.5, 8, 1e-4, "cuda")
        ref = om.plain_update(p, m, v, grad, scalars)
        got = om.cuda_update(p, m, v, grad, scalars)
        for name, a, b in zip("pmv", got, ref):
            out["err"] = max(out["err"], float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"adam kernel {name} at {shape} differs from its twin in "
                                     f"{int((a != b).sum())} values")
        del p, m, v, grad, ref, got
    torch.cuda.empty_cache()
    err = om.check_vs_torch_adam(device="cuda")
    log(f"[20] {card}: adam kernel == twin bit for bit at (512, 256) and ({om.ROWS}, "
        f"{om.COLS}); vs torch.optim.Adam + clip_grad_norm_ step 8: max |dp| {err:.3e}")
    res, out["launches"] = _harness(om, 20)
    flops, n_bytes = om.work(om.ROWS, om.COLS)
    out["bound"] = bound(n_bytes, flops, FP32_FLOPS_S)
    out["ms"], out["plain_ms"] = res["cuda_update"], res["plain_update"]
    out["library_ms"] = res["adam_fused"]
    log(f"[20] {card}: adam kernel {out['ms']:.4f} ms at ({om.ROWS}, {om.COLS}) (bound "
        f"{out['bound'][0]:.4f} ms by {out['bound'][1]}, {100 * out['bound'][0] / out['ms']:.1f}%); "
        f"twin {out['plain_ms']:.4f} ms; Adam(fused=True) {res['adam_fused']:.4f} ms, "
        f"Adam(foreach=True) {res['adam_foreach']:.4f} ms; {out['launches']} launches")
    return out


# ---------------------------------------------------------------- phase 21
def phase_int8_dot(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import mosaic_int8_dot as md

    out = {"err": 0.0}
    g = torch.Generator(device="cuda").manual_seed(72)

    def operands(M, K, N):
        a = torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        m = (torch.rand(N, generator=g, device="cuda") + 0.5) * (2e-2 / K**0.5)
        return a, w, m

    for M in (4096, 2**20 + 17):
        for name, K, N in md.CASES:
            a, w, m = operands(M, K, N)
            got, ref = md.int8_dot(a, w, m), md.int8_dot_reference(a, w, m)
            out["err"] = max(out["err"], float((got.int() - ref.int()).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 dot {name} at M = {M} differs from its twin in "
                                     f"{int((got != ref).sum())} values")
            del a, w, m, got, ref
    log(f"[21] {card}: int8 dot == twin bit for bit in all {len(md.CASES)} cases at M = 4096 "
        f"and {2**20 + 17}")
    res, out["launches"] = _harness(md, 21)
    out["ms"], out["library_ms"] = res["l2-im2col"]
    a, w, m = operands(md.M_DEFAULT, 1152, 128)
    out["plain_ms"] = cuda_ms(lambda: md.int8_dot_reference(a, w, m), iters=2, warmup=1)
    ops, n_bytes = md.work(md.M_DEFAULT, 1152, 128)
    out["bound"] = bound(n_bytes, ops, INT8_OPS_S)
    log(f"[21] {card}: l2-im2col (M = {md.M_DEFAULT}, K = 1152, N = 128): kernel "
        f"{out['ms']:.4f} ms (bound {out['bound'][0]:.4f} ms by {out['bound'][1]}, "
        f"{100 * out['bound'][0] / out['ms']:.1f}%), twin {out['plain_ms']:.3f} ms, "
        f"torch._int_mm {out['library_ms']:.4f} ms; {out['launches']} launches")
    del a, w, m
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 22
def phase_conv_stats(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import bf16_ulp
    from yolo_tpu_torch.experiments import conv_bn_fuse_bench as cb

    out = {"err": 0.0}
    g = torch.Generator(device="cuda").manual_seed(73)
    for name, h, c, k in cb.GEOMETRIES:
        for n in (2, 128):
            x = torch.randn((n, h, h, c), generator=g, device="cuda").to(torch.bfloat16)
            w9 = (torch.randn((9, c, k), generator=g, device="cuda") / (9 * c) ** 0.5).to(
                torch.bfloat16)
            y_ref, s_ref = cb.conv3x3_bf16_reference(x, w9, stats=True)
            acc = cb.conv3x3_acc_reference(x, w9).double()
            scale = torch.stack([acc.abs().sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))])
            del acc
            y0, _ = cb.conv3x3_bf16(x, w9)
            y, s = cb.conv3x3_bf16(x, w9, stats=True)
            _, s2 = cb.conv3x3_bf16(x, w9, stats=True)
            err = float((y.float() - y_ref.float()).abs().max())
            out["err"] = max(out["err"], err)
            ulp = bf16_ulp(float(y_ref.float().abs().max()))
            s_err = float(((s.double() - s_ref).abs() / scale).max())
            if not (torch.equal(y0, y) and err <= ulp):
                raise AssertionError(f"bf16 conv {name} batch {n}: y differs from the twin "
                                     f"by {err} (one ulp {ulp})")
            if not s_err <= 1e-5:
                raise AssertionError(f"bf16 conv {name} batch {n}: stats off by {s_err:.3e} "
                                     f"of sum|acc|")
            if not torch.equal(s, s2):
                raise AssertionError(f"bf16 conv {name} batch {n}: stats differ run to run")
            log(f"[22] {card}: bf16 conv {name} batch {n}: y within {err:.3e} (one ulp "
                f"{ulp:.3e}), stats within {s_err:.2e} of sum|acc|, identical run to run")
            if name == "layer3_conv2" and n == 128:
                out["plain_ms"] = cuda_ms(lambda: cb.conv3x3_bf16_reference(x, w9), iters=2,
                                          warmup=1)
            del x, w9, y_ref, s_ref, y0, y, s, s2
    torch.cuda.empty_cache()
    res, out["launches"] = _harness(cb, 22)
    rows = res["layer3_conv2"]
    out["ms"], out["library_ms"] = rows["cuda_conv"], rows["cudnn_conv"]
    flops, n_bytes = cb.work(128, 28, 256, 256)
    out["bound"] = bound(n_bytes, flops, BF16_FLOPS_S)
    log(f"[22] {card}: layer3 conv2 b128: kernel {out['ms']:.4f} ms (bound "
        f"{out['bound'][0]:.4f} ms by {out['bound'][1]}, {100 * out['bound'][0] / out['ms']:.1f}%),"
        f" with stats {rows['cuda_conv_sums']:.4f} ms ({rows['cuda_conv_stats']:.4f} with "
        f"the normalize), twin "
        f"{out['plain_ms']:.3f} ms, cuDNN conv {rows['cudnn_conv']:.4f} ms, cuDNN conv + BN "
        f"{rows['cudnn_conv_bn']:.4f} ms; {out['launches']} launches")
    return out


# ---------------------------------------------------------------- phase 23
def phase_bf16_bottleneck(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import bf16_ulp
    from yolo_tpu_torch.experiments import fused_block_pallas as fb

    out = {"err": 0.0}
    for n, h in ((2, 112), (fb.N, 112), (2, 13), (fb.N, 13)):
        args = fb.random_block(n, h, h, fb.CIN, fb.P, "cuda", seed=n + h)
        ref = fb.reference(*args).float()
        got = fb.fused_bottleneck(*args).float()
        err = float((got - ref).abs().max())
        out["err"] = max(out["err"], err)
        tol = 2 * bf16_ulp(float(ref.abs().max()))
        if bool(got.isnan().any()) or not err <= tol:
            raise AssertionError(f"bf16 bottleneck batch {n}, {h}x{h}: |diff| {err} (2 ulps "
                                 f"{tol}), NaN {bool(got.isnan().any())}")
        log(f"[23] {card}: bf16 bottleneck batch {n}, {h}x{h}, {fb.CIN}/{fb.P}: |diff| <= "
            f"{err:.3e} (2 ulps of max|twin| {tol:.3e}), no NaN")
        del args, ref, got
    torch.cuda.empty_cache()
    res, out["launches"] = _harness(fb, 23)
    out["ms"], out["plain_ms"], out["library_ms"] = res["kernel"], res["plain"], res["cudnn"]
    flops, n_bytes = fb.work(fb.N, fb.H, fb.W, fb.CIN, fb.P)
    out["bound"] = bound(n_bytes, flops, BF16_FLOPS_S)
    log(f"[23] {card}: layer1 b{fb.N}: kernel {out['ms']:.4f} ms (bound {out['bound'][0]:.4f} "
        f"ms by {out['bound'][1]}, {100 * out['bound'][0] / out['ms']:.1f}%), twin "
        f"{out['plain_ms']:.3f} ms, cuDNN's three bf16 convs {out['library_ms']:.4f} ms; "
        f"{out['launches']} launches")
    return out


def main() -> None:
    if not (REPO / "yolo_tpu_torch" / "csrc" / "nms.cu").is_file():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(yolo_tpu_torch/ is not beside this script)")
    sys.path.insert(0, str(REPO))
    import torch

    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        log(f"[{phase}] phase took {seconds[phase]:.1f} s")
        return out

    card = timed(1, phase_environment)
    timed(2, phase_build)
    kv = timed(3, phase_kernel_vs_plain)
    engine, thr, thr_cli, launches = timed(4, phase_slice)
    timed(5, phase_entry_point, engine, thr_cli)
    timed(6, phase_timing, engine, thr, card)
    del engine
    torch.cuda.empty_cache()
    bn = timed(7, phase_fused_bn_kernels)
    bn_launches = timed(8, phase_train_slice)
    timed(9, phase_train_entry_points)
    timed(10, phase_train_timing, card)
    i8k = timed(11, phase_int8_kernels, card)
    engine, model, thr, i8_launches = timed(12, phase_int8_slice)
    timed(13, phase_int8_timing, engine, model, thr, card)
    del engine
    torch.cuda.empty_cache()
    ck = timed(14, phase_chain_kernels, card)
    chained, default, q, thr, ch_launches = timed(15, phase_chain_slice, model)
    timed(16, phase_chain_timing, chained, default, q, thr, card)
    del chained, default, q
    torch.cuda.empty_cache()
    wk = timed(17, phase_wino_kernels, card)
    q, thr, wino_launches = timed(18, phase_wino_slice, model)
    timed(19, phase_wino_timing, q, thr, card)
    del q, model
    torch.cuda.empty_cache()
    experiments = {
        "adam_update": ("adam_update.cu", "experiments/opt_update_microbench.py:65",
                        timed(20, phase_adam, card)),
        "int8_dot": ("int8_dot.cu", "experiments/mosaic_int8_dot.py:55",
                     timed(21, phase_int8_dot, card)),
        "bf16_conv3x3": ("bf16_conv_stats.cu", "experiments/conv_bn_fuse_bench.py:47",
                         timed(22, phase_conv_stats, card)),
        "bf16_bottleneck": ("bf16_bottleneck.cu", "experiments/fused_block_pallas.py:31",
                            timed(23, phase_bf16_bottleneck, card)),
    }
    log("phase seconds: " + ", ".join(f"{k}: {v:.1f}" for k, v in seconds.items()))

    k_ms, p_ms, b_ms, b_by = kv["timings"][(SLICE_BATCH, 98)]
    record = {"kernels": [{
        "name": "nms",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_tpu/ops/pallas_nms.py:42",
        "launches": launches,
        "max_abs_err": kv["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]}
    replaces = {"stats": 98, "normalize": 155, "bwd_reduce": 222, "bwd_dx": 256}
    from yolo_tpu_torch.ops.fused_bn import bytes_moved

    m_stem, c_stem = 16 * 224 * 224, 64
    for name, line in replaces.items():
        # ms / plain_ms / bound: the stem BN of the fp32 slice (M = 802,816, C = 64).
        k_ms, p_ms, _ = bn["timings"][("stem bn1", "f32", name)]
        b_ms, b_by = bound(bytes_moved(name, m_stem, c_stem, 4, relu=True), 0, FP32_FLOPS_S)
        record["kernels"].append({
            "name": f"bn_{name}",
            "route": "cuda",
            "source": "yolo_tpu_torch/csrc/fused_bn.cu",
            "replaces": f"yolo_tpu/ops/fused_bn.py:{line}",
            "launches": bn_launches[name],
            "max_abs_err": bn["max_abs_err"][name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": (bn["timings"][("stem bn1", "f32", "library_stats")]
                           if name == "stats" else None),
        })
    # The stem front at the slice's batch and wire format (16 uint8 images).
    k_ms, p_ms, b_ms, b_by, _ = i8k["stem"][(SLICE_BATCH, "uint8")]
    record["kernels"].append({
        "name": "quant_s2d",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/quant_s2d.cu",
        "replaces": "yolo_tpu/serving/pallas_stem.py:38",
        "launches": i8_launches[0],
        "max_abs_err": i8k["stem_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    # The int8 conv at layer1's 1x1 256 -> 64 (blocks 1-2), batch 16, where
    # torch._int_mm computes the same accumulator.
    k_ms, p_ms, b_ms, b_by, lib_ms, _ = i8k["conv"]["layer1.1.conv1"]
    record["kernels"].append({
        "name": "int8_conv",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/int8_conv.cu",
        "replaces": "yolo_tpu/serving/pallas_int8.py:470",
        "launches": i8_launches[1],
        "max_abs_err": i8k["conv_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,
    })
    # The fused kernels at layer1 (the chain with its downsample block; the
    # block kernel on an identity block), batch 16; launches per served batch.
    for name, key, line, count in (
            ("int8_bottleneck", "block", 49, ch_launches["identity blocks via block_int8"][3]),
            ("int8_chain", "chain", 253, ch_launches["chains on layers 1-4"][2])):
        k_ms, p_ms, b_ms, b_by, _, _ = ck[key]["layer1"]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "yolo_tpu_torch/csrc/int8_bottleneck.cu",
            "replaces": f"yolo_tpu/serving/pallas_int8.py:{line}",
            "launches": count,
            "max_abs_err": ck[f"{key}_err"],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    # The Winograd kernel at head.conv1 (14x14, 2048 -> 1024, leaky), batch 16,
    # launches per served batch of the wino engine; its ablation modes at the
    # same geometry, launches from the ablation's own run.
    k_ms, p_ms, b_ms, b_by, lib_ms, _ = wk["conv"]["head.conv1"]
    record["kernels"].append({
        "name": "int8_wino",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/int8_wino.cu",
        "replaces": "yolo_tpu/serving/pallas_wino.py:46",
        "launches": wino_launches[2],
        "max_abs_err": wk["err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,
    })
    for mode in ("taps", "dots", "dots-raw"):
        k_ms, p_ms, b_ms, b_by = wk["modes"][mode]
        record["kernels"].append({
            "name": f"int8_wino_{mode.replace('-', '_')}",
            "route": "cuda",
            "source": "yolo_tpu_torch/csrc/int8_wino.cu",
            "replaces": "experiments/wino_ablate.py:57",
            "launches": wk["ablation_launches"][mode],
            "max_abs_err": wk["mode_err"],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    # The four experiments/ kernels at their harnesses' geometries (Adam at
    # fc1, the int8 dot at l2-im2col, the conv at layer3 without stats, the
    # bottleneck at layer1); launches from each harness's own run.
    for name, (src, line, r) in experiments.items():
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"yolo_tpu_torch/csrc/{src}",
            "replaces": line,
            "launches": r["launches"],
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
