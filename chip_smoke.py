#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Drives the port's two paths at full width (ResNet50 YOLOv1, 448x448, 20
classes, random weights from a seed): inference (forward -> decode ->
per-class greedy NMS through the hand-written CUDA kernel, float32) and
training (Trainer.train_step with the train-mode BatchNorm through the four
hand-written fused-BN kernels). Phases:

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
   64.

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
            timings[(n, K)] = (k_ms, p_ms)
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
HBM_PEAK_GBS = 3350.0  # H100 SXM data sheet, at the full 700 W


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
    log("phase seconds: " + ", ".join(f"{k}: {v:.1f}" for k, v in seconds.items()))

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
    replaces = {"stats": 98, "normalize": 155, "bwd_reduce": 222, "bwd_dx": 256}
    for name, line in replaces.items():
        # ms / plain_ms: the stem BN of the fp32 slice (M = 802,816, C = 64).
        k_ms, p_ms, _ = bn["timings"][("stem bn1", "f32", name)]
        record["kernels"].append({
            "name": f"bn_{name}",
            "route": "cuda",
            "source": "yolo_tpu_torch/csrc/fused_bn.cu",
            "replaces": f"yolo_tpu/ops/fused_bn.py:{line}",
            "launches": bn_launches[name],
            "max_abs_err": bn["max_abs_err"][name],
            "ms": k_ms,
            "plain_ms": p_ms,
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
