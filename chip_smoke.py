#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Drives the port's paths at full width (ResNet50 YOLOv1 and, from phase
29, the 24-conv YOLOv1; 448x448, 20 classes, random weights from a seed):
inference (forward -> decode -> per-class greedy NMS through the
hand-written CUDA kernel, float32),
training (Trainer.train_step with the train-mode BatchNorm through the four
hand-written fused-BN kernels), int8 serving (fold -> calibrate ->
quantize -> the quantize+space-to-depth stem kernel and the int8 conv +
requant kernel for every conv -> decode -> NMS), and int8 serving with the
stage-chain hooks (each stage's stride-1 bottlenecks through the fused
chain kernel, or each identity block through the fused bottleneck kernel),
evaluation (the mAP evaluator, NMS through the kernel on its fast path,
the evaluate CLI, train --compute-map, the int8 accuracy gate), and serving
(every engine replayed from captured CUDA graphs, the HTTP server, the
batcher and the serve CLI), and the model variants (the 24-conv model's
inference and training, remat, and the dynamic-int8 quantized=True model
on the int8 conv kernel). Phases:

1. environment: card name and power limit, torch, compute capability 9.0;
   TF32 off for convolutions and matmuls (exact float32);
2. build: nvcc compiles yolo_tpu_torch/csrc/*.cu for sm_90a (ptxas'
   registers and spills logged a kernel); the kernels on the shared wgmma
   core (csrc/sm90_conv_core.cuh: the int8 conv, which also runs the int8
   dot, the bf16 conv and the Winograd conv's tap GEMM) and on its
   fused-bottleneck tile (csrc/sm90_bottleneck_tile.cuh: the int8 block and
   chain, the bf16 bottleneck) must show IGMMA / HGMMA and no IMMA / HMMA
   in cuobjdump's SASS;
3. kernel vs plain: the NMS kernel's keep masks against its plain torch twin
   on CPU copies, over seeded batches (K = 98, 162, 392; eps 1e-6 and 0;
   t 0.4 and 0.5; tie storms; all-invalid rows; rows all valid at -inf; one
   class at K = 1024 with a row of one repeated box); at (1, 16, 64, 256) x
   K = 98 and (256, 392) the kernel's device time (CUDA graph) beside an empty
   launch of the same grid, its bound and the twin's time, and the wrapper's
   time and host time a call; the float64 instantiation (the precise
   evaluator's) on the same cases in float64, and its device time at
   (16, 98) and (64, 98);
4. slice: YOLOInference.predict_batch_arrays on 16 seeded uint8 images with
   the median decoded score as threshold; the NMS launch count must grow,
   keep masks must equal decode + the plain NMS on CPU copies, and one
   image's raw grid must match the same model on the CPU;
5. entry point: the predict CLI on a saved .pth and a few seeded JPEGs;
6. timing (information only): img/s at batch 1, 16 and 64; NMS's share of
   the batch at batch 1;
7. fused-BN kernels vs plain twins: every kernel at the (M, C) of the
   training slice's BN layers at batch 16, float32 and bf16, residual and
   ReLU on and off, against the twins on the same card; reductions run
   twice and must be identical; wrapper times by CUDA events, device times
   by torch.profiler, and the GB/s those reach (by the wrapper's time where
   the profiler records no device activity); in float32 the nearest
   one-call torch counterparts at each shape (torch.batch_norm_stats,
   batch_norm_elemt, batch_norm_backward_reduce, batch_norm_backward_elemt);
8. training slice: one fp32 train step of the fused ("full") model and of
   the same weights unfused, on one dropout mask: losses, gradients and BN
   running buffers agree; each fused-BN kernel launched 53 times per step
   (the launch counts are zeroed just before); 3 more steps, a bf16
   autocast step, and a "stats"-mode step that launches only the stats
   kernel;
9. entry points: the train CLI on a synthetic VOC tree (1 epoch, then
   --resume true for a second);
10. timing (information only): the host's cost of one BN layer per mode;
   then train step ms, img/s, idle share, the host's time to issue a step,
   synchronizing calls per step, top kernels and peak memory for fused_bn
   False / "stats" / "full", fp32 at batch 16 and 32, bf16 at batch 32 and
   64;
11. int8 kernels vs plain twins: the stem front at batch 1, 16, 64 and 256
   on 448x448 uint8 and float32 images (device time from CUDA graphs beside
   the byte bound, the wrapper's time and host time a call, the twin's), and
   at ragged widths and on a misaligned view, and the int8 conv at every distinct
   conv geometry and epilogue of the full-width engine at batch 2 (plus the
   direct 7x7 stem), int8 output and int32 accumulator, bit for bit against
   the twins on the card, and likewise fc1 at batch 1, 16 and 17, every
   conv that plan() splits at batch 16, the space-to-depth stem's 4-byte
   gather at batch 16, and two forced split counts; kernel times at every
   distinct geometry at batch 16 and 256 beside the bound, with the twin,
   torch._int_mm (1x1 stride-1 convs) and every tile unsplit (the numbers
   behind plan()) at batch 16, and the sums of kernel and bound over all
   58 convs;
12. int8 slice: YOLOInference(optimize="int8") calibrated on two seeded
   batches of 8, predict_batch_arrays on 16 seeded uint8 images: the stem
   kernel launched once and the conv kernel 58 times per forward (counts
   zeroed just before), keep masks equal the twin path's on the card, the
   grid correlates > 0.98 with the fp32 slice's; save_engine -> a fresh
   engine gives identical detections; the predict CLI with --int8
   --save-engine, then --engine;
13. timing (information only): int8 and fp32 img/s at batch 1, 16, 64 and
   256, the idle share, and each kernel's share of device time; NMS's share
   of the int8 batch at batch 1;
14. fused bottleneck kernels vs plain twins: at each stage's full-width
   chain geometry (seeded q-params), batch 2 and 16, the chain kernel on the
   stage's whole chain (layer1's downsample block included) and the block
   kernel on the stage's identity block, bit for bit against the twins on
   the card; kernel and per-conv (int8 conv kernel) device times (CUDA
   graphs) and wrapper times, and the twin's, beside the bound; every tile
   plan() weighs, forced, at batch 16; resident blocks against tiles at
   batch 1;
15. stage-chain slice: build_int8_predict with impl["layer1".."layer4"] =
   chain_int8 on the phase-12 model: one served batch launches the stem
   kernel once, the conv kernel 18 times and the chain kernel 4 times
   (counts zeroed just before); its grid equals the default engine's bit for
   bit and its keep masks are equal; then every identity block through
   block_int8 (1 / 22 / 12 launches), the same grid;
16. timing (information only): default vs chained int8 img/s at batch 1,
   16, 64 and 256, in turns, with the idle share;
17. Winograd conv (csrc/int8_wino.cu: a tap pass, then a tap GEMM on the
   wgmma core) vs plain twin: at each distinct stride-1 3x3 conv of the
   full-width engine (seeded q-params), batch 2 and 16, leaky or ReLU as
   the engine uses them, bit for bit; at batch 16 and 256 the tap pass,
   the tap GEMM and the conv (device times from CUDA graphs, each beside
   its bound), the wrapper and the direct int8 conv; at batch 16 the twin
   and 16 x torch._int_mm; every tile plan() can pick at a ragged Mt;
   the ablation modes (taps, dots, dots-raw) against their twins at
   head.conv1 geometry; then python -m
   yolo_tpu_torch.experiments.wino_ablate at its defaults;
18. Winograd slice: YOLOInference(optimize="int8", wino=<all 16 convs>) on
   the phase-12 model: one served batch launches the stem kernel once, the
   int8 conv kernel 42 times and the Winograd kernel 16 times (counts
   zeroed just before); its grid equals the same engine's with the twin for
   every Winograd conv, bit for bit, with equal keep masks, and correlates
   with the default engine's; save_engine -> a fresh engine reinstalls the
   hooks and gives identical detections; predict --int8 --engine <it>;
19. timing (information only): default vs wino (all 16) vs wino
   (head_conv1, 3, 4) img/s at batch 1, 16, 64 and 256, in turns;
20. fused Adam update (csrc/adam_update.cu) vs its plain twin, bit for bit,
   at (512, 256) and fc1's (50176, 4096); check_vs_torch_adam (the kernel
   against step 8 of the port's Adam + clip_grad_norm_, rtol 1e-6); then
   python -m yolo_tpu_torch.experiments.opt_update_microbench (kernel, twin,
   torch.optim.Adam fused and foreach, in ms and GB/s);
21. int8 dot + requant (the int8 conv kernel, csrc/int8_conv.cu, on an (M,
   1, 1, K) view) vs its twin, bit for bit, in the five (K, N) cases at M =
   4096 and M = 2**20 + 17 (a ragged tail; K = 300 rows only 4-byte
   aligned); then python -m yolo_tpu_torch.experiments.mosaic_int8_dot
   (kernel and torch._int_mm); then each case's device time (CUDA graphs)
   beside its bound and _int_mm's, with every tile forced;
22. bf16 3x3 conv + BN statistics (csrc/bf16_conv_stats.cu) vs its twin at
   the layer3 and layer4 identity-conv2 geometries, batch 2 and 128, and
   at 13x13 (batch 1 and 2): y
   within one bf16 ulp of max|twin|, the sums within 1e-5 of sum|acc| (of
   sum acc^2), identical from run to run; then python -m
   yolo_tpu_torch.experiments.conv_bn_fuse_bench (cuDNN conv, cuDNN conv +
   batch_norm, the kernel, the kernel with stats + normalize, the kernel
   with stats alone);
23. bf16 fused bottleneck (csrc/bf16_bottleneck.cu) vs its twin at layer1's
   widths (256 / 64), batch 2 and 64, H = W = 112 and 13: within 2 bf16 ulps
   of max|twin|, no NaN; the kernel's device time (CUDA graph) at batch 64,
   112x112, on plan()'s tile and on every tile forced; then python -m
   yolo_tpu_torch.experiments.fused_block_pallas (kernel, twin, cuDNN's three
   bf16 convs).
24. evaluator: mAPMetric's fast path (float32 on the card, NMS through the
   kernel at eps 0) on seeded grids, exact-IoU grids (0.5 / 0.75 / 1, a
   duplicate, tied scores) and a ragged batch masked, at NMS 0.4 and 1.1:
   all 77 keys and every per-batch array equal the fast path on the CPU,
   and the precise path's (float64 on the card, the kernel's float64
   instantiation) the precise path's on the CPU, one NMS launch a batch on
   each (counts zeroed just before); the keys on which the two paths differ
   printed. Then python -m
   yolo_tpu_torch.evaluate at full width (fc2 set to find the dogs) on a
   synthetic VOC tree of 10 centred dogs in batches of 4 (the last
   ragged), fp32 precise and fast, --int8
   --calib-data 2012:train and --engine <an artifact of that engine>: each
   run's launches (stem / conv / NMS) counted from 0, its 77 keys and
   report, the fp32 and --engine keys equal to an in-process
   evaluate_model's, --engine equal to --int8; then one epoch of python -m
   yolo_tpu_torch.train --compute-map --map-frequency 1 at --image-size 64,
   resumed from a model whose fc2 bias detects the tree's centred dogs,
   must write yolo_best_map.pth;
26. accuracy gate: python -m yolo_tpu_torch.quant_accuracy --chain at its
   defaults (1500 bf16 steps on one synthetic batch at 224x224): the
   trained model, the default int8 engine and the chained engine must
   PASS (mAP50 > 0.5, each int8 engine within 1 point), with exactly the
   launches of one forward of each engine and one NMS a metric pass;
27. CUDA graphs (serving/graphs.py): the default int8 engine, the chained
   engine (one cooperative chain launch a stage, captured), the engine with
   all 16 Winograd convs and the exact fp32 path, each replayed from one
   captured graph a batch at batch 1, 16 and 64 on seeded uint8 images,
   against its eager call on two image sets: bit for bit (exactly for
   fp32), the second replay giving its own images' result; replays move no
   launch counter; ms a batch of the graph and of the eager call (CUDA
   events), the eager call's host issue time and the memory each capture
   keeps reserved;
28. the server: YOLOServer on 127.0.0.1:0 over the graph-wrapped default
   int8 engine, buckets (1, 4, 16), 2 ms, the launch counts zeroed just
   before its buckets are captured and read after, exactly 3 buckets x 3
   runs x (1, 58, 1) (replays leave them unchanged; torch.profiler counts
   5 replays' kernels, at most 5 x (1, 58, 1)); 256 requests of seeded
   448x448 PNGs from 1, 4, 16 and 64 concurrent clients, each answer equal
   to detections_to_json of a direct batch-1 call (same classes and order
   up to score ties, box and score within rtol 1e-4, atol 1e-6);
   requests/s, p50 and p99 latency, batches, images a batch, bucket fill
   and the device's idle share (busy = the device time torch.profiler
   traced over the window, at most its wall time, with at most the
   window's batches x (1, 58, 1) kernels); the same for the batcher alone (submit of
   the decoded uint8 arrays); groups that fill a bucket exactly, each
   result equal to the direct call on that bucket bit for bit; then python
   -m yolo_tpu_torch.serve --engine <the engine's artifact> --port 0 as a
   subprocess: its printed port, /healthz, one /predict equal to the
   in-process answer, stopped by SIGINT;
29. the 24-conv YOLOv1 (YOLOv1Backbone + SimpleHead, 448x448, 20 classes,
   seeded): its raw grid on the card against the same model on the CPU at
   batch 2; YOLOInference.predict_batch_arrays at batch 16 launches NMS
   exactly once (count zeroed just before), keep masks == decode + plain
   NMS on CPU copies; predict and evaluate --backbone yolov1 on a saved
   .pth (evaluate: 77 finite keys, one NMS launch a batch); img/s at batch
   1, 16 and 64;
30. 24-conv training: three fp32 steps at batch 16 on one fixed batch and
   dropout mask, loss finite and falling; train --backbone yolov1 at
   --image-size 64 for an epoch, then --resume true for a second; step ms,
   img/s and peak memory, fp32 at batch 16 and bf16 at batch 32;
31. remat at full-width ResNet50: one fp32 step at batch 8 (one batch, one
   dropout mask, cuDNN deterministic) for remat "none", "block" and
   "stage", each with fused_bn False and "full": loss parts (rtol 1e-4)
   and BN running buffers (phase 8's tolerance) agree with "none", every
   gradient within 4x the spread of two "none" steps (relative L2, plus
   1e-5), num_batches_tracked 1 for every BN, and the fused-BN launches
   counted from 0: 53 each for "none", stats and normalize 105 and the
   backward kernels 53 under "block" and "stage" (the recompute re-runs
   the forward of the 52 BNs inside the bottlenecks); then peak memory and
   step ms for the three at bf16 batch 64 and 128;
32. create_model(quantized=True), the dynamic-int8 variant, at full width,
   ResNet50 and 24-conv: every distinct int8 conv geometry at batch 2 (the
   module's own quantized input, weight and scales) through the int8 conv
   kernel's "float" epilogue, bit for bit against conv_int8_reference and
   the module's output; one forward at batch 16 launches the kernel 57
   (ResNet50: 53 backbone + 4 head convs) or 24 times (counts zeroed just
   before); the grid within 5% of the fp32 model's max |grid|; ms a batch
   beside the fp32 model's;
33. parallelism, training, in spawned ranks (ResNet50, 448x448, fp32, TF32
   off, deterministic cuDNN, batch 16, one dropout mask): (a) an NCCL world
   of 1 with DistributedDataParallel: loss, every gradient and BN buffer
   bit for bit against the plain Trainer, both step times; (b) a gloo world
   of 2 on the card, mesh (2, 1), 8 images a rank, synchronized BN: loss
   rtol 1e-5 against one process at 16, each step's gradients held to a
   float64 step (the synchronized step within 2x one process's distance),
   running stats within 1e-5 of max |value|, each rank 53 launches of each
   fused-BN kernel and 106 BN all-reduces; (c) a gloo world of 2, mesh
   (1, 2): fc1 (2048, 50176) a rank, the grid within 1e-5 of the unsharded
   model's max, the norm of the same gradients from the shards and
   gathered within 1e-6, the sharded step's norm within 2x one process's
   distance to float64's, peak memory a rank beside one process's;
34. a gloo (2, 1) world: make_sharded_int8_engine_fn at global batch 32,
   each rank's detections == the default engine's on its 16 images, 1 / 58
   / 1 launches a rank; evaluate_model(mesh=...) fast path with a detecting
   model: 77 keys == one process at batch 16, one NMS launch a rank a batch;
35. torchrun --standalone --nproc-per-node 2 (gloo on the one card):
   train --mesh-data 2 --orbax-checkpoints, --resume orbax, train
   --mesh-model 2, evaluate --mesh-data 2, then predict on the .pth.
36. (run right after phase 28, on phase 27's engine) the AOT artifact:
   save_compiled_engine's two halves on the full-width default int8 engine
   at batch 16, uint8 wire (export s, save s, MB), load_compiled_engine
   (s); one eager call of the loaded program launches the stem front,
   the int8 conv and NMS exactly (1, 58, 1) times (counts zeroed just
   before); its CUDA-graph replay == the live engine's graph replay bit for
   bit on two seeded image sets, the replay's kernels by torch.profiler,
   both replays' ms and both eager calls' ms (CUDA events, in turns); host
   us a call of each of the three custom ops against its wrapper, under
   inference_mode as the engines run them; a CPU-device load is refused;
   serve --compiled returns a GraphedPredict with the bucket (16,).
Phases 20-23 drive each harness through its main() with its kernel's
launch count zeroed just before and read just after.

``python3 chip_smoke.py --int8-conv-times DIR`` instead times the NMS kernel
at phase 3's shapes and the stem front at batch 1 to 256 (device time from
CUDA graphs, the wrapper's time and host time a call), and the int8 conv
of the checkout at DIR (device time from CUDA graphs, and the wrapper's) at
every distinct engine geometry at batch 16, with the sums over all 58
convs, the int8 dot in its five cases at M = 2^20 beside torch._int_mm,
and the Winograd conv at its six geometries at batch 16 and 256 beside the
direct int8 conv (a Winograd wrapper that a CUDA graph cannot capture is
timed between CUDA events instead and printed as "wrapper", host time
included), the fused int8 chain and identity block at each stage's
full-width geometry at batch 16 beside the per-conv path, and the bf16
fused bottleneck at batch 64, 112x112, 256/64 (device times from CUDA
graphs, and the wrapper's): the way to hold two versions of the kernels
against each other on one card.

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


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the host's
    cost of each call (the Python wrapper, the launch) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


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
        elif "error" in line or "wgmma" in line:
            log(f"[2]   {line.strip()}")
    # The kernels on the shared core run on wgmma (the int8 conv, which also
    # runs the int8 dot; the bf16 conv; the Winograd conv's tap GEMM), and so
    # do the fused bottlenecks on its tile routine (the int8 block and chain,
    # the bf16 bottleneck): IGMMA / HGMMA in their SASS, and no mma.sync
    # (IMMA / HMMA) anywhere in them.
    on_core = ("int8_conv_kernel<", "conv3x3_kernel<", "wino_gemm_kernel<",
               "int8_bottleneck_kernel(", "int8_chain_kernel(", "bf16_bottleneck_kernel(")
    bf16 = ("conv3x3_kernel<", "bf16_bottleneck_kernel(")
    checked = 0
    for fn, ops in sass_counts(path).items():
        if any(name in fn for name in on_core):
            checked += 1
            want, banned = (("HGMMA", "HMMA") if any(n in fn for n in bf16)
                            else ("IGMMA", "IMMA"))
            log(f"[2]   SASS {fn[:70]}: " + ", ".join(f"{k} {v}" for k, v in sorted(ops.items())))
            if not ops.get(want) or ops.get(banned):
                raise AssertionError(f"{fn}: expected {want} and no {banned} in its SASS, got "
                                     f"{ops}")
    # 12 int8 conv instantiations (4 tiles x 3 gathers), 2 bf16, 4 tap GEMM,
    # the int8 bottleneck and chain, the bf16 bottleneck.
    if checked != 21:
        raise AssertionError(f"found {checked} wgmma kernels in the SASS, expected 21")


def sass_counts(path: Path) -> dict:
    """{kernel: {opcode: count}} of the tensor-core opcodes (IGMMA, HGMMA,
    IMMA, HMMA) in the library's SASS, by ``cuobjdump -sass``; kernel names
    demangled where c++filt is there."""
    from yolo_tpu_torch.utils import kernels

    cuobjdump = Path(kernels.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("IGMMA", "HGMMA", "IMMA", "HMMA"):
                if op in line:
                    counts[fn][op] = counts[fn].get(op, 0) + 1
    demangle = shutil.which("c++filt")
    if demangle:
        names = subprocess.run([demangle], input="\n".join(counts), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


# ---------------------------------------------------------------- phase 3
# (batch, K) at which the NMS kernel is timed: the slice's K = 98 from one
# image to 256, and K = 392 (a 14x14x2 grid).
NMS_TIMED = ((1, 98), (SLICE_BATCH, 98), (64, 98), (256, 98), (256, 392))
NMS_THREADS = 512  # csrc/nms.cu's block: one image a block


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return, issue only (no
    synchronize inside the timed loop), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def nms_kernel_ms(cuda_nms, args) -> float:
    """Device ms of the NMS kernel alone (``cuda_nms._launch``, no checks and
    no work around it) at IoU 0.4 and eps 1e-6, from a CUDA graph."""
    t, eps = float(np.float32(IOU_T)), float(np.float32(1e-6))
    return graph_ms(lambda: cuda_nms._launch(*args, t, eps), iters=50)


def empty_launch_ms(blocks: int, threads: int) -> float:
    """Device ms of one launch of ``blocks`` empty blocks of ``threads``
    threads, from a CUDA graph as ``graph_ms`` times a kernel: the floor that
    one launch of that grid cannot go below."""
    import torch

    from yolo_tpu_torch.utils import kernels

    lib = kernels.load()
    return graph_ms(lambda: kernels.check(
        lib.yolo_empty(blocks, threads, torch.cuda.current_stream().cuda_stream), "yolo_empty"))


def _case(seed: int, n: int, K: int, kind: str):
    """Seeded detections (numpy). ``ties``: 3 score levels incl. both signed
    zeros, boxes drawn from 4 per image; ``minus_inf``: every other row all
    valid at score -inf; ``single_class``: one class, the first row one box
    repeated (every pair overlaps). The last row (of several) is all invalid."""
    r = np.random.default_rng(seed)
    boxes = r.uniform(0.05, 0.95, size=(n, K, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.4
    scores = r.uniform(size=(n, K)).astype(np.float32)
    cls = r.integers(0, 4, size=(n, K)).astype(np.int32)
    valid = r.uniform(size=(n, K)) < 0.75
    if kind == "ties":
        boxes = np.take_along_axis(
            boxes, r.integers(0, 4, size=(n, K, 1)).repeat(4, axis=2), axis=1)
        scores = np.array([0.0, -0.0, 0.5], np.float32)[r.integers(0, 3, size=(n, K))]
    elif kind == "minus_inf":
        scores[::2] = -np.inf
        valid[::2] = True
    elif kind == "single_class":
        cls[:] = 0
        boxes[0] = boxes[0, 0]
    if n > 1:
        valid[-1] = False
    return boxes, scores, cls, valid


def phase_kernel_vs_plain(card: str) -> dict:
    import torch

    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.decode import Detections

    dev = torch.device("cuda")
    cases = [(n, 98, "uniform") for n in (1, SLICE_BATCH, 64, 256)]
    cases += [(256, 162, "uniform"), (256, 392, "uniform"), (256, 98, "ties"),
              (256, 392, "ties"), (SLICE_BATCH, 98, "minus_inf"), (4, 1024, "single_class")]
    n_cases, mismatches, timings = 0, 0, {}
    for ci, (n, K, kind) in enumerate(cases):
        arrays = _case(1000 + ci, n, K, kind)
        cpu = Detections(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
        gpu = Detections(*(t.to(dev) for t in cpu))
        cpu64 = cpu._replace(boxes=cpu.boxes.double(), scores=cpu.scores.double())
        gpu64 = Detections(*(t.to(dev) for t in cpu64))
        for eps in (1e-6, 0.0):
            for t in (0.4, 0.5):
                for tag, c, g in (("f32", cpu, gpu), ("f64", cpu64, gpu64)):
                    got = cuda_nms.nms(g, t, eps=eps).valid
                    torch.cuda.synchronize()
                    ref = cuda_nms.nms(c, t, eps=eps).valid
                    bad = int((got.cpu() != ref).sum())
                    mismatches += bad
                    n_cases += 1
                    log(f"[3] {tag} n={n:3d} K={K:4d} {kind:12} eps={eps:g} t={t}: "
                        f"kept {int(ref.sum())}/{int(cpu.valid.sum())}, mismatches {bad}")
        if kind == "uniform" and K == 98 and n in (SLICE_BATCH, 64):
            args64 = (gpu64.boxes, gpu64.scores, gpu64.class_ids, gpu64.valid)
            f64_ms = graph_ms(lambda: cuda_nms._launch(*args64, IOU_T, 0.0), iters=50)
            log(f"[3] {card}: NMS float64 n={n} K={K} eps=0: kernel {f64_ms:.4f} ms device "
                f"(CUDA graph)")
        if kind == "uniform" and (n, K) in NMS_TIMED:
            args = (gpu.boxes, gpu.scores, gpu.class_ids, gpu.valid)
            call = lambda: cuda_nms.nms(gpu, IOU_T)  # noqa: E731
            dev_ms = nms_kernel_ms(cuda_nms, args)
            floor_ms = empty_launch_ms(n, NMS_THREADS)
            w_ms = cuda_ms(call, iters=200)
            h_us = host_us(call)
            p_ms = cuda_ms(lambda: cuda_nms.nms_reference(*args, IOU_T, 1e-6), iters=5)
            keep = cuda_nms.nms(cpu, IOU_T).valid
            # The selection rule's work: one step per kept box, each an argmax
            # and an IoU against K candidates (~12 float32 operations each).
            ops = int(keep.sum()) * K * 12
            in_bytes = n * K * (16 + 4 + 4 + 1) + n * K
            b_ms, b_by = bound(in_bytes, ops, FP32_FLOPS_S)
            timings[(n, K)] = dict(ms=dev_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                   wrapper_ms=w_ms, host_us=h_us, floor_ms=floor_ms)
            log(f"[3] {card}: NMS n={n} K={K}: kernel {dev_ms:.4f} ms device (CUDA graph), "
                f"an empty launch of the same grid {floor_ms:.4f} ms; wrapper {w_ms:.4f} "
                f"ms/call back to back (CUDA events), host {h_us:.1f} us/call to issue; "
                f"bound {b_ms:.7f} ms by {b_by}; plain twin on the card {p_ms:.3f} ms/call")
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
def nms_share(tag: str, nms_ms: float, batch_ms: float) -> None:
    """The NMS kernel's share at batch 1, from its CUDA-graph device time."""
    log(f"{tag}   NMS at batch 1: {nms_ms:.4f} ms device (phase 3, CUDA graph, K = 98), "
        f"{100 * nms_ms / batch_ms:.2f}% of the batch's {batch_ms:.3f} ms (CUDA events)")


def phase_timing(engine, thr: float, card: str, nms_ms: float) -> None:
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
        if batch == 1:
            nms_share("[6]", nms_ms, ms)
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
            if dtype == torch.float32:
                # The nearest one-call counterparts of the four kernels, torch's
                # SyncBatchNorm primitives, on the same operands (float32 only).
                # What each leaves out: stats gives invstd, not var; elemt and
                # backward_elemt take no ReLU and no residual; backward_reduce
                # no ReLU mask.
                b_mean, b_inv = torch.batch_norm_stats(x, 1e-5)
                sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(g, x, b_mean, b_inv, mul,
                                                                   True, True, True)
                count = torch.full((1,), m, dtype=torch.int32, device=dev)
                nearest = {
                    "stats": lambda: torch.batch_norm_stats(x, 1e-5),
                    "normalize": lambda: torch.batch_norm_elemt(x, mul, add, b_mean, b_inv,
                                                                1e-5),
                    "bwd_reduce": lambda: torch.batch_norm_backward_reduce(
                        g, x, b_mean, b_inv, mul, True, True, True),
                    "bwd_dx": lambda: torch.batch_norm_backward_elemt(
                        g, x, b_mean, b_inv, mul, sdy, sdyx, count),
                }
                for kname, call in nearest.items():
                    timings[(name, tag, f"nearest_{kname}")] = cuda_ms(call, iters=20)
                log(f"[7] {name} (M={m}, C={c}, f32), nearest one-call torch counterparts: "
                    f"batch_norm_stats {timings[(name, tag, 'nearest_stats')]:.4f} ms, "
                    f"batch_norm_elemt {timings[(name, tag, 'nearest_normalize')]:.4f} ms (no "
                    f"ReLU, no residual), batch_norm_backward_reduce "
                    f"{timings[(name, tag, 'nearest_bwd_reduce')]:.4f} ms (no ReLU mask), "
                    f"batch_norm_backward_elemt {timings[(name, tag, 'nearest_bwd_dx')]:.4f} ms "
                    f"(no ReLU mask, no residual gradient); var_mean "
                    f"{timings[(name, tag, 'library_stats')]:.4f} ms (CUDA events)")
                del b_mean, b_inv, sdy, sdyx
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


def _float64_step(model, images, targets) -> float:
    """One float64 train-mode forward and backward, clipped as the Trainer
    clips; returns the gradient norm before clipping."""
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.ops.loss import yolo_loss

    model.train()
    x = device_normalize(images).permute(0, 3, 1, 2).double()
    x = x.contiguous(memory_format=torch.channels_last)
    total, _ = yolo_loss(model(x), targets.double(), S=S, B=B, C=C)
    total.backward()
    return float(torch.nn.utils.clip_grad_norm_(list(model.parameters()), 10.0))


def _float64_grads(model, images, targets) -> dict:
    """Gradients of one float64 train-mode step, clipped as the Trainer clips."""
    _float64_step(model, images, targets)
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
def _write_voc(root: Path, n: int = 4, centered: bool = False) -> None:
    """A synthetic VOCdevkit: 2007 trainval, 2012 train/val, seeded JPEGs,
    one 150x120 dog an image (in the middle with ``centered``)."""
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
            if centered:
                x0, y0 = (500 - 150) // 2, (375 - 120) // 2
            (voc / "Annotations" / f"{img_id}.xml").write_text(
                "<annotation><size><width>500</width><height>375</height></size><object>"
                f"<name>dog</name><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
                f"<xmax>{x0 + 150}</xmax><ymax>{y0 + 120}</ymax></bndbox></object></annotation>")
        for split, part in splits.items():
            (voc / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids[part]))


def phase_train_entry_points() -> None:
    import torch

    from yolo_tpu_torch import train

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


def stem_images(g, shape, dtype: str):
    """Seeded (N, H, W, 3) images on the card: uint8 in [0, 256), or float32 N(0, 1.5)."""
    import torch

    if dtype == "uint8":
        return torch.randint(0, 256, (*shape, 3), generator=g, device="cuda", dtype=torch.uint8)
    return torch.randn((*shape, 3), generator=g, device="cuda") * 1.5


def stem_times(images, s_img) -> dict:
    """The stem front's device ms (CUDA graph), wrapper ms (back to back, CUDA
    events), host us a call, and its byte bound, on ``images``."""
    from yolo_tpu_torch.serving import cuda_stem

    n, h, w, _ = images.shape
    call = lambda: cuda_stem.quant_s2d(images, s_img)  # noqa: E731
    n_bytes = cuda_stem.bytes_moved(n, h, w, images.element_size())
    b_ms, b_by = bound(n_bytes, 0, FP32_FLOPS_S)
    return dict(ms=graph_ms(call, iters=10 if n >= 64 else 20), wrapper_ms=cuda_ms(call, iters=20),
                host_us=host_us(call), bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)


def _stem_equal(got, ref, out: dict, what: str) -> None:
    bad = int((got != ref).sum())
    out["stem_err"] = max(out["stem_err"], float((got.int() - ref.int()).abs().max()))
    if bad:
        raise AssertionError(f"stem kernel differs from its twin in {bad} values ({what})")


def phase_stem_kernel(card: str) -> dict:
    """Phase 11's first part: the stem front (#6) bit for bit against its twin
    at batch 1 to 256, both input types, with its times; then ragged widths
    and a misaligned view (the byte path)."""
    import torch

    from yolo_tpu_torch.serving import cuda_stem

    dev = torch.device("cuda")
    out = {"stem": {}, "stem_err": 0.0}
    g = torch.Generator(device=dev).manual_seed(41)
    s_img = torch.tensor(0.0173, dtype=torch.float32, device=dev)
    for batch in (1, SLICE_BATCH, 64, 256):
        for dtype in ("uint8", "float32"):
            images = stem_images(g, (batch, SIZE, SIZE), dtype)
            got = cuda_stem.quant_s2d(images, s_img)
            ref = cuda_stem.quant_s2d_reference(images, s_img)
            _stem_equal(got, ref, out, f"batch {batch}, {dtype}")
            del got, ref
            t = stem_times(images, s_img)
            t["plain_ms"] = cuda_ms(lambda: cuda_stem.quant_s2d_reference(images, s_img),
                                    iters=3 if batch == 256 else 5, warmup=1)
            out["stem"][(batch, dtype)] = t
            log(f"[11] {card}: stem front, batch {batch}, {dtype}: == twin bit for bit; "
                f"kernel {t['ms']:.4f} ms device (CUDA graph; bound {t['bound_ms']:.4f} ms by "
                f"{t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}%, "
                f"{t['bytes'] / t['ms'] / 1e6:.0f} GB/s), wrapper {t['wrapper_ms']:.4f} ms/call "
                f"back to back, host {t['host_us']:.1f} us/call to issue; twin "
                f"{t['plain_ms']:.4f} ms ({t['bytes'] / 1e6:.1f} MB)")
            del images
    for shape in ((3, 18, 10), (2, 6, 14), (1, 448, 446)):
        for dtype in ("uint8", "float32"):
            images = stem_images(g, (shape[0], shape[1], shape[2] + 2), dtype)
            views = {"": images[:, :, :shape[2]].contiguous(),
                     ", a view 3 pixels into its storage": images.reshape(-1)[9:][
                         :shape[0] * shape[1] * shape[2] * 3].reshape(*shape, 3)}
            for what, x in views.items():
                _stem_equal(cuda_stem.quant_s2d(x, s_img), cuda_stem.quant_s2d_reference(x, s_img),
                            out, f"{shape}, {dtype}{what}")
    log("[11] stem front at (3, 18, 10), (2, 6, 14), (1, 448, 446), uint8 and float32, "
        "contiguous and misaligned: == twin bit for bit")
    torch.cuda.empty_cache()
    return out


def phase_int8_kernels(card: str) -> dict:
    import torch

    from yolo_tpu_torch.serving import cuda_int8

    out = {**phase_stem_kernel(card), "conv": {}, "sums": {}, "conv_err": 0.0}
    # --- kernel #7: every distinct conv geometry and epilogue at batch 2, the
    # int8 output and the int32 accumulator against the float64 twin.
    convs = _distinct(engine_convs(2)) + [
        ("stem (direct 7x7)", (2, SIZE, SIZE, 3), 64, 7, 2, 3, "relu")]
    for ci, conv in enumerate(convs):
        _check_conv(conv, 100 + ci, out)
    log(f"[11] int8 conv: {len(convs)} distinct geometries (every conv of the engine at "
        f"batch 2 and the direct stem), own epilogue and int32 accumulator == twin bit for bit")
    # Split-K and the 4-byte gather at the geometries that take them: fc1 at
    # M = 1, 16, 17; every conv plan() splits at batch 16; the s2d stem at
    # batch 16; and fc1 and head.conv3 forced to more splits than planned.
    split_cases = [(c, None) for b in (1, 17) for c in engine_convs(b) if c[0] == "fc1"]
    split_cases += [(c, None) for c in _distinct(engine_convs(SLICE_BATCH))
                    if c[0] == "stem" or _plan(c)[1] > 1]
    split_cases += [(c, s) for c in engine_convs(SLICE_BATCH) for s in (7, 4)
                    if (c[0], s) in (("fc1", 7), ("head.conv3", 4))]
    for ci, (conv, splits) in enumerate(split_cases):
        tile, planned = _check_conv(conv, 300 + ci, out, splits)
        log(f"[11] int8 conv {conv[0]} batch {conv[1][0]}: tile {cuda_int8.TILES[tile]}, "
            f"{splits or planned} K split(s){' (forced)' if splits else ''}"
            f"{', 4-byte gather' if conv[1][3] % 16 else ''}: == twin bit for bit")

    # Times at the slice's batch and at 256: every distinct geometry's kernel
    # with its bound; at batch 16 also torch._int_mm (the accumulator of a 1x1
    # stride-1 conv) and the twin where named. Sums over all 58 convs.
    for batch in (SLICE_BATCH, 256):
        times = {}
        for ci, conv in enumerate(_distinct(engine_convs(batch))):
            times[_geometry(conv)] = _time_conv(conv, 200 + ci, card, out, batch == SLICE_BATCH)
        all58 = engine_convs(batch)
        k_sum = sum(times[_geometry(c)][0] for c in all58)
        b_sum = sum(times[_geometry(c)][2] for c in all58)
        out["sums"][batch] = (k_sum, b_sum)
        log(f"[11] {card}: int8 conv, all {len(all58)} convs of the engine at batch {batch}: "
            f"kernel {k_sum:.4f} ms, bounds {b_sum:.4f} ms ({100 * b_sum / k_sum:.1f}%)")
    torch.cuda.empty_cache()
    return out


def _geometry(conv) -> tuple:
    return (conv[1][1:], *conv[2:])


def _plan(conv):
    from yolo_tpu_torch.serving import cuda_int8

    _, (n, h, w, cin), cout, k, stride, pad, _ = conv
    ho, wo = cuda_int8.out_size(h, w, k, k, stride, pad)
    return cuda_int8.plan(n * ho * wo, cout, k * k * cin)


def _check_conv(conv, seed: int, out: dict, splits=None):
    """The conv's own epilogue and its int32 accumulator == the float64 twin,
    bit for bit, with plan()'s splits or ``splits``; (tile, planned splits)."""
    import torch

    from yolo_tpu_torch.serving import cuda_int8

    x, wq, m, t, res, rr = _conv_operands(conv, seed)
    ops_ = (x, wq, m, t, res, rr, cuda_int8.pack_weight(wq))
    acc_ref = cuda_int8.conv_acc_reference(x, wq, conv[4], conv[5])
    tile, planned = _plan(conv)
    plan = cuda_int8.plan
    if splits is not None:
        cuda_int8.plan = lambda m_rows, cout, k: (tile, splits)
    try:
        for mode in (conv[6], "acc"):
            got = _conv_call(conv, ops_, mode)()
            extra = dict(res=res, r=rr) if mode == "residual" else {}
            ref = cuda_int8.requant_reference(acc_ref, m, t, mode, **extra)
            if got.dtype == ref.dtype:
                out["conv_err"] = max(out["conv_err"],
                                      float((got.double() - ref.double()).abs().max()))
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                diff = (got.double() - ref.double()).abs()
                raise AssertionError(f"int8 conv {conv[0]} ({mode}, batch {conv[1][0]}, splits "
                                     f"{splits or planned}) differs from its twin in "
                                     f"{int((diff > 0).sum())} values, max {float(diff.max())}")
    finally:
        cuda_int8.plan = plan
    return tile, planned


def _time_conv(conv, seed: int, card: str, out: dict, with_library: bool):
    """(kernel ms, twin ms, bound ms, bound by, torch._int_mm ms, ops) of one
    geometry, logged; the twin and the library call where timed, else None."""
    import torch

    from yolo_tpu_torch.serving import cuda_int8

    x, wq, m, t, res, rr = _conv_operands(conv, seed)
    ops_ = (x, wq, m, t, res, rr, cuda_int8.pack_weight(wq))
    (n, h, w, cin), cout, k, stride, pad, mode = conv[1:]
    w_ms = cuda_ms(_conv_call(conv, ops_), iters=10)  # the wrapper's calls back to back
    k_ms = graph_ms(_conv_call(conv, ops_), iters=10 if n > SLICE_BATCH else 20)
    ops, n_bytes = cuda_int8.work(n, h, w, cin, cout, k, k, stride, pad, mode)
    b_ms, b_by = bound(n_bytes, ops, INT8_OPS_S)
    p_ms = lib_ms = None
    line = ""
    if with_library and conv[0] in ("layer1.1.conv1", "layer4.1.conv1", "layer2.0.conv2"):
        p_ms = cuda_ms(_conv_call(conv, ops_, plain=True), iters=3, warmup=1)
        line = f"; twin {p_ms:.3f} ms"
    if with_library and k == 1 and stride == 1:
        a, b = x.reshape(-1, cin), ops_[6].t()  # (M, K) row-major, (K, N) column-major
        try:
            acc = torch._int_mm(a, b)
        except RuntimeError as e:  # _int_mm takes M > 16 only on some builds
            line += f"; torch._int_mm refused ({str(e).splitlines()[0][:60]})"
        else:
            lib_ms = graph_ms(lambda: torch._int_mm(a, b))
            if not torch.equal(acc, _conv_call(conv, ops_, "acc")().reshape(-1, cout)):
                raise AssertionError(f"torch._int_mm and the kernel's accumulator differ at "
                                     f"{conv[0]}")
            line += f"; torch._int_mm (accumulator only) {lib_ms:.4f} ms"
    tile, splits = _plan(conv)
    if with_library:  # every tile without a split: the numbers behind plan()
        plan, sweep = cuda_int8.plan, []
        try:
            for ti, shape in enumerate(cuda_int8.TILES):
                cuda_int8.plan = lambda m_rows, co, kk, ti=ti: (ti, 1)
                sweep.append(f"{shape[0]}x{shape[1]} {graph_ms(_conv_call(conv, ops_)):.4f}")
        finally:
            cuda_int8.plan = plan
        line += "; unsplit tiles " + ", ".join(sweep)
    if n == SLICE_BATCH:
        out["conv"][conv[0]] = (k_ms, p_ms, b_ms, b_by, lib_ms, ops)
    log(f"[11] {card}: int8 conv {conv[0]} {tuple(conv[1])} -> {cout}, {k}x{k}/s{stride} "
        f"{mode}, batch {n}, tile {cuda_int8.TILES[tile]} x {splits} split(s): {k_ms:.4f} ms "
        f"device ({ops / k_ms / 1e9:.1f} TOPS; bound {b_ms:.4f} ms by {b_by}, "
        f"{100 * b_ms / k_ms:.1f}%), wrapper {w_ms:.4f} ms{line}")
    return k_ms, p_ms, b_ms, b_by, lib_ms, ops


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
def phase_int8_timing(engine, model, thr: float, card: str, nms_ms: float) -> None:
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
        if batch == 1:
            nms_share("[13]", nms_ms, rates["int8"][0])
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


def device_or_wrapper_ms(fn) -> tuple:
    """(ms, "device") from a CUDA graph of ``fn``, or (ms, "wrapper") between
    CUDA events where a graph cannot capture it."""
    import torch

    try:
        return graph_ms(fn, iters=10), "device"
    except RuntimeError as err:
        torch.cuda.synchronize()
        log(f"    (no CUDA graph: {str(err).splitlines()[0][:120]}; CUDA events instead)")
        return cuda_ms(fn, iters=10), "wrapper"


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
        pl = cb.plan(1, h, h, cin, c, p, ds=ds)
        cb.chain_int8(rand_i8((1, h, h, cin)), qbs)
        torch.cuda.synchronize()
        log(f"[14] {stage} batch 1: the chain kernel keeps {cb.LAST_GRID} thread blocks "
            f"resident for {pl.tiles} tiles of {pl.th}x{pl.tw} ({pl.stages} ring stages, "
            f"{pl.smem} bytes of shared memory) on the card's SMs")
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
            pl = cb.plan(batch, h, h, cin, c, p, ds=ds)
            log(f"[14] {stage} batch {batch}: chain of {nb} blocks ({cin}->{c}, P {p}, "
                f"{h}x{h}; {pl.th}x{pl.tw} tiles, {grid} resident thread blocks) and its "
                f"identity block == twins bit for bit")
            del got, ref
        # Times at the slice's batch: kernel (device time from a CUDA graph, and
        # the wrapper's between CUDA events), twin (float64 conv) and the
        # per-conv path (3 or 4 int8 conv kernel launches per block) on the same
        # inputs; then every tile plan() weighs, forced (the numbers behind it).
        for name, blocks, xin, cin_ in (("chain", qbs, x, cin), ("block", [ident], xi, c)):
            launch = cb.chain_int8 if name == "chain" else (
                lambda xq, bl, tile=None: cb.block_int8(xq, bl[0], tile=tile))
            k_ms = graph_ms(lambda: launch(xin, blocks))
            k_wrap = cuda_ms(lambda: launch(xin, blocks), iters=10)
            conv_ms = graph_ms(lambda: _per_conv(xin, blocks))
            conv_wrap = cuda_ms(lambda: _per_conv(xin, blocks), iters=10)
            p_ms = cuda_ms(lambda: cb.chain_int8_reference(xin, blocks), iters=2, warmup=1)
            ops, n_bytes = cb.work(SLICE_BATCH, h, h, cin_, c, p, len(blocks),
                                   blocks[0]["downsample"] is not None)
            b_ms, b_by = bound(n_bytes, ops, INT8_OPS_S)
            out[name][stage] = (k_ms, p_ms, b_ms, b_by, conv_ms, ops, k_wrap, conv_wrap)
            log(f"[14] {card}: {name} kernel, {stage}, {len(blocks)} block(s), batch "
                f"{SLICE_BATCH}: {k_ms:.4f} ms device, {k_wrap:.4f} ms wrapper "
                f"({ops / k_ms / 1e9:.1f} TOPS; bound {b_ms:.4f} ms by {b_by}, "
                f"{100 * b_ms / k_ms:.1f}%); per-conv path {conv_ms:.4f} ms device, "
                f"{conv_wrap:.4f} ms wrapper (fused / per-conv {k_ms / conv_ms:.3f} device); "
                f"twin {p_ms:.2f} ms; library: none (no PyTorch call computes a fused int8 "
                f"bottleneck)")
            tiles = {}
            for tile in cb.TILES:
                try:
                    cb.layout(SLICE_BATCH, h, h, cin_, c, p, 1, *tile)
                except ValueError:
                    continue
                tiles[tile] = graph_ms(lambda: launch(xin, blocks, tile=tile))
            chosen = cb.plan(SLICE_BATCH, h, h, cin_, c, p, ds=name == "chain" and ds)
            log(f"[14]   {name} {stage} batch {SLICE_BATCH}, each tile forced, device ms: "
                + ", ".join(f"{t[0]}x{t[1]} {v:.4f}" for t, v in tiles.items())
                + f"; plan() picks {chosen.th}x{chosen.tw}, fastest "
                + "{0}x{1}".format(*min(tiles, key=tiles.get)))
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


def _wino_part_bounds(n: int, h: int, c: int, k: int):
    """(tap pass, tap GEMM) bounds in ms, each as a function of its own: the
    pass reads x and writes the (16, Mt, C) taps; the GEMM reads the taps,
    U, mw and the bias, runs the 16 tap dots and writes y."""
    from yolo_tpu_torch.serving import cuda_wino

    dots, taps, n_bytes = cuda_wino.work(n, h, h, c, k)
    scratch = int(np.prod(cuda_wino.scratch_shape(n, h, h, c)))
    x_bytes, y_bytes = n * h * h * c, n * h * h * k
    pass_ms = max(bound(x_bytes + scratch, 0, INT8_OPS_S)[0], taps / FP32_FLOPS_S * 1e3)
    gemm_ms = bound(n_bytes - x_bytes + scratch, dots, INT8_OPS_S)[0]
    return pass_ms, gemm_ms


def wino_device_ms(x, qc: dict, leaky: bool, events_if_uncapturable: bool = False) -> dict:
    """Device ms (CUDA graphs) of one Winograd conv through the package that
    cuda_wino was imported from: "total", and where that package splits the
    conv into a tap pass and a tap GEMM (this one), "taps" and "gemm". A
    wrapper that a CUDA graph cannot capture raises, unless
    ``events_if_uncapturable``: then "wrapper" holds the call's time between
    CUDA events, host time included, in place of "total"."""
    from yolo_tpu_torch.serving import cuda_wino

    call = lambda: cuda_wino.conv3x3_wino(x, qc, leaky)  # noqa: E731
    try:
        out = {"total": graph_ms(call, iters=10 if x.shape[0] > SLICE_BATCH else 20)}
    except RuntimeError as e:
        if not events_if_uncapturable:
            raise
        log(f"CUDA graph capture failed ({str(e).splitlines()[0][:80]}); wrapper time from "
            f"CUDA events instead, host time included")
        out = {"wrapper": cuda_ms(call, iters=10)}
    if hasattr(cuda_wino, "tap_pass"):
        qw = qc["wino"]
        n, h, w, _ = x.shape
        vq = cuda_wino.tap_pass(x, qw["dinv"])
        out["taps"] = graph_ms(lambda: cuda_wino.tap_pass(x, qw["dinv"]))
        out["gemm"] = graph_ms(lambda: cuda_wino.tap_gemm(vq, qw, qw["uk"], (n, h, w), leaky))
        del vq
    return out


def _wino_gemm_tile_ms(x, qw: dict, leaky: bool) -> list:
    """Device ms of the tap GEMM with each of cuda_wino.TILES forced."""
    from yolo_tpu_torch.serving import cuda_wino

    n, h, w, _ = x.shape
    vq, plan, out = cuda_wino.tap_pass(x, qw["dinv"]), cuda_wino.plan, []
    try:
        for tile in range(len(cuda_wino.TILES)):
            cuda_wino.plan = lambda *a, tile=tile: tile
            out.append(graph_ms(lambda: cuda_wino.tap_gemm(vq, qw, qw["uk"], (n, h, w), leaky)))
    finally:
        cuda_wino.plan = plan
    return out


def _direct_conv_ms(x, k: int, leaky: bool, g) -> float:
    """Device ms of the direct int8 conv kernel on the same 3x3 conv."""
    import torch

    from yolo_tpu_torch.serving import cuda_int8

    c = x.shape[3]
    wq = torch.randint(-127, 128, (3, 3, c, k), generator=g, device="cuda", dtype=torch.int8)
    wk = cuda_int8.pack_weight(wq)
    m = (torch.rand(k, generator=g, device="cuda") + 0.5) / float(40 * np.sqrt(9 * c))
    t = torch.rand(k, generator=g, device="cuda") * 6 - 3
    mode = "leaky" if leaky else "relu"
    return graph_ms(lambda: cuda_int8.conv_int8(x, wq, m, t, 1, 1, mode, wk=wk),
                    iters=10 if x.shape[0] > SLICE_BATCH else 20)


def phase_wino_kernels(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import wino_ablate
    from yolo_tpu_torch.serving import cuda_wino

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
        # Times at the slice's batch and at 256: the tap pass, the tap GEMM and
        # the conv (device, CUDA graphs), the wrapper's time, the direct int8
        # conv kernel on the same conv; at batch 16 also the twin and 16
        # torch._int_mm at the tap-dot shape (the accumulators only).
        for batch in (SLICE_BATCH, 256):
            if batch != SLICE_BATCH:
                x = rand_i8((batch, h, h, c))
            dev = wino_device_ms(x, qc, leaky)
            k_ms = dev["total"]
            w_ms = cuda_ms(lambda: cuda_wino.conv3x3_wino(x, qc, leaky), iters=10)
            d_ms = _direct_conv_ms(x, k, leaky, g)
            b_ms, b_by = _wino_bound(batch, h, c, k)
            tb_ms, gb_ms = _wino_part_bounds(batch, h, c, k)
            dots, _, _ = cuda_wino.work(batch, h, h, c, k)
            tile = cuda_wino.plan(batch, h, h, c, k)
            line = ""
            p_ms = lib_ms = None
            if batch == SLICE_BATCH:
                line = ", tap GEMM by tile " + ", ".join(  # the numbers behind plan()
                    f"{bm}x{bn} {ms:.4f}" for (bm, bn), ms in zip(
                        cuda_wino.TILES, _wino_gemm_tile_ms(x, qc["wino"], leaky)))
                p_ms = cuda_ms(lambda: cuda_wino.conv3x3_wino_reference(x, qc, leaky), iters=2,
                               warmup=1)
                th, tw = cuda_wino.tiles(h, h)
                a = rand_i8((batch * th * tw, c))
                b = qc["wino"]["uk"][0].t()  # (C, K), column-major
                lib_ms = graph_ms(lambda: [torch._int_mm(a, b) for _ in range(16)], iters=2)
                line += (f"; twin {p_ms:.3f} ms, 16 x torch._int_mm ({a.shape[0]}, {c}) x "
                         f"({c}, {k}) {lib_ms:.4f} ms (accumulators only)")
                out["conv"][name] = (k_ms, p_ms, b_ms, b_by, lib_ms, d_ms, dev, w_ms)
                del a
            out.setdefault("batch", {})[(name, batch)] = (dev, w_ms, b_ms, d_ms)
            log(f"[17] {card}: wino {name} {h}x{h}, {c}->{k}, {'leaky' if leaky else 'relu'}, "
                f"batch {batch}, tile {cuda_wino.TILES[tile]}: "
                f"tap pass {dev['taps']:.4f} ms (bound {tb_ms:.4f}, {100 * tb_ms / dev['taps']:.1f}%)"
                f" + tap GEMM {dev['gemm']:.4f} ms (bound {gb_ms:.4f}, "
                f"{100 * gb_ms / dev['gemm']:.1f}%; {dots / dev['gemm'] / 1e9:.1f} int8 TOPS), "
                f"conv {k_ms:.4f} ms device (bound {b_ms:.4f} ms by {b_by}, "
                f"{100 * b_ms / k_ms:.1f}%), wrapper {w_ms:.4f} ms; direct int8 conv "
                f"{d_ms:.4f} ms (wino / direct {k_ms / d_ms:.3f}){line}")
        log(f"[17] wino {name}: == twin bit for bit at batch 2 and {SLICE_BATCH}")
        del x, got, ref, qc
        torch.cuda.empty_cache()

    # Every tile plan() can pick, forced, at a ragged Mt.
    plan = cuda_wino.plan
    qc = {"wino": _rand_qwino(g, 128, 192)}
    x = rand_i8((3, 13, 11, 128))
    ref = cuda_wino.conv3x3_wino_reference(x, qc, False)
    try:
        for tile in range(len(cuda_wino.TILES)):
            cuda_wino.plan = lambda *a, tile=tile: tile
            if not torch.equal(cuda_wino.conv3x3_wino(x, qc, False), ref):
                raise AssertionError(f"wino kernel with tile {tile} differs from its twin")
    finally:
        cuda_wino.plan = plan
    log(f"[17] wino kernel at (3, 13, 11) 128->192 (Mt = 126): every tile "
        f"{cuda_wino.TILES} == twin bit for bit")

    # The ablation modes at head-conv1 geometry, against their twins.
    _, h, c, k, _ = WINO_CONVS[4]
    qw = _rand_qwino(g, c, k)
    x = rand_i8((SLICE_BATCH, h, h, c))
    zeros = cuda_wino.zero_taps(x)  # the dots modes' taps, zero-filled outside the timing
    for mode in cuda_wino.MODES:
        got = cuda_wino.wino_ablate(x, qw, mode, zeros)
        ref = cuda_wino.wino_ablate_reference(x, qw, mode)
        out["mode_err"] = max(out["mode_err"], float((got.int() - ref.int()).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"wino mode {mode} differs from its twin in "
                                 f"{int((got != ref).sum())} values")
        k_ms = cuda_ms(lambda: cuda_wino.wino_ablate(x, qw, mode, zeros), iters=10)
        p_ms = cuda_ms(lambda: cuda_wino.wino_ablate_reference(x, qw, mode), iters=2, warmup=1)
        b_ms, b_by = _wino_bound(SLICE_BATCH, h, c, k, mode)
        out["modes"][mode] = (k_ms, p_ms, b_ms, b_by)
        log(f"[17] {card}: wino mode {mode}, head.conv1 geometry, batch {SLICE_BATCH}: == twin "
            f"bit for bit; kernel {k_ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}), twin "
            f"{p_ms:.3f} ms")
    del x, qw, zeros

    # The ablation's own entry point at its defaults (batch 256, 14x14,
    # 1024 -> 1024): the path of the ablation modes, counted.
    cuda_wino.LAUNCHES.update(dict.fromkeys(cuda_wino.MODES, 0))
    out["ablation"] = wino_ablate.run()
    out["ablation_launches"] = dict(cuda_wino.LAUNCHES)
    if min(out["ablation_launches"].values()) < 1:
        raise AssertionError(f"wino_ablate launched {out['ablation_launches']}")
    ab = out["ablation"]
    log(f"[17] python -m yolo_tpu_torch.experiments.wino_ablate (batch 256): launches "
        f"{out['ablation_launches']}; full {ab['full']:.4f} ms = tap pass {ab['full'] - ab['dots']:.4f}"
        f" + dots {ab['dots']:.4f} ms; taps alone {ab['taps']:.4f} ms; dots-raw "
        f"{ab['dots-raw']:.4f} ms (the dequant and inverse: {ab['dots'] - ab['dots-raw']:.4f} ms)")
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
                         (("wino tap pass", "wino_taps_kernel"), ("wino tap GEMM", "wino_gemm_kernel"),
                          ("int8 conv", "int8_conv_kernel"))}
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
def _dot_operands(g, M: int, K: int, N: int):
    import torch

    a = torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    m = (torch.rand(N, generator=g, device="cuda") + 0.5) * (2e-2 / K**0.5)
    return a, w, m


def dot_device_ms(g, M: int) -> dict:
    """{case: (kernel ms, torch._int_mm ms)}, device times (CUDA graphs), of
    the int8 dot of the package that mosaic_int8_dot was imported from, in
    the harness's five cases at M rows."""
    import torch
    import torch.nn.functional as F

    from yolo_tpu_torch.experiments import mosaic_int8_dot as md

    out = {}
    for name, K, N in md.CASES:
        a, w, m = _dot_operands(g, M, K, N)
        wk = md.pack_weight(w)
        k_ms = graph_ms(lambda: md.int8_dot(a, w, m, wk), iters=5)
        kp = -(-K // 8) * 8  # _int_mm takes K % 8 == 0: K = 300 zero-padded to 304
        a_mm = F.pad(a, (0, kp - K)) if kp != K else a
        w_mm = F.pad(w, (0, 0, 0, kp - K)).t().contiguous().t()
        out[name] = (k_ms, graph_ms(lambda: torch._int_mm(a_mm, w_mm), iters=5))
        del a, w, m, wk, a_mm, w_mm
    torch.cuda.empty_cache()
    return out


def phase_int8_dot(card: str) -> dict:
    import torch

    from yolo_tpu_torch.experiments import mosaic_int8_dot as md
    from yolo_tpu_torch.serving import cuda_int8

    out = {"err": 0.0}
    g = torch.Generator(device="cuda").manual_seed(72)
    for M in (4096, 2**20 + 17):
        for name, K, N in md.CASES:
            a, w, m = _dot_operands(g, M, K, N)
            got, ref = md.int8_dot(a, w, m), md.int8_dot_reference(a, w, m)
            out["err"] = max(out["err"], float((got.int() - ref.int()).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 dot {name} at M = {M} differs from its twin in "
                                     f"{int((got != ref).sum())} values")
            del a, w, m, got, ref
    log(f"[21] {card}: int8 dot (the int8 conv kernel on an (M, 1, 1, K) view) == twin bit "
        f"for bit in all {len(md.CASES)} cases at M = 4096 and {2**20 + 17}")
    res, out["launches"] = _harness(md, 21)
    # Device times of the five cases beside their bounds, with the tile
    # plan() picks and every tile forced (the numbers behind the plan).
    dev = dot_device_ms(g, md.M_DEFAULT)
    plan = cuda_int8.plan
    for name, K, N in md.CASES:
        ops, n_bytes = md.work(md.M_DEFAULT, K, N)
        b_ms, b_by = bound(n_bytes, ops, INT8_OPS_S)
        k_ms, lib_ms = dev[name]
        tile, _ = plan(md.M_DEFAULT, N, K)
        a, w, m = _dot_operands(g, md.M_DEFAULT, K, N)
        wk = md.pack_weight(w)
        sweep = []
        try:
            for ti, shape in enumerate(cuda_int8.TILES):
                cuda_int8.plan = lambda m_rows, co, kk, ti=ti: (ti, 1)
                sweep.append(f"{shape[0]}x{shape[1]} {graph_ms(lambda: md.int8_dot(a, w, m, wk), iters=5):.4f}")
        finally:
            cuda_int8.plan = plan
        del a, w, m, wk
        out.setdefault("cases", {})[name] = (k_ms, lib_ms, b_ms, b_by)
        log(f"[21] {card}: int8 dot {name} (M = {md.M_DEFAULT}, K = {K}, N = {N}), tile "
            f"{cuda_int8.TILES[tile]}: {k_ms:.4f} ms device ({ops / k_ms / 1e9:.1f} TOPS; bound "
            f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / k_ms:.1f}%), harness {res[name][0]:.4f} ms; "
            f"torch._int_mm {lib_ms:.4f} ms device, harness {res[name][1]:.4f} ms (accumulator "
            f"only; kernel / _int_mm {k_ms / lib_ms:.3f}); tiles " + ", ".join(sweep))
    torch.cuda.empty_cache()
    out["ms"], out["library_ms"] = dev["l2-im2col"]
    a, w, m = _dot_operands(g, md.M_DEFAULT, 1152, 128)
    out["plain_ms"] = cuda_ms(lambda: md.int8_dot_reference(a, w, m), iters=2, warmup=1)
    out["bound"] = out["cases"]["l2-im2col"][2:]
    log(f"[21] {card}: l2-im2col twin {out['plain_ms']:.3f} ms; {out['launches']} launches in "
        f"the harness's run")
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
    for name, h, c, k, batches in [(*geo, (2, 128)) for geo in cb.GEOMETRIES] + [
            ("13x13", 13, 256, 256, (1, 2))]:
        for n in batches:
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
    # Device time (CUDA graph) at the harness's layer1 geometry, on plan()'s
    # tile and on each tile it weighs, forced.
    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    args = fb.random_block(fb.N, fb.H, fb.W, fb.CIN, fb.P, "cuda", seed=9)
    packed = fb.pack_weights(args[1], args[3], args[5])
    out["device_ms"] = graph_ms(lambda: fb.fused_bottleneck(*args, packed=packed))
    tiles = {t: graph_ms(lambda: fb.fused_bottleneck(*args, packed=packed, tile=t))
             for t in cb.TILES}
    pl = cb.plan(fb.N, fb.H, fb.W, fb.CIN, fb.CIN, fb.P, e=2)
    log(f"[23] {card}: layer1 b{fb.N}: kernel {out['device_ms']:.4f} ms device ({pl.th}x{pl.tw} "
        f"tiles, {pl.stages} ring stages); each tile forced: "
        + ", ".join(f"{t[0]}x{t[1]} {v:.4f}" for t, v in tiles.items()) + " ms device")
    del args, packed
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


# ---------------------------------------------------------------- phase 24
EVAL_IMAGES, EVAL_BATCH = 10, 4  # batches of 4, 4 and a ragged 2
BOX_W, BOX_H = 150 / 500, 120 / 375  # _write_voc's dog


def eval_grids(seed: int, n: int):
    """Seeded (pred, target) grids for the evaluator's parity checks
    (tests/test_torch_metrics.py holds the CPU paths against JAX on them):
    O(1) boxes and peaked classes; ~30% of cells hold a GT of one of 6
    classes, and ~70% of those a prediction of its class near its box."""
    D = B * 5 + C
    r = np.random.default_rng(seed)
    pred = r.uniform(0, 1, (n, S, S, D)).astype(np.float32)
    pred[..., [2, 3, 7, 8]] *= 0.6
    pred[..., 10:] = (r.uniform(0, 1, (n, S, S, C)) ** 6).astype(np.float32)
    target = np.zeros((n, S, S, D), np.float32)
    cells = r.uniform(size=(n, S, S)) < 0.3
    target[..., 0:2] = r.uniform(0, 1, (n, S, S, 2))
    target[..., 2:4] = r.uniform(0.02, 0.6, (n, S, S, 2))
    target[..., 4] = 1.0
    target[..., 10:] = np.eye(C, dtype=np.float32)[r.integers(0, 6, (n, S, S))]
    target[~cells] = 0.0
    near = cells & (r.uniform(size=(n, S, S)) < 0.7)
    pred[near, 0:4] = target[near, 0:4] + r.normal(0, 0.05, (int(near.sum()), 4))
    pred[near, 10:] = target[near, 10:] * np.float32(0.9)
    return pred, target


def exact_iou_grids():
    """Exact IoUs: GT [0.5, 0.5, 0.5, 0.5] in cell (3, 3) (centre 3.5 / 7 =
    0.5 exactly); same-centre predictions of widths 0.25 / 0.375 / 0.5 hit
    IoU 0.5 / 0.75 / 1 exactly; a duplicate; two tied scores; a small GT."""
    D = B * 5 + C
    pred = np.zeros((2, S, S, D), np.float32)
    target = np.zeros((2, S, S, D), np.float32)
    target[:, 3, 3, 0:5] = [0.5, 0.5, 0.5, 0.5, 1.0]
    target[:, 3, 3, 10 + 1] = 1.0
    pred[0, 3, 3, 0:10] = [0.5, 0.5, 0.25, 0.5, 0.9, 0.5, 0.5, 0.375, 0.5, 0.8]
    pred[1, 3, 3, 0:10] = [0.5, 0.5, 0.5, 0.5, 0.7, 0.5, 0.5, 0.25, 0.5, 0.7]
    pred[:, 3, 3, 10 + 1] = 1.0
    target[1, 1, 1, 0:5] = [0.25, 0.75, 0.125, 0.25, 1.0]
    target[1, 1, 1, 10 + 1] = 1.0
    pred[1, 1, 1, 0:5] = [0.25, 0.75, 0.125, 0.25, 0.6]
    pred[1, 1, 1, 10 + 1] = 1.0
    return pred, target


def eval_batches() -> list:
    """The parity batches: two seeded, the exact-IoU one, and a ragged batch
    of 5 zero-padded to 8 with its sample mask."""
    pred, target = eval_grids(0, 5)
    pad = np.zeros((3, *pred.shape[1:]), np.float32)
    padded = (np.concatenate([pred, pad]), np.concatenate([target, pad]), np.arange(8) < 5)
    return [eval_grids(1, 8), exact_iou_grids(), eval_grids(2, 8), padded]


def _metric(batches, precise: bool, nms: float, move):
    from yolo_tpu_torch.metrics import mAPMetric

    metric = mAPMetric(num_classes=C, precise=precise, nms_threshold=nms)
    for pred, target, *mask in batches:
        metric.update(move(pred), move(target), *mask)
    return metric.compute(), metric


def _chunks_differ(a, b) -> int:
    """Elements on which two metrics' per-batch arrays differ."""
    return sum(int((x[k] != y[k]).sum()) for x, y in zip(a._chunks, b._chunks) for k in x)


def phase_eval_parity() -> int:
    """Each path on the card against the same path on the CPU, key for key
    and array for array, with one NMS launch a batch; the two paths'
    differences printed. Returns the NMS launches of one fast pass over the
    batches."""
    import torch

    from yolo_tpu_torch.ops import cuda_nms

    batches = eval_batches()
    for nms in (IOU_T, 1.1):
        cuda_nms.LAUNCHES = 0
        fast, fast_m = _metric(batches, False, nms, lambda a: torch.from_numpy(a).cuda())
        torch.cuda.synchronize()
        launches = cuda_nms.LAUNCHES
        cpu, cpu_m = _metric(batches, False, nms, torch.from_numpy)
        bad = [k for k in cpu if fast.get(k) != cpu[k]]
        n_diff = _chunks_differ(fast_m, cpu_m)
        if len(fast) != 77 or bad or n_diff or fast.keys() != cpu.keys():
            raise AssertionError(f"fast path, card vs CPU at NMS {nms}: keys {bad}, "
                                 f"{n_diff} array elements differ")
        if launches != len(batches):
            raise AssertionError(f"fast path: {launches} NMS launches for {len(batches)} batches")
        cuda_nms.LAUNCHES = 0
        precise, precise_m = _metric(batches, True, nms, lambda a: torch.from_numpy(a).cuda())
        torch.cuda.synchronize()
        launches64 = cuda_nms.LAUNCHES
        cpu64, cpu64_m = _metric(batches, True, nms, torch.from_numpy)
        bad = [k for k in cpu64 if precise.get(k) != cpu64[k]]
        n_diff = _chunks_differ(precise_m, cpu64_m)
        if len(precise) != 77 or bad or n_diff or precise.keys() != cpu64.keys():
            raise AssertionError(f"precise path, card vs CPU at NMS {nms}: keys {bad}, "
                                 f"{n_diff} array elements differ")
        if launches64 != len(batches):
            raise AssertionError(f"precise path: {launches64} NMS launches for {len(batches)} "
                                 f"batches")
        differ = [k for k in precise if precise[k] != fast[k]]
        log(f"[24] mAPMetric on {len(batches)} batches (seeded, exact IoU 0.5/0.75/1, ragged "
            f"5 of 8 masked), NMS {nms}: on the card == on the CPU, all 77 keys and every "
            f"per-batch array, for the fast path (float32) and the precise path (float64); "
            f"NMS kernel launches {launches} and {launches64} (one a batch); the two paths "
            f"differ on {len(differ)} of 77 keys {differ[:6]}")
        for key in ("mAP50:95", "mAP50", "mAP75", "precision", "recall"):
            log(f"[24]   {key:9s} fast {fast[key]!r:24} precise {precise[key]!r}")
    return launches


def _eval_model():
    """The seeded full-width model with fc2's weights scaled 5x and its bias
    a dog box of _write_voc's size at confidence 0.5 in every cell: the
    forward moves each box by a few hundredths, so on a tree of centred
    dogs the middle cell's box is a TP and the others FPs."""
    import torch

    from yolo_tpu_torch.data import VOC_CLASSES

    model = _int8_model()
    fc2 = model.head.fc_layers[4]
    with torch.no_grad():
        fc2.weight.mul_(5.0)
        grid = fc2.bias.view(S, S, B * 5 + C)
        grid.zero_()
        grid[..., 0:10] = torch.tensor([0.5, 0.5, BOX_W, BOX_H, 0.5] * 2)
        grid[..., B * 5 + VOC_CLASSES.index("dog")] = 1.0
    return model


def _detecting_checkpoint(path: Path, image_size: int) -> None:
    """A full-depth model whose grid is its fc2 bias (fc2 weights zero): a
    dog box of _write_voc's size in the middle cell, nothing elsewhere;
    saved with an Adam at learning rate 0, so training leaves it as it is."""
    import torch

    from yolo_tpu_torch.data import VOC_CLASSES
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.training.checkpoints import save_checkpoint
    from yolo_tpu_torch.training.optim import make_optimizer

    dev = torch.device("cuda")
    model = create_model("resnet", C, S, B, device=dev, image_size=image_size,
                         generator=torch.Generator(device=dev).manual_seed(0))
    bias = torch.zeros(S, S, B * 5 + C, device=dev)
    bias[3, 3, 0:10] = torch.tensor([0.5, 0.5, BOX_W, BOX_H, 1.0] * 2)
    bias[3, 3, B * 5 + VOC_CLASSES.index("dog")] = 1.0
    fc2 = model.head.fc_layers[4]
    with torch.no_grad():
        fc2.weight.zero_()
        fc2.bias.copy_(bias.reshape(-1))
    optimizer, schedule = make_optimizer(model, lr=0.0)
    save_checkpoint(path, 0, model, optimizer, schedule, {"total": 0.0}, {"total": 1e9})


def phase_eval_slice() -> dict:
    """The evaluate CLI at full width (fp32 both paths, --int8 --calib-data,
    --engine), each against an in-process evaluate_model, then train
    --compute-map. Returns the launches (stem, conv, NMS) of each CLI run."""
    import torch

    from yolo_tpu_torch import evaluate, train
    from yolo_tpu_torch.data import DataLoader, create_voc_datasets
    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.metrics import evaluate_model
    from yolo_tpu_torch.serving.engine import int8_forward, load_artifact

    dev = torch.device("cuda")
    model = _eval_model().to(memory_format=torch.channels_last)  # as the CLI's
    n_batches = -(-EVAL_IMAGES // EVAL_BATCH)
    launches = {}
    # One set of cuDNN algorithms for the CLI's model and the in-process one.
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
            tmp = Path(tmp)
            _write_voc(tmp / "voc", n=EVAL_IMAGES, centered=True)
            ckpt = tmp / "ck" / "yolo_random.pth"
            ckpt.parent.mkdir()
            torch.save(model.state_dict(), ckpt)

            def loader(spec):
                year, split = spec.split(":")
                ds = create_voc_datasets([(year, split)], root=tmp / "voc", augment=False,
                                         normalize_host=False)
                return DataLoader(ds, batch_size=EVAL_BATCH, shuffle=False, num_workers=0,
                                  drop_last=False)

            calib = [device_normalize(torch.from_numpy(im).to(dev))
                     for im, _ in list(loader("2012:train"))[:2]]
            artifact = tmp / "engine.npz"
            YOLOInference(model, dev, image_size=SIZE, optimize="int8",
                          calibration=calib).save_engine(artifact, force=True)
            q, impl, _ = load_artifact(artifact, model, dev)

            base = ["--checkpoint", str(ckpt), "--data-root", str(tmp / "voc"), "--year",
                    "2007", "--image-set", "trainval", "--batch-size", str(EVAL_BATCH),
                    "--num-workers", "2", "--device", "cuda"]
            runs = (("fp32 precise", [], (0, 0, n_batches)),
                    ("fp32 fast", ["--fast-eval"], (0, 0, n_batches)),
                    ("int8", ["--int8", "--calib-data", "2012:train", "--fast-eval"],
                     (n_batches, 58 * n_batches, n_batches)),
                    ("engine", ["--engine", str(artifact), "--fast-eval"],
                     (n_batches, 58 * n_batches, n_batches)))
            results = {}
            for tag, flags, want in runs:
                report = ckpt.parent / "evaluation_results.txt"
                report.unlink(missing_ok=True)
                _zero_counts()
                t0 = time.perf_counter()
                results[tag] = evaluate.main([*base, *flags])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches[tag] = _counts()
                if launches[tag] != want:
                    raise AssertionError(f"evaluate {tag}: launches stem/conv/NMS "
                                         f"{launches[tag]}, want {want}")
                if len(results[tag]) != 77 or "Overall metrics" not in report.read_text():
                    raise AssertionError(f"evaluate {tag}: {len(results[tag])} keys, report "
                                         f"{report.is_file()}")
                r = results[tag]
                log(f"[24] python -m yolo_tpu_torch.evaluate {' '.join(flags)}: "
                    f"{EVAL_IMAGES} images in batches of {EVAL_BATCH} at {SIZE}x{SIZE}, "
                    f"{secs:.1f} s (build and data included); launches stem/conv/NMS "
                    f"{launches[tag]}; mAP50 {r['mAP50']!r}, mAP50:95 {r['mAP50:95']!r}, "
                    f"precision {r['precision']!r}, recall {r['recall']!r}; 77 keys, report "
                    f"written")
            in_process = {
                "fp32 precise": evaluate_model(model, loader("2007:trainval"), verbose=False),
                "fp32 fast": evaluate_model(model, loader("2007:trainval"), verbose=False,
                                            precise=False),
                "engine": evaluate_model(
                    model, loader("2007:trainval"), verbose=False, precise=False,
                    forward_fn=lambda x: int8_forward(q, x, S=S, impl=impl)),
            }
            for tag, ref in in_process.items():
                bad = [k for k in ref if results[tag][k] != ref[k]]
                if bad:
                    raise AssertionError(f"evaluate {tag} vs evaluate_model: keys {bad}")
            if results["engine"] != results["int8"]:
                raise AssertionError("evaluate --engine differs from --int8 on its calibration")
            if not all(r["recall"] > 0 for r in results.values()):
                raise AssertionError("the evaluated model found none of the tree's dogs")
            log("[24] the CLI's keys == in-process evaluate_model's (fp32 both paths, "
                "--engine); --engine == --int8 (same calibration batches)")

            _write_voc(tmp / "voc64", n=4, centered=True)
            start = tmp / "start.pth"
            _detecting_checkpoint(start, 64)
            ck64 = tmp / "ck64"
            _zero_counts()
            out = train.main(["--data-root", str(tmp / "voc64"), "--device", "cuda",
                              "--batch-size", "2", "--image-size", "64", "--num-workers", "2",
                              "--worker-type", "thread", "--checkpoint-dir", str(ck64),
                              "--log-dir", str(tmp / "runs"), "--epochs", "1", "--resume",
                              str(start), "--compute-map", "--map-frequency", "1"])
            written = sorted(p.name for p in ck64.iterdir())
            if "yolo_best_map.pth" not in written or not out.get("best_mAP50:95", 0) > 0:
                raise AssertionError(f"train --compute-map wrote {written}, returned {out}")
            log(f"[24] python -m yolo_tpu_torch.train --compute-map --map-frequency 1 "
                f"--image-size 64 (resumed from a model that detects the tree's centred "
                f"dogs): wrote {written}, best mAP50:95 {out['best_mAP50:95']!r}")
    finally:
        torch.backends.cudnn.deterministic = prev
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 26
def _chained(name: str) -> bool:
    """Whether quant_accuracy --chain's engine runs conv ``name`` (an
    engine_convs name) inside a chain: all of layer1, and the stride-1
    blocks of layers 2-3."""
    return name.startswith("layer1.") or (name.startswith(("layer2.", "layer3."))
                                          and ".0." not in name)


def phase_accuracy_gate() -> tuple:
    """python -m yolo_tpu_torch.quant_accuracy --chain at its defaults: the
    trained model, the default int8 engine and the chained engine must PASS,
    with the launches of two engine runs and three metric passes exactly."""
    from yolo_tpu_torch import quant_accuracy

    convs = [c[0] for c in engine_convs(1)]
    per_conv = sum(not _chained(name) for name in convs)
    # stem / int8 conv / chain / block / NMS: the default engine and the
    # chained one, one forward each; one NMS launch a metric pass (3).
    want = (2, len(convs) + per_conv, 3, 0, 3)
    _zero_chain_counts()
    rc = quant_accuracy.main(["--chain"])
    counts = _chain_counts()
    if rc != 0:
        raise AssertionError("quant_accuracy --chain: FAIL")
    if counts != want:
        raise AssertionError(f"quant_accuracy launches stem/conv/chain/block/NMS {counts}, "
                             f"want {want}")
    log(f"[26] python -m yolo_tpu_torch.quant_accuracy --chain: PASS; launches stem "
        f"{counts[0]}, int8 conv {counts[1]}, chain {counts[2]}, block {counts[3]}, NMS "
        f"{counts[4]} (== {want})")
    return counts


# ---------------------------------------------------------------- phase 27
GRAPH_BATCHES = (1, SLICE_BATCH, 64)
SERVE_BUCKETS = (1, 4, 16)
SERVE_CLIENTS = (1, 4, 16, 64)
SERVE_REQUESTS = 256  # at each client count
SERVE_IMAGES = 32  # distinct seeded 448x448 PNGs the requests cycle through
# A served result against a direct batch-1 call (the bucket it rode in may
# sum the FC tail in another order): JAX's tolerance, tests/test_serving.py.
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-6


def _uint8_batch(seed: int, n: int):
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)).cuda()


def _serving_engines():
    """The four engines phase 27 captures, at full width on the phase-12
    model's seeded weights: name -> (eager(images, conf, nms), graphs(conf,
    nms)). The default and chained engines share the q-params."""
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.serving import cuda_bottleneck as cb
    from yolo_tpu_torch.serving.engine import (build_int8_predict, default_impl,
                                               make_int8_engine_fn)
    from yolo_tpu_torch.serving.graphs import GraphedPredict
    from yolo_tpu_torch.serving.winograd import valid_points

    dev = torch.device("cuda")
    model = _int8_model()
    r = np.random.default_rng(43)
    calib = [device_normalize(torch.from_numpy(
        r.integers(0, 256, size=(8, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)) for _ in range(2)]
    fn, q = build_int8_predict(model, calib, impl=default_impl())
    wfn, wq = build_int8_predict(model, calib, impl=default_impl(),
                                 wino=valid_points((3, 4, 6, 3)))
    chain = make_int8_engine_fn(S, B, C, impl={
        **default_impl(), **{f"layer{i}": cb.chain_int8 for i in range(1, 5)}})
    exact = YOLOInference(model, dev, image_size=SIZE)

    def int8(f, qq):
        return ((lambda images, conf, nms: f(qq, images, conf, nms)),
                (lambda conf, nms: GraphedPredict(
                    lambda images: f(qq, images, conf, nms), dev)))

    engines = {"default int8": int8(fn, q), "chained int8": int8(chain, q),
               "wino int8 (all 16)": int8(wfn, wq),
               "fp32 exact": ((lambda images, conf, nms: exact.predict_batch_arrays(
                   images, conf, nms)),
                   (lambda conf, nms: GraphedPredict(exact.batch_fn(conf, nms), dev)))}
    return engines, (fn, q)


def _capture_mib(graphed, images) -> float:
    """Captures ``graphed`` at ``images``' shape; MiB the reserved memory grows
    by, with the cache emptied before and after: the graph's private pool,
    its static input and what the warm-up keeps (a side stream's library
    workspaces)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    graphed(images)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_reserved() - before) / 2**20


def phase_graphs(card: str) -> tuple:
    """Each engine replayed from one CUDA graph per batch against its eager
    call: bit for bit (int8) and exactly (fp32) at batch 1, 16 and 64, on
    two image sets each (the second replay's result is its own images'); ms
    a batch of both by CUDA events, the eager call's host issue time and
    the memory each capture keeps reserved. Every engine must capture: the
    chained engine's cooperative launch included."""
    import torch

    engines, (fn, q) = _serving_engines()
    thresholds = {}
    for name, (eager, make) in engines.items():
        probe = _uint8_batch(70, SLICE_BATCH)
        thr = thresholds[name] = float(eager(probe, float("-inf"), 2.0).scores.float().median())
        graphed = make(thr, IOU_T)
        for batch in GRAPH_BATCHES:
            first, second = _uint8_batch(72 + batch, batch), _uint8_batch(73 + batch, batch)
            captured_mib = _capture_mib(graphed, first)
            for images in (first, second):
                want = [t.clone() for t in eager(images, thr, IOU_T)]
                got = graphed(images)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name}, batch {batch}: the replayed detections "
                                         f"differ from the eager ones")
            kept = int(want[3].sum())
            counts = _counts()
            for _ in range(3):
                graphed(first)
            torch.cuda.synchronize()
            if _counts() != counts:
                raise AssertionError(f"{name}: replays moved the launch counters")
            iters = 5 if name == "fp32 exact" and batch == 64 else 20
            run = {"graph": lambda: graphed(first), "eager": lambda: eager(first, thr, IOU_T)}
            ms = {"graph": [], "eager": []}
            for turn in ("graph", "eager", "eager", "graph"):
                ms[turn].append(cuda_ms(run[turn], iters=iters))
            issue_us = host_us(run["eager"], calls=2)
            g, e = min(ms["graph"]), min(ms["eager"])
            log(f"[27] {card}: {name}, batch {batch}: replay == eager bit for bit on 2 "
                f"image sets ({kept} kept); ms/batch in turns graph, eager, eager, graph: "
                f"{ms['graph'][0]:.4f}, {ms['eager'][0]:.4f}, {ms['eager'][1]:.4f}, "
                f"{ms['graph'][1]:.4f} (best {batch * 1000.0 / g:.1f} vs "
                f"{batch * 1000.0 / e:.1f} img/s, {e / g:.2f}x; CUDA events); eager host issue "
                f"{issue_us / 1000:.3f} ms a batch; capture keeps {captured_mib:.1f} MiB "
                f"reserved")
        del graphed
        torch.cuda.empty_cache()
    return fn, q, thresholds["default int8"]


# ---------------------------------------------------------------- phase 28
def _png_bytes(array) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def _tie_order(entries: list) -> list:
    """JSON detections sorted by score, entries whose scores lie within the
    tolerance of their neighbour's taken as tied (ordered by class and box):
    two buckets may order such a pair either way."""
    groups, out = [], []
    for e in entries:
        if groups and abs(e["score"] - groups[-1][-1]["score"]) <= (
                SERVE_ATOL + SERVE_RTOL * abs(e["score"])):
            groups[-1].append(e)
        else:
            groups.append([e])
    for g in groups:
        out += sorted(g, key=lambda e: (e["class_id"], e["box"]))
    return out


def _same_json(got: list, want: list) -> bool:
    """Same count, classes and order (up to score ties), box and score
    within JAX's batch-1 tolerance."""
    if len(got) != len(want):
        return False
    got, want = _tie_order(got), _tie_order(want)
    if [(d["class_id"], d.get("class_name")) for d in got] != [
            (d["class_id"], d.get("class_name")) for d in want]:
        return False
    return bool(np.allclose([d["score"] for d in got], [d["score"] for d in want],
                            rtol=SERVE_RTOL, atol=SERVE_ATOL) and
                np.allclose([d["box"] for d in got], [d["box"] for d in want],
                            rtol=SERVE_RTOL, atol=SERVE_ATOL))


def _post_png(port: int, body: bytes) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/predict", body=body,
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    payload = json.loads(resp.read().decode())
    conn.close()
    return resp.status, payload


def _get_json(port: int, path: str) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    payload = json.loads(resp.read().decode())
    conn.close()
    return resp.status, payload


def _load(call, clients: int, requests: int) -> tuple:
    """``call(k)`` for k in range(requests) from ``clients`` threads: (wall s,
    per-request latencies in ms, results by k)."""
    import threading

    results, latencies = [None] * requests, [0.0] * requests
    errors = []

    def client(ks):
        for k in ks:
            t0 = time.perf_counter()
            try:
                results[k] = call(k)
            except Exception as exc:  # noqa: BLE001 — reported after the join
                errors.append(f"request {k}: {exc!r}")
            latencies[k] = (time.perf_counter() - t0) * 1000.0

    threads = [threading.Thread(target=client, args=(range(c, requests, clients),))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{len(errors)} request(s) failed: {errors[:3]}")
    return wall, latencies, results


# Kernels of one served batch of the default int8 engine: stem front, int8
# conv, NMS (phase 12).
SERVED_LAUNCHES = (1, 58, 1)
SERVED_KERNELS = ("quant_s2d_kernel", "int8_conv_kernel", "nms_kernel")


def _device_activity(prof) -> tuple:
    """(device busy ms, launches of SERVED_KERNELS) in a torch.profiler
    trace. Busy is the sum of its kernels' and copies' device times: the
    served path runs on one stream, so none overlap."""
    import torch

    busy, launches = 0.0, [0] * len(SERVED_KERNELS)
    for evt in prof.key_averages():
        is_range = "#" in evt.key and "(" not in evt.key
        if evt.device_type != torch.autograd.DeviceType.CUDA or is_range:
            continue
        busy += evt.device_time_total / 1000.0
        for i, name in enumerate(SERVED_KERNELS):
            if name in evt.key and "reduce" not in evt.key:
                launches[i] += evt.count
    return busy, tuple(launches)


# Host pause at each edge of a traced window. CUPTI drops kernels whose
# device timestamps fall outside the window; without a margin the trace
# missed the first 3-5 kernels after its start on the card.
TRACE_MARGIN_S = 0.02


def _trace(fn):
    """(``fn()``, its torch.profiler trace of device activity). A traced
    warm-up step that the trace drops runs first (CUPTI starts there), and
    the window has a host pause at each edge."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        prof.step()
    return out, prof


def _traced_load(call, clients: int, requests: int) -> tuple:
    """``_load`` under ``_trace``: (wall s, latencies, results, device busy
    ms, launches of SERVED_KERNELS), busy 0 where CUPTI recorded no device
    activity."""
    out, prof = _trace(lambda: _load(call, clients, requests))
    return out + _device_activity(prof)


def _launches_seen(tag: str, launches: tuple, want: tuple) -> str:
    """A trace's launches of SERVED_KERNELS against the count the path must
    make. CUPTI may drop a record, never add one: more than ``want`` raises,
    fewer is reported."""
    if any(a > b for a, b in zip(launches, want)):
        raise AssertionError(f"{tag}: the trace saw stem/conv/NMS launches {launches}, more "
                             f"than the {want} of the path")
    return (f"{launches}" if launches == want else
            f"{launches} of {want} (CUPTI dropped {sum(want) - sum(launches)} record(s))")


def _load_report(tag, card, batcher, before, wall, latencies, busy, launches) -> str:
    """The window's rates and bucket use; its idle share from the traced busy
    time. Raises where the trace saw more device time than the window's wall
    time, or more launches than its batches make."""
    batches = {b: batcher.bucket_batches[b] - before.get(b, 0) for b in SERVE_BUCKETS}
    n_batches = sum(batches.values())
    rows = sum(b * k for b, k in batches.items())
    wall_ms = wall * 1000.0
    if busy > 0:
        if busy > wall_ms:
            raise AssertionError(f"{tag}: the trace saw {busy:.3f} ms busy in {wall_ms:.3f} ms")
        seen = _launches_seen(tag, launches, tuple(n_batches * k for k in SERVED_LAUNCHES))
        idle = (f"device busy {busy:.3f} ms of {wall_ms:.3f}, idle "
                f"{100 * (1 - busy / wall_ms):.1f}%; launches stem/conv/NMS {seen}, "
                f"torch.profiler")
    else:
        idle = "idle not measured (torch.profiler saw no device time)"
    lat = np.asarray(latencies)
    return (f"{card}: {tag}: {len(lat) / wall:.1f} requests/s, p50 "
            f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms; "
            f"{n_batches} batches {dict(batches)}, {len(lat) / n_batches:.2f} images a batch, "
            f"bucket fill {100.0 * len(lat) / rows:.1f}%; {idle}")


def _replay_launches(graphed, images, replays: int = 5) -> str:
    """Launches of SERVED_KERNELS that ``replays`` replays make, by
    torch.profiler (CUPTI records a graph's kernels), against ``replays`` x
    SERVED_LAUNCHES."""
    def run():
        for _ in range(replays):
            graphed(images)

    graphed(images)
    busy, launches = _device_activity(_trace(run)[1])
    if not busy > 0:
        return "not measured (torch.profiler saw no device time)"
    want = tuple(replays * k for k in SERVED_LAUNCHES)
    return f"{_launches_seen('replays', launches, want)} in {replays} replays, torch.profiler"


def phase_server(fn, q, thr: float, card: str) -> None:
    """YOLOServer on 127.0.0.1:0 over the graph-wrapped default int8 engine,
    buckets (1, 4, 16), 2 ms: 1-64 concurrent HTTP clients, 256 requests
    each, every answer against a direct batch-1 call; the batcher alone at
    the same loads; buckets filled exactly, bit for bit against the direct
    bucket call; then python -m yolo_tpu_torch.serve --engine ... --port 0."""
    import queue
    import signal
    import threading

    import torch

    from yolo_tpu_torch.data.voc import VOC_CLASSES
    from yolo_tpu_torch.ops.decode import Detections
    from yolo_tpu_torch.serving import RequestBatcher, YOLOServer
    from yolo_tpu_torch.serving.export import save_engine
    from yolo_tpu_torch.serving.graphs import WARMUP_RUNS, GraphedPredict
    from yolo_tpu_torch.serving.server import detections_to_json

    arrays = np.random.default_rng(61).integers(0, 256, size=(SERVE_IMAGES, SIZE, SIZE, 3),
                                                dtype=np.uint8)
    pngs = [_png_bytes(a) for a in arrays]

    def direct(batch):
        dets = fn(q, torch.from_numpy(np.ascontiguousarray(batch)).cuda(), thr, IOU_T)
        return [t.cpu().numpy() for t in dets]

    want = [detections_to_json(Detections(*(f[0] for f in direct(a[None]))), VOC_CLASSES)
            for a in arrays]
    graphed = GraphedPredict(lambda images: fn(q, images, thr, IOU_T), "cuda")
    _zero_counts()
    server = YOLOServer(graphed, SIZE, host="127.0.0.1", port=0, buckets=SERVE_BUCKETS,
                        max_delay_ms=2.0)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        server.warmup()
        captured = _counts()
        at_capture = tuple(len(SERVE_BUCKETS) * (WARMUP_RUNS + 1) * k for k in SERVED_LAUNCHES)
        if captured != at_capture:
            raise AssertionError(f"capturing the served buckets counted stem/conv/NMS "
                                 f"{captured}, want {at_capture}")
        took = time.perf_counter() - t0
        torch.cuda.empty_cache()
        log(f"[28] YOLOServer on http://127.0.0.1:{server.port}, buckets {SERVE_BUCKETS}, "
            f"2 ms: {len(SERVE_BUCKETS)} graphs captured in {took:.1f} s; launches counted "
            f"at capture (stem/conv/NMS) {captured} (== {len(SERVE_BUCKETS)} buckets x "
            f"{WARMUP_RUNS + 1} runs x {SERVED_LAUNCHES}); the captures keep "
            f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB reserved")
        bucket_images = {b: _uint8_batch(80, b) for b in SERVE_BUCKETS}
        bucket_ms = {b: cuda_ms(lambda b=b: graphed(bucket_images[b]), iters=20)
                     for b in SERVE_BUCKETS}
        log(f"[28] replay ms a batch by bucket (CUDA events): " + ", ".join(
            f"{b}: {ms:.4f}" for b, ms in bucket_ms.items()) + "; launches stem/conv/NMS "
            + _replay_launches(graphed, bucket_images[SERVE_BUCKETS[-1]]))

        mismatches = 0
        in_process = None
        for clients in SERVE_CLIENTS:
            before = dict(server.batcher.bucket_batches)
            wall, lat, res, busy, launches = _traced_load(
                lambda k: _post_png(server.port, pngs[k % SERVE_IMAGES]), clients,
                SERVE_REQUESTS)
            for k, (status, body) in enumerate(res):
                if status != 200 or not _same_json(body["detections"], want[k % SERVE_IMAGES]):
                    mismatches += 1
            in_process = in_process or res[0][1]["detections"]
            log(f"[28] " + _load_report(f"HTTP, {clients} client(s)", card, server.batcher,
                                        before, wall, lat, busy, launches))
        if mismatches:
            raise AssertionError(f"{mismatches} HTTP answer(s) differ from the direct "
                                 f"batch-1 call")
        if _counts() != captured:
            raise AssertionError(f"replays moved the launch counters: {captured} -> "
                                 f"{_counts()}")
        status, health = _get_json(server.port, "/healthz")
        log(f"[28] every HTTP answer == detections_to_json of a direct batch-1 call (rtol "
            f"{SERVE_RTOL}, atol {SERVE_ATOL}); launch counters unchanged by the replays; "
            f"/healthz {status} {health}")

        batcher = server.batcher
        for clients in SERVE_CLIENTS:
            before = dict(batcher.bucket_batches)
            wall, lat, res, busy, launches = _traced_load(
                lambda k: batcher.submit(arrays[k % SERVE_IMAGES]).result(timeout=120),
                clients, SERVE_REQUESTS)
            bad = sum(not _same_json(detections_to_json(d, VOC_CLASSES),
                                     want[k % SERVE_IMAGES]) for k, d in enumerate(res))
            if bad:
                raise AssertionError(f"{bad} batcher result(s) differ from the direct call")
            log(f"[28] " + _load_report(f"batcher alone (uint8 arrays), {clients} client(s)",
                                        card, batcher, before, wall, lat, busy, launches))
    finally:
        server.close()

    for bucket in SERVE_BUCKETS:
        with RequestBatcher(graphed, (SIZE, SIZE, 3), buckets=(bucket,), max_delay_ms=1000.0,
                            dtype=np.uint8) as exact:
            for start in range(0, SERVE_IMAGES, bucket):
                group = arrays[start:start + bucket]
                got = [f.result(timeout=120) for f in [exact.submit(a) for a in group]]
                ref = direct(group)
                if not all(np.array_equal(g[f], ref[f][i]) for i, g in enumerate(got)
                           for f in range(4)):
                    raise AssertionError(f"bucket {bucket}: a batcher result differs from the "
                                         f"direct call on its bucket")
            if exact.bucket_batches[bucket] != SERVE_IMAGES // bucket:
                raise AssertionError(f"bucket {bucket}: {dict(exact.bucket_batches)} batches")
    log(f"[28] batcher alone, groups that fill a bucket exactly ({SERVE_BUCKETS}): every "
        f"result == the direct call on its bucket, bit for bit")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        artifact = Path(tmp) / "engine.npz"
        save_engine(artifact, q, S=S, B=B, num_classes=C)
        cmd = [sys.executable, "-m", "yolo_tpu_torch.serve", "--engine", str(artifact),
               "--port", "0", f"--conf-threshold={thr!r}"]
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True)
        lines: "queue.Queue" = queue.Queue()

        def read():
            for ln in proc.stdout:
                lines.put(ln)
            lines.put(None)  # the process closed its output

        threading.Thread(target=read, daemon=True).start()
        t0 = time.perf_counter()
        try:
            port, seen = None, []
            while port is None:
                line = lines.get(timeout=max(1.0, 240 - (time.perf_counter() - t0)))
                if line is None:
                    raise AssertionError(f"serve exited before it served: {seen}")
                seen.append(line.strip())
                if line.startswith("serving on http://"):
                    port = int(line.split()[2].rsplit(":", 1)[1])
            started = time.perf_counter() - t0
            status, health = _get_json(port, "/healthz")
            if status != 200 or health.get("status") != "ok":
                raise AssertionError(f"serve /healthz: {status} {health}")
            status, body = _post_png(port, pngs[0])
            if status != 200 or not _same_json(body["detections"], in_process):
                raise AssertionError(f"serve /predict: {status}, differs from the in-process "
                                     f"answer")
            log(f"[28] python -m yolo_tpu_torch.serve --engine <artifact> --port 0: "
                f"{' | '.join(seen)} (ready in {started:.1f} s); /healthz ok; /predict == the "
                f"in-process answer ({len(body['detections'])} detections)")
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"serve exited with {proc.returncode}")
    del graphed
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 36
def phase_aot(fn, q, thr: float, card: str) -> tuple:
    """The AOT artifact of phase 27's full-width default int8 engine (its q
    and threshold), batch 16, uint8 wire: export, save, size and load; one
    eager call of the loaded program launches the stem front, the int8 conv
    and NMS (1, 58, 1) times (counts zeroed just before); its CUDA graph
    replay == the live engine's bit for bit on two image sets, and both
    replay ms and eager ms (CUDA events, in turns); the host us a call of
    each kernel's custom op against its wrapper; a CPU-device load is
    refused; serve
    --compiled builds a GraphedPredict with the one bucket (16,). The
    artifact lives in a temporary directory removed at the end."""
    import torch

    from yolo_tpu_torch import serve
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.decode import decode_predictions
    from yolo_tpu_torch.serving import cuda_stem, library
    from yolo_tpu_torch.serving.engine import kernel_conv
    from yolo_tpu_torch.serving.export import (export_compiled_engine, load_compiled_engine,
                                               write_compiled_engine)
    from yolo_tpu_torch.serving.graphs import GraphedPredict

    dev = torch.device("cuda")
    batch = SLICE_BATCH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aot_") as tmp:
        path = Path(tmp) / "engine.pt2"
        t0 = time.perf_counter()
        exported, meta = export_compiled_engine(q, S, B, C, batch_size=batch,
                                                conf_threshold=thr, nms_threshold=IOU_T,
                                                image_size=SIZE)
        t1 = time.perf_counter()
        write_compiled_engine(path, exported, meta)
        t2 = time.perf_counter()
        del exported
        predict, meta = load_compiled_engine(path)
        t3 = time.perf_counter()
        size_mb = path.stat().st_size / 1e6
        if (meta["batch_size"], meta["platforms"], meta["dtype"]) != (batch, ["cuda"], "uint8"):
            raise AssertionError(f"[36] unexpected meta {meta}")

        first, second = _uint8_batch(90, batch), _uint8_batch(91, batch)
        torch.cuda.synchronize()
        _zero_counts()
        predict(first)
        torch.cuda.synchronize()
        launches = _counts()
        if launches != SERVED_LAUNCHES:
            raise AssertionError(f"[36] one eager call of the loaded program launched "
                                 f"(stem, int8 conv, NMS) {launches}, not {SERVED_LAUNCHES}")

        live = GraphedPredict(lambda images: fn(q, images, thr, IOU_T), dev)
        aot = GraphedPredict(predict, dev)
        kept = []
        for images in (first, second):
            want = [t.clone() for t in live(images)]
            got = aot(images)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("[36] the AOT artifact's replay differs from the live "
                                     "engine's")
            kept.append(int(want[3].sum()))
        replays = _replay_launches(aot, first)
        run = {"live": lambda: live(first), "aot": lambda: aot(first)}
        ms = {"live": [], "aot": []}
        for turn in ("live", "aot", "aot", "live"):
            ms[turn].append(cuda_ms(run[turn], iters=50))

        # The custom op's dispatch against the direct wrapper call, host time.
        s_img = q["s_img"]
        qc = q["layers"][0][1]["conv1"]
        x = torch.randint(-127, 128, (batch, 112, 112, qc["wq"].shape[2]), dtype=torch.int8,
                          device=dev, generator=torch.Generator(device=dev).manual_seed(92))
        grid = torch.from_numpy(np.random.default_rng(93).normal(
            size=(batch, S, S, B * 5 + C)).astype(np.float32)).to(dev)
        dets = decode_predictions(grid, S, B, C, 0.0)
        pairs = {
            "stem": (lambda: cuda_stem.quant_s2d(first, s_img),
                     lambda: torch.ops.yolo_tpu_torch.quant_s2d(first, s_img)),
            "int8 conv (layer1 1x1)": (lambda: kernel_conv(x, qc, 1, 0, "relu"),
                                       lambda: library.aot_conv(x, qc, 1, 0, "relu")),
            "NMS": (lambda: cuda_nms.nms(dets, IOU_T), lambda: library.aot_nms(dets, IOU_T)),
        }
        with torch.inference_mode():  # as the engine and the loaded program run them
            host = {name: (host_us(wrapper), host_us(op)) for name, (wrapper, op) in
                    pairs.items()}
        eager = {"live": lambda: fn(q, first, thr, IOU_T), "aot": lambda: predict(first)}
        eager_ms = {"live": [], "aot": []}
        for turn in ("live", "aot", "aot", "live"):
            eager_ms[turn].append(cuda_ms(eager[turn], iters=10))

        try:
            load_compiled_engine(path, "cpu")
        except ValueError as exc:
            refused = str(exc)
        else:
            raise AssertionError("[36] a CPU-device load of the CUDA artifact was not refused")
        served, buckets, image_size = serve.build_predict(serve.parse_args(
            ["--compiled", str(path)]))
        if not isinstance(served, GraphedPredict) or buckets != (batch,) or image_size != SIZE:
            raise AssertionError(f"[36] serve --compiled gave {type(served).__name__}, buckets "
                                 f"{buckets}, image size {image_size}")
    log(f"[36] {card}: AOT artifact of the full-width default int8 engine (batch {batch}, "
        f"uint8, conf {thr:.6g}, NMS {IOU_T}): export {t1 - t0:.2f} s, save {t2 - t1:.2f} s, "
        f"{size_mb:.1f} MB, load {t3 - t2:.2f} s; one eager call launches (stem, int8 conv, "
        f"NMS) {launches}; replay == the live graph bit for bit on 2 image sets "
        f"({kept[0]}, {kept[1]} kept); {replays}")
    log(f"[36] {card}: replay ms/batch in turns live, aot, aot, live: {ms['live'][0]:.4f}, "
        f"{ms['aot'][0]:.4f}, {ms['aot'][1]:.4f}, {ms['live'][1]:.4f} (CUDA events)")
    log(f"[36] {card}: eager call ms/batch in turns live, aot, aot, live: "
        f"{eager_ms['live'][0]:.4f}, {eager_ms['aot'][0]:.4f}, {eager_ms['aot'][1]:.4f}, "
        f"{eager_ms['live'][1]:.4f} (CUDA events; the graph replays pay no dispatch)")
    log(f"[36] {card}: host us a call under inference_mode, wrapper vs custom op: " + ", ".join(
        f"{name} {w:.1f} vs {o:.1f}" for name, (w, o) in host.items()))
    log(f"[36] a CPU-device load is refused ({refused}); serve --compiled: GraphedPredict, "
        f"buckets {buckets}")
    del live, aot, served, predict
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 29
def _yolov1_model():
    """The full-width 24-conv YOLOv1 (448x448, 20 classes), seeded, on the card."""
    import torch

    from yolo_tpu_torch.models import create_model

    dev = torch.device("cuda")
    return create_model("yolov1", C, S, B, device=dev, image_size=SIZE,
                        generator=torch.Generator(device=dev).manual_seed(0))


def phase_yolov1_slice(card: str) -> int:
    """The 24-conv model's inference: its grid against the CPU's at batch 2,
    YOLOInference at batch 16 (one NMS launch, keep masks == plain NMS), the
    predict and evaluate CLIs with --backbone yolov1, img/s at 1 / 16 / 64.
    Returns the NMS launches of the batch-16 call."""
    import torch
    from PIL import Image

    from yolo_tpu_torch import evaluate, predict
    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.decode import Detections, decode_predictions, threshold_mask
    from yolo_tpu_torch.ops.nms import batched_nms

    dev = torch.device("cuda")
    engine = YOLOInference(_yolov1_model(), dev, image_size=SIZE)
    n_params = sum(p.numel() for p in engine.model.parameters())
    images_np = np.random.default_rng(41).integers(
        0, 256, size=(SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    images = torch.from_numpy(images_np).to(dev)
    log(f"[29] 24-conv YOLOv1, {n_params} parameters (fc1 "
        f"{engine.model.head[1].weight.numel()}), {SIZE}x{SIZE} fp32, channels_last")

    with torch.inference_mode():
        raw = engine.model(device_normalize(images).permute(0, 3, 1, 2))
        all_scores = decode_predictions(raw, S, B, C, float("-inf")).scores
    cpu_model = copy.deepcopy(engine.model).to("cpu", memory_format=torch.contiguous_format)
    with torch.inference_mode():
        ref = cpu_model(device_normalize(torch.from_numpy(images_np[:2])).permute(0, 3, 1, 2))
    del cpu_model
    err = float((raw[:2].cpu() - ref).abs().max())
    tol = RAW_ATOL_REL * float(ref.abs().max()) + RAW_ATOL_ABS
    log(f"[29] raw (2, 7, 7, 30) grid, GPU vs CPU: max abs err {err:.3g} (tolerance "
        f"{tol:.3g}; max |ref| {float(ref.abs().max()):.3g})")
    if not err <= tol:
        raise AssertionError(f"24-conv: GPU and CPU forwards differ by {err} > {tol}")

    thr = float(all_scores.float().median())
    thr_cli = float(all_scores.float().quantile(0.9))
    cuda_nms.LAUNCHES = 0
    out = engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=IOU_T)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    if launches != 1:
        raise AssertionError(f"24-conv batch of {SLICE_BATCH}: {launches} NMS launches, not 1")
    host = Detections(*(t.cpu() for t in out))
    if not all(bool(torch.isfinite(t).all()) for t in (host.boxes, host.scores)):
        raise AssertionError("24-conv: non-finite detections")
    pre = host._replace(valid=threshold_mask(host.scores, thr))
    if not torch.equal(host.valid, batched_nms(pre, IOU_T).valid):
        raise AssertionError("24-conv keep masks differ from decode + plain NMS on the CPU")
    log(f"[29] YOLOInference batch {SLICE_BATCH}: NMS launches {launches}; "
        f"{int(pre.valid.sum())} candidates, {int(host.valid.sum())} kept; keep masks == "
        f"decode + plain batched_nms on CPU copies")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_yolov1_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "yolo24.pth"
        torch.save(engine.model.state_dict(), ckpt)
        img_dir, out_dir = tmp / "images", tmp / "predictions"
        img_dir.mkdir()
        r = np.random.default_rng(43)
        for k in range(3):
            Image.fromarray(r.integers(0, 256, size=(375, 500, 3), dtype=np.uint8)).save(
                img_dir / f"image{k}.jpg")
        cuda_nms.LAUNCHES = 0
        predict.main(["--checkpoint", str(ckpt), "--image-dir", str(img_dir), "--output",
                      str(out_dir), "--backbone", "yolov1", "--device", "cuda",
                      f"--conf-threshold={thr_cli}"])
        written = sorted(p.name for p in out_dir.iterdir())
        if written != [f"image{k}_pred.jpg" for k in range(3)] or cuda_nms.LAUNCHES < 1:
            raise AssertionError(f"predict --backbone yolov1 wrote {written}, "
                                 f"{cuda_nms.LAUNCHES} NMS launches")
        log(f"[29] predict --backbone yolov1: wrote {written}; NMS launches "
            f"{cuda_nms.LAUNCHES}")
        _write_voc(tmp / "voc")
        cuda_nms.LAUNCHES = 0
        res = evaluate.main(["--checkpoint", str(ckpt), "--data-root", str(tmp / "voc"),
                             "--year", "2007", "--image-set", "trainval", "--batch-size",
                             "2", "--num-workers", "2", "--device", "cuda", "--backbone",
                             "yolov1", "--fast-eval"])
        if len(res) != 77 or not all(np.isfinite(v) for v in res.values()) \
                or cuda_nms.LAUNCHES != 2:
            raise AssertionError(f"evaluate --backbone yolov1: {len(res)} keys, NMS launches "
                                 f"{cuda_nms.LAUNCHES} (want 77 keys, 2 launches)")
        log(f"[29] evaluate --backbone yolov1 (4 images, batches of 2): 77 finite keys, "
            f"NMS launches {cuda_nms.LAUNCHES}")

    r = np.random.default_rng(47)
    for batch in (1, SLICE_BATCH, 64):
        x = torch.from_numpy(r.integers(0, 256, size=(batch, SIZE, SIZE, 3),
                                        dtype=np.uint8)).to(dev)
        ms = cuda_ms(lambda: engine.predict_batch_arrays(x, thr, IOU_T), iters=10)
        log(f"[29] {card}: 24-conv fp32 inference (uint8 on the card -> forward -> decode "
            f"-> NMS kernel), batch {batch}: {ms:.3f} ms/batch, {batch * 1000.0 / ms:.1f} "
            f"img/s (CUDA events, 10 iterations after 3 warm-up)")
    del engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 30
def phase_yolov1_train(card: str) -> None:
    """24-conv training: three fp32 steps on one fixed batch (finite, falling
    loss), the train CLI with --backbone yolov1 at 64x64 for an epoch and a
    resumed second, then step ms, img/s and peak memory."""
    import torch

    from yolo_tpu_torch import train

    model = _yolov1_model().to(memory_format=torch.channels_last)
    images_np, targets_np = _slice_batch(SLICE_BATCH)
    images = torch.from_numpy(images_np).cuda()
    targets = torch.from_numpy(targets_np).cuda()
    model.head[3].fixed_mask = torch.rand(
        (SLICE_BATCH, 4096), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3)) < 0.5
    trainer = _trainer(model)
    losses = [float(trainer.train_step(images, targets)["total"]) for _ in range(3)]
    if not (all(np.isfinite(losses)) and losses[2] < losses[1] < losses[0]):
        raise AssertionError(f"24-conv fp32 steps: losses {losses} are not finite and falling")
    log(f"[30] 24-conv fp32 batch {SLICE_BATCH}, one fixed batch and dropout mask: losses "
        f"{[round(v, 4) for v in losses]}")
    model.head[3].fixed_mask = None

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train24_") as tmp:
        tmp = Path(tmp)
        _write_voc(tmp / "voc")
        args = ["--data-root", str(tmp / "voc"), "--device", "cuda", "--backbone", "yolov1",
                "--batch-size", "2", "--image-size", "64", "--num-workers", "2",
                "--worker-type", "thread", "--checkpoint-dir", str(tmp / "ck"),
                "--log-dir", str(tmp / "runs")]
        train.main([*args, "--epochs", "1"])
        written = sorted(p.name for p in (tmp / "ck").iterdir())
        first = torch.load(tmp / "ck" / "yolo_latest.pth", map_location="cpu",
                           weights_only=True)["scheduler_state_dict"]["last_epoch"]
        if written != ["yolo_best.pth", "yolo_latest.pth"]:
            raise AssertionError(f"train --backbone yolov1 wrote {written}")
        train.main([*args, "--epochs", "2", "--resume", "true"])
        ck = torch.load(tmp / "ck" / "yolo_latest.pth", map_location="cpu", weights_only=True)
        steps = {float(v["step"]) for v in ck["optimizer_state_dict"]["state"].values()}
        if ck["epoch"] != 2 or "head.1.weight" not in ck["model_state_dict"] \
                or steps != {2.0 * first}:
            raise AssertionError(f"train --backbone yolov1 --resume: epoch {ck['epoch']}, "
                                 f"Adam steps {steps}")
        log(f"[30] train --backbone yolov1 --image-size 64: {written} after {first} steps, "
            f"--resume true: epoch 2, Adam step {2 * first}")
        del ck

    r = np.random.default_rng(53)
    for use_amp, batch in ((False, SLICE_BATCH), (True, 32)):
        trainer = _trainer(model, use_amp=use_amp)
        x = torch.from_numpy(r.integers(0, 256, size=(batch, SIZE, SIZE, 3),
                                        dtype=np.uint8)).cuda()
        t = torch.from_numpy(_slice_batch(1)[1].repeat(batch, 0)).cuda()
        step = lambda: trainer.train_step(x, t)  # noqa: E731
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[30] {card}: 24-conv train step, {'bf16 autocast' if use_amp else 'fp32'}, "
            f"batch {batch}: {ms:.2f} ms, {batch * 1000.0 / ms:.1f} img/s (CUDA events, 5 "
            f"steps after 2 warm-up); peak memory {peak:.2f} GiB")
        del trainer, x
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 31
REMAT_BATCH = 8
# Per fused-BN kernel, launches of one full-width fp32 step with fused_bn
# "full": 53 BNs; under remat "block" or "stage" the backward re-runs the
# forward of the 52 BNs inside the bottlenecks (the stem's stays outside).
REMAT_LAUNCHES = {"none": dict.fromkeys(("stats", "normalize", "bwd_reduce", "bwd_dx"), 53),
                  "block": {"stats": 105, "normalize": 105, "bwd_reduce": 53, "bwd_dx": 53}}
REMAT_LAUNCHES["stage"] = REMAT_LAUNCHES["block"]


def _remat_step(fused_bn, remat, images, targets, mask) -> tuple:
    """One fp32 train step of the seeded full-width ResNet50: (loss parts,
    clipped gradients, BN buffers, fused-BN launches counted from 0)."""
    import torch

    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.ops import fused_bn as fb

    dev = torch.device("cuda")
    model = create_model("resnet", C, S, B, device=dev, image_size=SIZE, fused_bn=fused_bn,
                         remat=remat, generator=torch.Generator(device=dev).manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    model.head.fc_layers[3].fixed_mask = mask
    trainer = _trainer(model)
    for k in fb.LAUNCHES:
        fb.LAUNCHES[k] = 0
    parts = trainer.train_step(images, targets)
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    grads = {k: p.grad for k, p in model.named_parameters()}
    buffers = {k: v for k, v in model.state_dict().items()
               if "running_" in k or "num_batches" in k}
    return {k: float(v) for k, v in parts.items()}, grads, buffers, launches


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def phase_remat(card: str) -> dict:
    """Remat at full-width ResNet50, fp32, batch 8: "block" and "stage" against
    "none", each with fused_bn False and "full", on one batch and dropout
    mask, cuDNN deterministic. Returns the fused-BN launches of a "block" step."""
    import torch

    images_np, targets_np = _slice_batch(REMAT_BATCH)
    images = torch.from_numpy(images_np).cuda()
    targets = torch.from_numpy(targets_np).cuda()
    mask = torch.rand((REMAT_BATCH, 4096), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(5)) < 0.5
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    seen = {}
    try:
        for fused in (False, "full"):
            base = _remat_step(fused, "none", images, targets, mask)
            again = _remat_step(fused, "none", images, targets, mask)
            # Two "none" steps set the run-to-run spread the remat steps are held to.
            spread = max(_rel_l2(again[1][k], g) for k, g in base[1].items())
            del again
            for remat in ("none", "block", "stage"):
                parts, grads, buffers, launches = (
                    base if remat == "none" else _remat_step(fused, remat, images, targets,
                                                             mask))
                want = REMAT_LAUNCHES[remat] if fused else dict.fromkeys(launches, 0)
                if launches != want:
                    raise AssertionError(f"remat {remat}, fused_bn={fused!r}: fused-BN launches "
                                         f"{launches}, expected {want}")
                seen[(fused, remat)] = launches
                if remat == "none":
                    continue
                for k, v in base[0].items():
                    if not abs(parts[k] - v) <= 1e-4 * abs(v) + 1e-6:
                        raise AssertionError(f"remat {remat}: loss part {k} {parts[k]} vs {v}")
                worst = max((_rel_l2(grads[k], g), k) for k, g in base[1].items())
                if not worst[0] <= 4 * spread + 1e-5:
                    raise AssertionError(f"remat {remat}, fused_bn={fused!r}: gradient {worst[1]} "
                                         f"off by {worst[0]:.3g} (relative L2; none vs none "
                                         f"{spread:.3g})")
                n_bn = 0
                for k, v in base[2].items():
                    got = buffers[k]
                    if "num_batches" in k:
                        n_bn += 1
                        if int(got) != 1:
                            raise AssertionError(f"remat {remat}: {k} = {int(got)}, not 1")
                    elif not bool(((got - v).abs() <= 1e-4 * v.abs() + 1e-5).all()):
                        raise AssertionError(f"remat {remat}: {k} differs from none's by "
                                             f"{float((got - v).abs().max())}")
                log(f"[31] remat={remat!r}, fused_bn={fused!r}, fp32 batch {REMAT_BATCH}: loss "
                    f"{parts['total']:.6f} (none {base[0]['total']:.6f}); worst gradient "
                    f"relative L2 vs none {worst[0]:.3g} at {worst[1]} (none vs none "
                    f"{spread:.3g}); {n_bn} BNs num_batches_tracked 1, running buffers agree; "
                    f"fused-BN launches {launches}")
                del grads, buffers
            del base
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev

    from yolo_tpu_torch.models import create_model

    r = np.random.default_rng(59)
    for batch in (64, 128):
        x = torch.from_numpy(r.integers(0, 256, size=(batch, SIZE, SIZE, 3),
                                        dtype=np.uint8)).cuda()
        t = torch.from_numpy(_slice_batch(1)[1].repeat(batch, 0)).cuda()
        for remat in ("none", "block", "stage"):
            model = create_model("resnet", C, S, B, device="cuda", image_size=SIZE,
                                 remat=remat).to(memory_format=torch.channels_last)
            trainer = _trainer(model, use_amp=True)
            step = lambda: trainer.train_step(x, t)  # noqa: E731
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, iters=5, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[31] {card}: ResNet50 train step, bf16 autocast, batch {batch}, "
                f"remat={remat!r}: {ms:.2f} ms, {batch * 1000.0 / ms:.1f} img/s (CUDA events, "
                f"5 steps after 3 warm-up); peak memory {peak:.2f} GiB")
            del trainer, model, step
            torch.cuda.empty_cache()
    return seen[("full", "block")]


# ---------------------------------------------------------------- phase 32
def phase_quantized(card: str) -> int:
    """create_model(quantized=True) at full width: each distinct int8 conv
    geometry at batch 2 through the kernel ("float" epilogue) against its
    plain twin, bit for bit; the int8 conv launches of one batch-16 forward
    (57 for the ResNet, 24 for the 24-conv model); the grid within 5% of
    the fp32 model's max; ms a batch beside fp32. Returns the ResNet's
    launches."""
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.models.layers import Int8Conv2d, quantize_input
    from yolo_tpu_torch.serving import cuda_int8

    dev = torch.device("cuda")
    cl = torch.channels_last
    r = np.random.default_rng(61)
    images = torch.from_numpy(r.integers(0, 256, size=(SLICE_BATCH, SIZE, SIZE, 3),
                                         dtype=np.uint8)).to(dev)
    x = device_normalize(images).permute(0, 3, 1, 2)
    out = {}
    for backbone, want in (("resnet", 57), ("yolov1", 24)):
        def build(quantized):
            return create_model(backbone, C, S, B, device=dev, image_size=SIZE,
                                quantized=quantized,
                                generator=torch.Generator(device=dev).manual_seed(0)).to(
                                    memory_format=cl)

        fp, q = build(False), build(True)
        convs = [m for m in q.modules() if isinstance(m, Int8Conv2d)]
        if len(convs) != want:
            raise AssertionError(f"quantized {backbone}: {len(convs)} int8 convs, not {want}")
        seen = {}

        def hook(mod, inputs, output):
            xin = inputs[0]
            key = (tuple(xin.shape[1:]), mod.out_channels, mod.kernel_size[0], mod.stride[0],
                   mod.padding[0], mod.bias is not None)
            if key not in seen:  # the LeakyReLU after a conv runs in place: keep copies
                seen[key] = (mod, xin.clone(), output.clone())

        handles = [m.register_forward_hook(hook) for m in convs]
        with torch.inference_mode():
            q(x[:2])
        for h in handles:
            h.remove()
        with torch.inference_mode():
            for key, (mod, xin, output) in seen.items():
                wq, s_w, wk, c127 = mod.quantized_weight()
                xq, s_x = quantize_input(xin, c127)
                m = s_x * s_w
                t = mod.bias.float() if mod.bias is not None else torch.zeros_like(s_w)
                got = cuda_int8.conv_int8(xq, wq, m, t, mod.stride[0], mod.padding[0],
                                          "float", wk=wk)
                ref = cuda_int8.conv_int8_reference(xq, wq, m, t, mod.stride[0],
                                                    mod.padding[0], "float")
                if not (torch.equal(got, ref) and torch.equal(got.permute(0, 3, 1, 2), output)):
                    raise AssertionError(f"quantized {backbone} conv {key}: kernel != twin "
                                         f"(max diff {float((got - ref).abs().max())})")
        torch.cuda.synchronize()
        log(f"[32] quantized {backbone}: {len(seen)} distinct int8 conv geometries at batch 2 "
            f"(input C, H, W; Cout; k; stride; pad; bias), kernel == twin bit for bit: "
            + ", ".join(str(k) for k in seen))
        del seen

        cuda_int8.LAUNCHES = 0
        with torch.inference_mode():
            yq = q(x)
        torch.cuda.synchronize()
        launches = cuda_int8.LAUNCHES
        if launches != want:
            raise AssertionError(f"quantized {backbone} forward at batch {SLICE_BATCH}: "
                                 f"{launches} int8 conv launches, not {want}")
        with torch.inference_mode():
            yf = fp(x)
            rel = float((yq - yf).abs().max() / yf.abs().max())
        if not (bool(torch.isfinite(yq).all()) and rel < 0.05):
            raise AssertionError(f"quantized {backbone}: max|q - fp32| / max|fp32| = {rel:.3g}")
        with torch.inference_mode():
            q_ms = cuda_ms(lambda: q(x), iters=10)
            f_ms = cuda_ms(lambda: fp(x), iters=10)
        log(f"[32] quantized {backbone} forward, batch {SLICE_BATCH}: {launches} int8 conv "
            f"launches; grid max|q - fp32| / max|fp32| = {rel:.3g} (< 0.05); {card}: "
            f"{q_ms:.3f} ms/batch quantized vs {f_ms:.3f} fp32 (CUDA events, 10 iterations "
            f"after 3 warm-up)")
        out[backbone] = launches
        del fp, q, yq, yf
        torch.cuda.empty_cache()
    return out["resnet"]

# ---------------------------------------------------------------- phases 33-35
# Each rank is a process of its own (torch's idiom); the ranks of a world
# share the one card, so every time they print is two ranks time-sharing one
# card over gloo, not a scaling figure. NCCL refuses two ranks on one
# device: the worlds of two run gloo, and phase 33 (a) runs NCCL at a world
# of one.
PAR_BATCH = 16


class _Batches:
    """A loader of fixed (images, targets) batches with its batch size."""

    def __init__(self, batches, batch_size: int):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _rank_main(rank: int, world: int, workdir: str, task: str, n_data: int, n_model: int):
    """One rank of a world on the card: join it, make the mesh, run ``task``
    and save its result as ``rank{r}.pt`` in ``workdir``."""
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from yolo_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    device = initialize_distributed("cuda", init_method=f"file://{workdir}/store",
                                    world_size=world, rank=rank)
    try:
        mesh = make_mesh(n_data, n_model, "cuda")
        out = PAR_TASKS[task](mesh, device)
        out["backend"] = dist.get_backend()
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _world(task: str, n_data: int, n_model: int, timeout: float = 600.0) -> list:
    """Run ``task`` on ``n_data * n_model`` spawned ranks; their results in rank order."""
    import torch
    import torch.multiprocessing as mp

    world = n_data * n_model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(world, tmp, task, n_data, n_model),
                                 nprocs=world, join=False, start_method="spawn")
        t0 = time.perf_counter()
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > timeout:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"{task}: the world of {world} ran over {timeout} s")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _par_inputs():
    """The global batch, its targets and its dropout mask, on the card."""
    import torch

    images_np, targets_np = _slice_batch(PAR_BATCH)
    mask = torch.rand((PAR_BATCH, 4096), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3)) < 0.5
    return torch.from_numpy(images_np).cuda(), torch.from_numpy(targets_np).cuda(), mask


def _par_trainer(model, mesh=None):
    import torch

    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer

    optimizer, schedule = make_optimizer(model, 1e-4, 5e-4, milestones_steps=[])
    return Trainer(model, optimizer, schedule, device=torch.device("cuda"), mesh=mesh)


def _step(trainer, images, targets, mask):
    """One train step on the global batch and dropout mask: (loss parts, ms)."""
    import torch

    trainer.model.head.fc_layers[3].fixed_mask = mask
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = trainer.train_step(images, targets)
    torch.cuda.synchronize()
    return {k: float(v) for k, v in parts.items()}, (time.perf_counter() - t0) * 1e3


def _steady_ms(trainer, images, targets, mask, steps: int = 3) -> float:
    """Mean ms of ``steps`` more steps by CUDA events (after the compared one)."""
    trainer.model.head.fc_layers[3].fixed_mask = mask
    return cuda_ms(lambda: trainer.train_step(images, targets), iters=steps, warmup=1)


def _task_ddp_one(mesh, device) -> dict:
    """(a) NCCL world of 1: the DDP step against the plain Trainer's, bit for bit."""
    import torch

    images, targets, mask = _par_inputs()
    plain = _par_trainer(_model("full"))
    p_parts, _ = _step(plain, images, targets, mask)
    p_grads = {k: p.grad.clone() for k, p in plain.model.named_parameters()}
    p_bufs = {k: v.clone() for k, v in plain.model.state_dict().items()
              if "running_" in k or "num_batches" in k}
    p_ms = _steady_ms(plain, images, targets, mask)
    del plain
    torch.cuda.empty_cache()
    ddp = _par_trainer(_model("full"), mesh)
    d_parts, _ = _step(ddp, images, targets, mask)
    same_grads = all(torch.equal(p.grad, p_grads[k]) for k, p in ddp.model.named_parameters())
    same_bufs = all(torch.equal(v, p_bufs[k]) for k, v in ddp.model.state_dict().items()
                    if k in p_bufs)
    d_ms = _steady_ms(ddp, images, targets, mask)
    return {"parts": (p_parts, d_parts), "grads_equal": same_grads, "buffers_equal": same_bufs,
            "ms": (p_ms, d_ms), "n_grads": len(p_grads), "n_buffers": len(p_bufs)}


def _task_dp_two(mesh, device) -> dict:
    """(b) gloo (2, 1): the synchronized step; rank 0 then runs the
    single-process step on the global batch, and the same step in float64,
    and compares."""
    import torch
    import torch.distributed as dist

    from yolo_tpu_torch.ops import fused_bn as fb

    images, targets, mask = _par_inputs()
    trainer = _par_trainer(_model("full"), mesh)
    for k in fb.LAUNCHES:
        fb.LAUNCHES[k] = 0
    fb.ALL_REDUCES = 0
    parts, ms = _step(trainer, images, targets, mask)
    out = {"parts": parts, "ms": ms, "launches": dict(fb.LAUNCHES),
           "all_reduces": fb.ALL_REDUCES,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    bufs = {k: v.clone() for k, v in trainer.model.state_dict().items() if "running_" in k}
    del trainer
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        ref = _par_trainer(_model("full"))
        ref_parts, ref_ms = _step(ref, images, targets, mask)
        one = {k: p.grad.clone() for k, p in ref.model.named_parameters()}
        sd = ref.model.state_dict()
        buf_err = {k: float((v - sd[k]).abs().max() / sd[k].abs().max()) for k, v in bufs.items()}
        del ref, sd
        torch.cuda.empty_cache()
        ref64 = _model(False).double()
        ref64.head.fc_layers[3].fixed_mask = mask
        _float64_grads(ref64, images, targets)
        g64 = {k: p.grad for k, p in ref64.named_parameters()}
        rel = {k: _rel_l2(grads[k], one[k]) for k in one}
        # Each step's distance to float64, parameter by parameter: the
        # synchronized step must be as close as the one-process step.
        to64 = {k: (_rel_l2(grads[k], g), _rel_l2(one[k], g)) for k, g in g64.items()}
        worst = max(to64, key=lambda k: to64[k][0] - 2 * to64[k][1])
        out.update(ref_parts=ref_parts, ref_ms=ref_ms, grad_rel_l2=max(rel.values()),
                   worst_grad=max(rel, key=rel.get), to64=to64, worst64=worst,
                   buffer_err=max(buf_err.values()), worst_buffer=max(buf_err, key=buf_err.get))
        del ref64, g64, one
    del grads, bufs
    torch.cuda.empty_cache()
    return out


def _task_tp_two(mesh, device) -> dict:
    """(c) gloo (1, 2): the tensor-parallel head: shard shapes, the grid,
    the global gradient norm; rank 0 then runs the unsharded model."""
    import torch
    import torch.distributed as dist

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.parallel.mesh import gather, sharded_parameters

    images, targets, mask = _par_inputs()
    x = device_normalize(images).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    trainer = _par_trainer(_model("full"), mesh)
    model = trainer.model
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters() if "fc_layers" in k}
    with torch.no_grad():
        grid = model.eval()(x).clone()
    torch.cuda.reset_peak_memory_stats()
    parts, ms = _step(trainer, images, targets, mask)
    peak = torch.cuda.max_memory_allocated() / 2**30
    norm = float(trainer.last_grad_norm)
    # The same (clipped) gradients' norm two ways: the Trainer's from the
    # shards, and the plain norm of the gathered gradients.
    dims = sharded_parameters(model)
    full = [gather(p.grad, mesh.get_group("model"), dims[k]).double() if k in dims
            else p.grad.double().cpu() for k, p in model.named_parameters()]
    again = float(trainer.grad_norm())
    direct = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in full])))
    out = {"shapes": shapes, "parts": parts, "ms": ms, "peak_gib": peak, "norm": norm,
           "norm_two_ways": (again, direct)}
    del trainer, model, full
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        ref = _par_trainer(_model("full"))
        with torch.no_grad():
            ref_grid = ref.model.eval()(x)
        torch.cuda.reset_peak_memory_stats()
        ref_parts, ref_ms = _step(ref, images, targets, mask)
        out.update(grid_err=float((grid - ref_grid).abs().max() / ref_grid.abs().max()),
                   ref_norm=float(ref.last_grad_norm), ref_parts=ref_parts, ref_ms=ref_ms,
                   ref_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del ref
        torch.cuda.empty_cache()
        ref64 = _model(False).double()
        ref64.head.fc_layers[3].fixed_mask = mask
        out["norm64"] = _float64_step(ref64, images, targets)
        del ref64
    torch.cuda.empty_cache()
    return out


def phase_parallel_train(card: str) -> tuple:
    """Phase 33: data parallelism with synchronized BN, and the TP head, at
    full width (ResNet50, 448x448, fp32, TF32 off, deterministic cuDNN).
    Returns (b)'s first rank's fused-BN launches and BN all-reduces."""
    import torch

    torch.cuda.empty_cache()
    (a,) = _world("ddp_one", 1, 1)
    log(f"[33] (a) {a['backend']} world of 1, DistributedDataParallel, batch {PAR_BATCH}: "
        f"loss {a['parts'][1]['total']:.6f} (plain Trainer {a['parts'][0]['total']:.6f}); "
        f"{a['n_grads']} gradients equal: {a['grads_equal']}; {a['n_buffers']} BN buffers "
        f"equal: {a['buffers_equal']}")
    log(f"[33] (a) {card}: train step, CUDA events, 3 steps after the compared one: plain "
        f"Trainer {a['ms'][0]:.2f} ms, DDP world of 1 {a['ms'][1]:.2f} ms")
    if a["parts"][0] != a["parts"][1] or not (a["grads_equal"] and a["buffers_equal"]):
        raise AssertionError("(a) the DDP step of a world of 1 differs from the plain step")

    ranks = _world("dp_two", 2, 1)
    r0 = ranks[0]
    loss = float(np.mean([r["parts"]["total"] for r in ranks]))
    want = r0["ref_parts"]["total"]
    w = r0["worst64"]
    log(f"[33] (b) {r0['backend']} world of 2, mesh (2, 1), {PAR_BATCH // 2} images a rank: "
        f"loss {loss:.6f} (mean of the ranks') vs one process at {PAR_BATCH} {want:.6f} (rel "
        f"{abs(loss - want) / want:.2e}); worst gradient relative L2 vs one process "
        f"{r0['grad_rel_l2']:.3g} at {r0['worst_grad']}; running stats worst max |diff| / max "
        f"|value| {r0['buffer_err']:.2e} at {r0['worst_buffer']}")
    for k in dict.fromkeys((*GRAD_NAMES, r0["worst_grad"], w)):
        log(f"[33] (b) gradient {k}: relative L2 vs float64, synchronized "
            f"{r0['to64'][k][0]:.3g}, one process {r0['to64'][k][1]:.3g}")
    for r, out in enumerate(ranks):
        log(f"[33] (b) rank {r}: fused-BN launches {out['launches']}, BN all-reduces "
            f"{out['all_reduces']}; step {out['ms']:.1f} ms (two ranks time-sharing one card "
            f"over gloo, not a scaling figure); peak memory {out['peak_gib']:.2f} GiB")
    log(f"[33] (b) {card}: one process at batch {PAR_BATCH}: step {r0['ref_ms']:.1f} ms (first "
        f"step, host clock)")
    if not abs(loss - want) <= 1e-5 * abs(want):
        raise AssertionError(f"(b) loss {loss} vs {want}")
    # float32 gradients of one step: a sum over 802,816 rows a channel (the
    # stem BN's bias) differs between two summation orders by more than
    # 1e-4 of its small total, so each step is held to float64 instead.
    sync64, one64 = r0["to64"][w]
    if not sync64 <= 2 * one64 + 1e-5 or not r0["buffer_err"] <= 1e-5:
        raise AssertionError(f"(b) gradient {w} {sync64:.3g} from float64 (one process "
                             f"{one64:.3g}), or running stats off by {r0['buffer_err']:.3g}")
    for out in ranks:
        if out["launches"] != dict.fromkeys(out["launches"], 53) or out["all_reduces"] != 106:
            raise AssertionError(f"(b) each rank must launch each fused-BN kernel 53 times "
                                 f"with 106 all-reduces, got {out['launches']}, "
                                 f"{out['all_reduces']}")
    synchronized = (r0["launches"], r0["all_reduces"])

    ranks = _world("tp_two", 1, 2)
    r0 = ranks[0]
    again, direct = r0["norm_two_ways"]
    log(f"[33] (c) {r0['backend']} world of 2, mesh (1, 2): fc shapes a rank {r0['shapes']}; "
        f"grid max |diff| / max |grid| vs the unsharded model {r0['grid_err']:.2e}; global "
        f"gradient norm {r0['norm']:.6f} vs unsharded {r0['ref_norm']:.6f} (rel "
        f"{abs(r0['norm'] - r0['ref_norm']) / r0['ref_norm']:.2e}), float64 "
        f"{r0['norm64']:.6f}; the same clipped gradients' norm from the shards {again:.9g} "
        f"and gathered {direct:.9g}")
    for r, out in enumerate(ranks):
        log(f"[33] (c) rank {r}: step {out['ms']:.1f} ms (two ranks time-sharing one card over "
            f"gloo, not a scaling figure), peak memory {out['peak_gib']:.2f} GiB vs one "
            f"process {r0['ref_peak_gib']:.2f} GiB")
    if r0["shapes"]["head.fc_layers.1.weight"] != (2048, 50176):
        raise AssertionError(f"(c) fc1 shard {r0['shapes']['head.fc_layers.1.weight']}")
    if not r0["grid_err"] <= 1e-5:
        raise AssertionError(f"(c) the sharded grid is off by {r0['grid_err']}")
    # The norm of the same gradients, from the shards and gathered, agrees to
    # 1e-6; the sharded step's gradients differ from the unsharded step's as
    # two float32 summation orders do (fc1's input gradient is a sum of two
    # partial products), so each step's norm is held to float64's.
    off64, one64 = abs(r0["norm"] - r0["norm64"]), abs(r0["ref_norm"] - r0["norm64"])
    if not abs(again - direct) <= 1e-6 * direct or not off64 <= 2 * one64 + 1e-6 * r0["norm64"]:
        raise AssertionError(f"(c) global gradient norm {r0['norm']} (unsharded "
                             f"{r0['ref_norm']}, float64 {r0['norm64']}); {again} vs {direct}")
    return synchronized


def _task_serve_eval(mesh, device) -> dict:
    """Phase 34 on each rank: the sharded int8 engine at global batch 32
    against the default engine on the rank's 16 images, and evaluate_model
    on the mesh; rank 0 then evaluates single-process at the rank batch."""
    import torch
    import torch.distributed as dist

    from yolo_tpu_torch.data import VOC_CLASSES, encode_target
    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.metrics import evaluate_model
    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.decode import decode_predictions
    from yolo_tpu_torch.parallel import batch_slice
    from yolo_tpu_torch.serving.engine import (build_int8_predict, default_impl,
                                               gather_detections, int8_forward,
                                               make_sharded_int8_engine_fn)

    model = _int8_model()
    r = np.random.default_rng(43)
    calib = [device_normalize(torch.from_numpy(
        r.integers(0, 256, size=(8, SIZE, SIZE, 3), dtype=np.uint8)).to(device))
        for _ in range(2)]
    impl = default_impl()
    single, q = build_int8_predict(model, calib, impl=impl)
    images = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(2 * SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(device)
    with torch.inference_mode():
        grid = int8_forward(q, images[:SLICE_BATCH], S=S, impl=impl)
    thr = float(decode_predictions(grid, S, B, C, float("-inf")).scores.float().median())
    sharded = make_sharded_int8_engine_fn(mesh, S, B, C, impl=impl)
    _zero_counts()
    dets = sharded(q, images, thr, IOU_T)
    torch.cuda.synchronize()
    launches = tuple(_counts())
    ref = single(q, batch_slice(mesh, images), thr, IOU_T)
    equal = all(torch.equal(a, b) for a, b in zip(dets, ref))
    gathered = gather_detections(mesh, dets)
    serve_ms = cuda_ms(lambda: sharded(q, images, thr, IOU_T), iters=5)
    del q, single, sharded, calib

    # The detecting model (_eval_model: a dog box in every cell) on images
    # whose target is one centred dog: the middle cell's box is a TP.
    del model
    torch.cuda.empty_cache()
    model = _eval_model()
    dog = encode_target(np.array([[0.5, 0.5, BOX_W, BOX_H]], np.float32),
                        [VOC_CLASSES.index("dog")], S, B, C)
    rows = np.random.default_rng(47)
    batches = [(rows.integers(0, 256, size=(2 * SLICE_BATCH, SIZE, SIZE, 3), dtype=np.uint8),
                np.repeat(dog[None], 2 * SLICE_BATCH, axis=0)) for _ in range(2)]
    cuda_nms.LAUNCHES = 0
    keys = evaluate_model(model, _Batches(batches, 2 * SLICE_BATCH), verbose=False,
                          device=device, precise=False, mesh=mesh)
    eval_nms = cuda_nms.LAUNCHES
    out = {"launches": launches, "equal": equal, "kept": int(dets.valid.sum()),
           "gathered": tuple(gathered.valid.shape), "serve_ms": serve_ms, "keys": keys,
           "eval_nms": eval_nms, "thr": thr}
    if dist.get_rank() == 0:
        half = [(i[k:k + SLICE_BATCH], t[k:k + SLICE_BATCH]) for i, t in batches
                for k in (0, SLICE_BATCH)]
        out["ref_keys"] = evaluate_model(model, _Batches(half, SLICE_BATCH), verbose=False,
                                         device=device, precise=False)
    del model
    torch.cuda.empty_cache()
    return out


def phase_parallel_serve(card: str) -> tuple:
    """Phase 34: the sharded int8 engine and the sharded evaluator on a
    gloo (2, 1) world."""
    ranks = _world("serve_eval", 2, 1)
    for r, out in enumerate(ranks):
        log(f"[34] rank {r} ({out['backend']}, mesh (2, 1)): sharded int8 engine at global "
            f"batch {2 * SLICE_BATCH}, threshold {out['thr']:.6g}: launches (stem, int8 conv, "
            f"NMS) {out['launches']}; detections == the default engine's on its "
            f"{SLICE_BATCH} images: {out['equal']} ({out['kept']} kept); gathered "
            f"{out['gathered']}; {out['serve_ms']:.2f} ms a global batch (two ranks "
            f"time-sharing one card over gloo, not a scaling figure); evaluate_model(mesh) "
            f"fast path: NMS launches {out['eval_nms']} for 2 batches")
        if out["launches"] != (1, 58, 1) or not out["equal"]:
            raise AssertionError(f"(34) rank {r}: launches {out['launches']}, equal "
                                 f"{out['equal']}")
        if out["gathered"] != (2 * SLICE_BATCH, S * S * B) or out["eval_nms"] != 2:
            raise AssertionError(f"(34) rank {r}: gathered {out['gathered']}, NMS launches "
                                 f"{out['eval_nms']}")
        if out["keys"] != ranks[0]["ref_keys"]:
            bad = [k for k in ranks[0]["ref_keys"] if out["keys"].get(k) !=
                   ranks[0]["ref_keys"][k]]
            raise AssertionError(f"(34) rank {r}: keys differ from one process's: {bad[:5]}")
    keys = ranks[0]["ref_keys"]
    log(f"[34] evaluate_model on the mesh: all {len(keys)} keys == one process at batch "
        f"{SLICE_BATCH} on every rank (mAP50 {keys['mAP50']:.6f}, precision "
        f"{keys['precision']:.6f}, recall {keys['recall']:.6f})")
    if not keys["recall"] > 0:
        raise AssertionError("(34) the detecting model found no dog: the keys compare nothing")
    return ranks[0]["launches"], ranks[0]["eval_nms"]


def _torchrun(module: str, args: list, tag: str) -> str:
    """``torchrun --standalone --nproc-per-node 2 -m module args``; its output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", module, *args]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    if run.returncode:
        raise AssertionError(f"{tag} exited {run.returncode}:\n{run.stdout[-3000:]}\n"
                             f"{run.stderr[-3000:]}")
    log(f"[35] torchrun --nproc-per-node 2 -m {module} {' '.join(a for a in args if '/' not in a)}"
        f": {time.perf_counter() - t0:.1f} s")
    return run.stdout + run.stderr


def phase_parallel_clis() -> None:
    """Phase 35: the train CLI under torchrun on two ranks of the card (gloo):
    --mesh-data 2 --orbax-checkpoints, --resume orbax, --mesh-model 2; the
    evaluate CLI with --mesh-data 2; predict on the .pth the mesh wrote."""
    import torch

    from yolo_tpu_torch import predict

    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        tmp = Path(tmp)
        _write_voc(tmp / "voc")
        ck = tmp / "ck"
        # --batch-size 4: 2 images a rank, one step an epoch (7 images);
        # the 1-image validation batch leaves rank 1 all padding.
        base = ["--data-root", str(tmp / "voc"), "--device", "cuda", "--batch-size", "4",
                "--image-size", str(SIZE), "--num-workers", "2", "--worker-type", "thread",
                "--log-dir", str(tmp / "runs"), "--save-frequency", "100"]
        out = _torchrun("yolo_tpu_torch.train", [*base, "--checkpoint-dir", str(ck),
                                                 "--mesh-data", "2", "--orbax-checkpoints",
                                                 "--epochs", "1"], "train --mesh-data 2")
        if "backend is gloo" not in out:
            raise AssertionError("two ranks on one card must say they run gloo")
        (ck / "yolo_best.pth").unlink()
        first = torch.load(ck / "yolo_latest.pth", map_location="cpu",
                           weights_only=True)["scheduler_state_dict"]["last_epoch"]
        out = _torchrun("yolo_tpu_torch.train", [*base, "--checkpoint-dir", str(ck),
                                                 "--mesh-data", "2", "--orbax-checkpoints",
                                                 "--resume", "orbax", "--epochs", "2"],
                        "train --resume orbax")
        snaps = sorted(p.name for p in (ck / "dcp").iterdir())
        latest = torch.load(ck / "yolo_latest.pth", map_location="cpu", weights_only=True)
        steps = latest["scheduler_state_dict"]["last_epoch"]
        if "Resumed from DCP snapshot 1" not in out or snaps != ["1", "2"] \
                or latest["epoch"] != 2 or steps != 2 * first:
            raise AssertionError(f"--resume orbax: snapshots {snaps}, epoch "
                                 f"{latest['epoch']}, steps {steps}")
        log(f"[35] DCP snapshots {snaps}; yolo_latest.pth: epoch 2 after {steps} steps, "
            f"fc1 {tuple(latest['model_state_dict']['head.fc_layers.1.weight'].shape)}")
        del latest
        shutil.rmtree(ck / "dcp")
        (ck / "yolo_best.pth").unlink(missing_ok=True)
        _torchrun("yolo_tpu_torch.train", [*base, "--checkpoint-dir", str(tmp / "ck2"),
                                           "--mesh-model", "2", "--epochs", "1"],
                  "train --mesh-model 2")
        tp = torch.load(tmp / "ck2" / "yolo_latest.pth", map_location="cpu", weights_only=True)
        if tuple(tp["model_state_dict"]["head.fc_layers.1.weight"].shape) != (4096, 50176):
            raise AssertionError("--mesh-model 2 must write the unsharded fc1")
        del tp
        shutil.rmtree(tmp / "ck2")
        out = _torchrun("yolo_tpu_torch.evaluate", ["--checkpoint", str(ck / "yolo_latest.pth"),
                                                    "--data-root", str(tmp / "voc"),
                                                    "--year", "2012", "--image-set", "train",
                                                    "--batch-size", "2", "--num-workers", "0",
                                                    "--mesh-data", "2"],
                        "evaluate --mesh-data 2")
        if "mAP50:95" not in out or not (ck / "evaluation_results.txt").is_file():
            raise AssertionError("evaluate --mesh-data 2 wrote no results")
        predict.main(["--checkpoint", str(ck / "yolo_latest.pth"), "--image-dir",
                      str(tmp / "voc" / "VOCdevkit" / "VOC2007" / "JPEGImages"), "--output",
                      str(tmp / "pred"), "--conf-threshold", "0.0"])
        n_pred = len(list((tmp / "pred").iterdir()))
        if not n_pred:
            raise AssertionError("predict wrote nothing for the meshed run's .pth")
        log(f"[35] evaluate --mesh-data 2 wrote evaluation_results.txt; predict on the meshed "
            f"run's yolo_latest.pth wrote {n_pred} files")
    torch.cuda.empty_cache()


PAR_TASKS = {"ddp_one": _task_ddp_one, "dp_two": _task_dp_two, "tp_two": _task_tp_two,
             "serve_eval": _task_serve_eval}



def int8_conv_times(root: Path) -> None:
    """Device and wrapper ms of the int8 conv at every distinct geometry of
    the engine at batch 16, and their sums over all 58 convs; device ms of
    the int8 dot in the harness's five cases at M = 2^20 with torch._int_mm's;
    device ms of the Winograd conv (and of its tap pass and tap GEMM, where
    the package splits it) at the six stride-1 3x3 geometries at batch 16 and
    256 with the direct int8 conv's. All through the yolo_tpu_torch package
    of the checkout at ``root`` (an earlier commit unpacked beside this one,
    say), so that two versions of the kernels are timed the same way on one
    card."""
    sys.path.insert(0, str(root.resolve()))
    card = phase_environment()
    import torch

    from yolo_tpu_torch.experiments import mosaic_int8_dot as md
    from yolo_tpu_torch.serving import cuda_int8, cuda_wino

    for module in (cuda_int8, cuda_wino, md):
        if not Path(module.__file__).resolve().is_relative_to(root.resolve()):
            raise SystemExit(f"chip_smoke: imported {module.__file__}, not {root}'s package")
    tag = f"[times {root.resolve().name}] {card}"
    nms_stem_times(root, tag)
    times = {}
    for ci, conv in enumerate(_distinct(engine_convs(SLICE_BATCH))):
        x, wq, m, t, res, rr = _conv_operands(conv, 200 + ci)
        ops_ = (x, wq, m, t, res, rr, cuda_int8.pack_weight(wq))
        dev_ms = graph_ms(_conv_call(conv, ops_))
        wrap_ms = cuda_ms(_conv_call(conv, ops_), iters=10)
        times[_geometry(conv)] = (dev_ms, wrap_ms)
        log(f"{tag}: int8 conv {conv[0]} batch {SLICE_BATCH}: "
            f"{dev_ms:.4f} ms device, wrapper {wrap_ms:.4f} ms")
        del ops_, x, wq, res
    all58 = engine_convs(SLICE_BATCH)
    log(f"{tag}: int8 conv, all {len(all58)} convs at batch "
        f"{SLICE_BATCH}: {sum(times[_geometry(c)][0] for c in all58):.4f} ms device, "
        f"{sum(times[_geometry(c)][1] for c in all58):.4f} ms wrapper")
    g = torch.Generator(device="cuda").manual_seed(81)
    for name, (k_ms, lib_ms) in dot_device_ms(g, md.M_DEFAULT).items():
        log(f"{tag}: int8 dot {name} M = {md.M_DEFAULT}: {k_ms:.4f} ms device, torch._int_mm "
            f"{lib_ms:.4f} ms device")
    for name, h, c, k, leaky in WINO_CONVS:
        qc = {"wino": _rand_qwino(g, c, k)}
        for batch in (SLICE_BATCH, 256):
            x = torch.randint(-127, 128, (batch, h, h, c), generator=g, device="cuda",
                              dtype=torch.int8)
            dev = wino_device_ms(x, qc, leaky, events_if_uncapturable=True)
            d_ms = _direct_conv_ms(x, k, leaky, g)
            log(f"{tag}: wino {name} batch {batch}: " + ", ".join(
                f"{part} {v:.4f} ms {'wrapper' if part == 'wrapper' else 'device'}"
                for part, v in dev.items()) + f"; direct int8 conv {d_ms:.4f} ms device")
            del x
        del qc
        torch.cuda.empty_cache()
    bottleneck_times(root, tag)


def nms_stem_times(root: Path, tag: str) -> None:
    """Device ms (CUDA graphs), wrapper ms (back to back) and host us a call
    of the NMS kernel at phase 3's timed shapes and of the stem front at
    batch 1 to 256, uint8 (and float32 at batch 16), on phases 3 and 11's
    inputs, through the package of the checkout at ``root`` (imported by
    ``int8_conv_times``)."""
    import torch

    from yolo_tpu_torch.ops import cuda_nms
    from yolo_tpu_torch.ops.decode import Detections
    from yolo_tpu_torch.serving import cuda_stem

    for module in (cuda_nms, cuda_stem):
        if not Path(module.__file__).resolve().is_relative_to(root.resolve()):
            raise SystemExit(f"chip_smoke: imported {module.__file__}, not {root}'s package")
    for ci, (n, K) in enumerate(NMS_TIMED):
        gpu = Detections(*(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                           for a in _case(2000 + ci, n, K, "uniform")))
        call = lambda: cuda_nms.nms(gpu, IOU_T)  # noqa: E731
        log(f"{tag}: NMS n={n} K={K}: kernel {nms_kernel_ms(cuda_nms, gpu):.4f} ms device, "
            f"nms() {graph_ms(call, iters=50):.4f} ms device, wrapper "
            f"{cuda_ms(call, iters=200):.4f} ms, host {host_us(call):.1f} us/call")
    g = torch.Generator(device="cuda").manual_seed(42)
    s_img = torch.tensor(0.0173, dtype=torch.float32, device="cuda")
    for batch, dtype in ((1, "uint8"), (SLICE_BATCH, "uint8"), (64, "uint8"), (256, "uint8"),
                         (SLICE_BATCH, "float32")):
        t = stem_times(stem_images(g, (batch, SIZE, SIZE), dtype), s_img)
        log(f"{tag}: stem front batch {batch} {dtype}: {t['ms']:.4f} ms device "
            f"({100 * t['bound_ms'] / t['ms']:.1f}% of its {t['bound_ms']:.4f} ms bound), wrapper "
            f"{t['wrapper_ms']:.4f} ms, host {t['host_us']:.1f} us/call")
    torch.cuda.empty_cache()


def bottleneck_times(root: Path, tag: str) -> None:
    """Device ms (CUDA graphs; "wrapper" where a graph cannot capture the
    call) and wrapper ms of the fused int8 chain (#9) and identity block (#8)
    at each stage's full-width geometry at batch 16, beside the per-conv
    path on the same inputs, and of the bf16 fused bottleneck (#12) at the
    harness's layer1 geometry, through the package of the checkout at
    ``root`` (imported by ``int8_conv_times``)."""
    import torch

    from yolo_tpu_torch.experiments import fused_block_pallas as fb
    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    for module in (cb, fb):
        if not Path(module.__file__).resolve().is_relative_to(root.resolve()):
            raise SystemExit(f"chip_smoke: imported {module.__file__}, not {root}'s package")
    g = torch.Generator(device="cuda").manual_seed(52)
    for stage, h, cin, c, p, nb, ds in CHAINS:
        qbs = [_rand_qblock(g, cin if b == 0 else c, c, p, ds and b == 0) for b in range(nb)]
        ident = qbs[1] if ds else qbs[0]
        x = torch.randint(-127, 128, (SLICE_BATCH, h, h, cin), generator=g, device="cuda",
                          dtype=torch.int8)
        xi = torch.randint(-127, 128, (SLICE_BATCH, h, h, c), generator=g, device="cuda",
                           dtype=torch.int8)
        times = []
        for name, fn in (("chain", lambda: cb.chain_int8(x, qbs)),
                         ("per-conv chain", lambda: _per_conv(x, qbs)),
                         ("block", lambda: cb.block_int8(xi, ident)),
                         ("per-conv block", lambda: _per_conv(xi, [ident]))):
            ms, kind = device_or_wrapper_ms(fn)
            times.append(f"{name} {ms:.4f} ms {kind}, {cuda_ms(fn, iters=10):.4f} wrapper")
        log(f"{tag}: bottleneck {stage} batch {SLICE_BATCH} ({nb} blocks): " + "; ".join(times))
        del qbs, ident, x, xi
        torch.cuda.empty_cache()
    args = fb.random_block(fb.N, fb.H, fb.W, fb.CIN, fb.P, "cuda", seed=9)
    packed = fb.pack_weights(args[1], args[3], args[5])
    fn = lambda: fb.fused_bottleneck(*args, packed=packed)  # noqa: E731
    ms, kind = device_or_wrapper_ms(fn)
    log(f"{tag}: bf16 bottleneck b{fb.N} {fb.H}x{fb.W} {fb.CIN}/{fb.P}: {ms:.4f} ms {kind}, "
        f"{cuda_ms(fn, iters=10):.4f} wrapper")
    del args, packed
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
    kv = timed(3, phase_kernel_vs_plain, card)
    nms_ms = kv["timings"][(1, 98)]["ms"]
    engine, thr, thr_cli, launches = timed(4, phase_slice)
    timed(5, phase_entry_point, engine, thr_cli)
    timed(6, phase_timing, engine, thr, card, nms_ms)
    del engine
    torch.cuda.empty_cache()
    bn = timed(7, phase_fused_bn_kernels)
    bn_launches = timed(8, phase_train_slice)
    timed(9, phase_train_entry_points)
    timed(10, phase_train_timing, card)
    i8k = timed(11, phase_int8_kernels, card)
    engine, model, thr, i8_launches = timed(12, phase_int8_slice)
    timed(13, phase_int8_timing, engine, model, thr, card, nms_ms)
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
        "int8_dot": ("int8_conv.cu", "experiments/mosaic_int8_dot.py:55",
                     timed(21, phase_int8_dot, card)),
        "bf16_conv3x3": ("bf16_conv_stats.cu", "experiments/conv_bn_fuse_bench.py:47",
                         timed(22, phase_conv_stats, card)),
        "bf16_bottleneck": ("bf16_bottleneck.cu", "experiments/fused_block_pallas.py:31",
                            timed(23, phase_bf16_bottleneck, card)),
    }
    eval_nms, eval_launches = timed(24, lambda: (phase_eval_parity(), phase_eval_slice()))
    timed(26, phase_accuracy_gate)
    fn, q, thr = timed(27, phase_graphs, card)
    timed(28, phase_server, fn, q, thr, card)
    aot_launches = timed(36, phase_aot, fn, q, thr, card)
    del fn, q
    torch.cuda.empty_cache()
    y24_launches = timed(29, phase_yolov1_slice, card)
    timed(30, phase_yolov1_train, card)
    remat_launches = timed(31, phase_remat, card)
    quant_launches = timed(32, phase_quantized, card)
    log(f"[29-32] launches: NMS {y24_launches} a 24-conv batch; fused-BN {remat_launches} a "
        f"remat='block' fused step; int8 conv {quant_launches} a quantized ResNet50 forward")
    torch.cuda.empty_cache()
    sync_launches, sync_reduces = timed(33, phase_parallel_train, card)
    par_serve = timed(34, phase_parallel_serve, card)
    timed(35, phase_parallel_clis)
    log(f"[33-35] launches a rank: synchronized step, fused-BN {sync_launches} with "
        f"{sync_reduces} BN all-reduces; sharded engine (stem, int8 conv, NMS) "
        f"{par_serve[0]} a batch; "
        f"sharded evaluator NMS {par_serve[1]} for 2 batches")
    log(f"[36] AOT artifact launches (stem, int8 conv, NMS): {aot_launches} an eager call")
    log(f"[24] evaluator path launches: NMS {eval_nms} for {len(eval_batches())} metric "
        f"batches; CLI runs (stem, int8 conv, NMS): {eval_launches}")
    log("phase seconds: " + ", ".join(f"{k}: {v:.1f}" for k, v in seconds.items()))

    # NMS at the slice's shape (16 images, K = 98): device time from a CUDA graph.
    nt = kv["timings"][(SLICE_BATCH, 98)]
    record = {"kernels": [{
        "name": "nms",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_tpu/ops/pallas_nms.py:42",
        "launches": launches,
        "max_abs_err": kv["max_abs_err"],
        "ms": nt["ms"],
        "plain_ms": nt["plain_ms"],
        "bound_ms": nt["bound_ms"],
        "bound_by": nt["bound_by"],
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
    # The stem front at the slice's batch and wire format (16 uint8 images):
    # device time from a CUDA graph.
    st = i8k["stem"][(SLICE_BATCH, "uint8")]
    record["kernels"].append({
        "name": "quant_s2d",
        "route": "cuda",
        "source": "yolo_tpu_torch/csrc/quant_s2d.cu",
        "replaces": "yolo_tpu/serving/pallas_stem.py:38",
        "launches": i8_launches[0],
        "max_abs_err": i8k["stem_err"],
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
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
        k_ms, p_ms, b_ms, b_by = ck[key]["layer1"][:4]
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
    # The Winograd conv (tap pass + tap GEMM, device time) at head.conv1
    # (14x14, 2048 -> 1024, leaky), batch 16, launches (convs) per served
    # batch of the wino engine; no one PyTorch call computes it. Its ablation
    # modes at the same geometry, launches from the ablation's own run.
    k_ms, p_ms, b_ms, b_by = wk["conv"]["head.conv1"][:4]
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
        "library_ms": None,
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
    # fc1; the int8 dot, run by the int8 conv's kernel, at l2-im2col, device
    # times; the conv at layer3 without stats; the bottleneck at layer1);
    # launches from each harness's own run.
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
    if len(sys.argv) == 3 and sys.argv[1] == "--int8-conv-times":
        int8_conv_times(Path(sys.argv[2]))
    else:
        main()
