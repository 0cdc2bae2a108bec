"""int8 serving engine variants on the card: ``python -m yolo_tpu_torch.bench_int8``.

Port of tools/bench_int8.py. Times the whole serving call (forward + decode
+ NMS) of the full-width ResNet50 YOLOv1 at 448x448 on seeded uint8 images
already on the card, with CUDA events (utils/timing.py), per variant:

- ``fp32``: the exact engine, ``YOLOInference`` (JAX's ``bf16``);
- ``int8``: the int8 engine under ``default_impl()``, as served;
- ``int8-eager``: the int8 engine with ``impl={}``, the stem front in eager
  torch (JAX's ``int8-xla``);
- ``stem-direct``: the int8 engine with the direct 7x7 stem;
- ``chain``: the int8 engine with the fused stage chains
  (``cuda_bottleneck.chain_int8``) on ``--chain-stages`` (JAX's ``pallas``);
- ``wino``: the int8 engine with the per-tap Winograd convs
  (``serving/winograd.py``, kernel ``csrc/int8_wino.cu``), one engine per
  ``;``-separated conv list of ``--wino-spec``.

Weights are random from a seed; the int8 engine calibrates on the first 64
images of the batch. Each variant prints ms per batch and img/s with the
card's name. Refused, with the reason: ``colpack``, ``retile`` and ``t2``
(XLA:TPU reformulations of a conv that the port's int8 conv kernel runs
directly).
"""

from __future__ import annotations

import argparse

SIZE = 448
VARIANTS = ("fp32", "int8", "int8-eager", "stem-direct", "chain", "wino")
WINO_SPEC = "head_conv1;head_conv1,head_conv3,head_conv4"  # tools/bench_int8.py's
REFUSED = {
    "colpack": "an XLA:TPU reformulation of the stride-2 conv2 (column pairs packed into "
               "channels); the port's int8 conv kernel runs that conv directly",
    "retile": "an XLA:TPU reformulation of the stride-1 3x3 conv (batch-folded tiles); the "
              "port's int8 conv kernel runs that conv directly",
    "t2": "the TPU's dense-dot stride-2 conv2 kernel; the port's int8 conv kernel, which "
          "replaces it, runs every int8 conv already (variant int8)",
}


def _variants(spec: str) -> list:
    names = [v for v in spec.split(",") if v]
    for v in names:
        if v in REFUSED:
            raise SystemExit(f"bench_int8: variant {v!r} refused: {REFUSED[v]}")
        if v not in VARIANTS:
            raise SystemExit(f"bench_int8: unknown variant {v!r}; choose from "
                             f"{', '.join(VARIANTS)}")
    return names


def _wino_specs(spec: str) -> list:
    """``"a;b,c"`` -> [("a",), ("b", "c")]; raises SystemExit on a name that is
    not a stride-1 3x3 conv."""
    from yolo_tpu_torch.serving.winograd import check_points

    specs = [tuple(n for n in part.split(",") if n) for part in spec.split(";") if part]
    try:
        for names in specs:
            check_points(names, (3, 4, 6, 3))
    except ValueError as e:
        raise SystemExit(f"bench_int8: --wino-spec: {e}") from None
    return specs


def run(batch: int, variants, chain_stages=(1, 2, 3), iters: int = 4,
        device: str = "cuda", wino_specs=None) -> dict:
    """{variant: ms per batch} on the card; prints one line per variant."""
    import numpy as np
    import torch

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.serving.cuda_bottleneck import chain_int8
    from yolo_tpu_torch.serving.engine import build_int8_predict, default_impl, make_int8_engine_fn
    from yolo_tpu_torch.utils.timing import device_time_ms

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("bench_int8: needs a CUDA device (times are taken with CUDA events)")
    wino_specs = wino_specs or _wino_specs(WINO_SPEC)
    model = create_model("resnet", 20, 7, 2, device=dev, image_size=SIZE,
                         generator=torch.Generator(device=dev).manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(batch, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)
    calib = [device_normalize(images[:64])]
    card = torch.cuda.get_device_name(0)

    engines = {}
    q_s2d = None
    for name in variants:
        if name == "wino":
            for spec in wino_specs:
                fn, q = build_int8_predict(model, calib, impl=default_impl(), wino=spec)
                engines[f"wino({','.join(spec)})"] = lambda fn=fn, q=q: fn(q, images, 0.25, 0.4)
            continue
        if name == "fp32":
            fp32 = YOLOInference(model, dev, image_size=SIZE)
            engines[name] = lambda: fp32.predict_batch_arrays(images, 0.25, 0.4)
            continue
        if name == "stem-direct":
            fn, q = build_int8_predict(model, calib, impl=default_impl(), stem_mode="direct")
        else:
            if q_s2d is None:
                _, q_s2d = build_int8_predict(model, calib)
            impl = {} if name == "int8-eager" else default_impl()
            if name == "chain":
                impl.update({f"layer{s}": chain_int8 for s in chain_stages})
            fn, q = make_int8_engine_fn(7, 2, 20, impl=impl), q_s2d
        engines[name] = lambda fn=fn, q=q: fn(q, images, 0.25, 0.4)

    results = {}
    for name, call in engines.items():
        ms = device_time_ms(call, iters=iters, warmup=2)
        results[name] = ms
        stages = f" (stages {','.join(map(str, chain_stages))})" if name == "chain" else ""
        print(f"{name}{stages}: {ms:.3f} ms/batch, {batch * 1000.0 / ms:.1f} img/s at batch "
              f"{batch}, {SIZE}x{SIZE} uint8 on the card, CUDA events over {iters} calls; "
              f"{card}", flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--variants", default="fp32,int8,chain",
                   help=f"comma-separated, from {', '.join(VARIANTS)}")
    p.add_argument("--chain-stages", default="1,2,3",
                   help="stages whose stride-1 blocks run as one fused chain launch")
    p.add_argument("--wino-spec", default=WINO_SPEC,
                   help="for variant wino: ';'-separated engines, each a ','-separated list of "
                        "stride-1 3x3 convs (l{s}b{b}_conv2, head_conv1/3/4)")
    p.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = p.parse_args(argv)
    variants = _variants(args.variants)
    wino_specs = _wino_specs(args.wino_spec)
    stages = tuple(int(s) for s in args.chain_stages.split(",") if s)
    if not set(stages) <= {1, 2, 3, 4}:
        raise SystemExit(f"bench_int8: --chain-stages must name stages 1-4, got {stages}")
    run(args.batch, variants, stages, args.iters, args.device, wino_specs)


if __name__ == "__main__":
    main()
