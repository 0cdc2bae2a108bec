"""The Adam parameter update on the card: ``python -m yolo_tpu_torch.experiments.opt_update_microbench``

Port of experiments/opt_update_microbench.py. The TPU kernel
``_adam_kernel`` (entry ``pallas_update``) becomes ``csrc/adam_update.cu``
(``yolo_adam_update``): the production chain's per-leaf math (clip scale +
L2 weight decay + Adam with bias correction) in one pass, in place on p, m
and v.

- :func:`cuda_update` is the wrapper: CUDA tensors only, it launches the
  kernel or raises;
- :func:`plain_update` is its twin, JAX's ``xla_update`` in torch, one
  rounding a step, so the kernel equals it bit for bit;
- :func:`check_vs_torch_adam` holds either against a step of the port's
  own optimizer (``training/optim.make_optimizer`` + ``clip_grad_norm_``);
- :func:`run` times the kernel, the twin, ``torch.optim.Adam(fused=True)``
  and ``torch.optim.Adam(foreach=True)`` (the library yardsticks, timed here
  and used nowhere in the port) on one fc1-shaped tensor with CUDA events,
  the state chained through the iterations as a train loop chains it.

Every variant moves 4 reads + 3 writes of float32 per element: 5.75 GB at
(50176, 4096), 1.72 ms at an H100's 3.35 TB/s. The port's ``Trainer`` keeps
``torch.optim.Adam``; nothing here changes it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

#: Kernel launches since the count was last reset (set it to 0 to reset).
LAUNCHES = 0

# experiments/opt_update_microbench.py:53 (the reference recipe's Adam + L2).
B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 5e-4
ROWS, COLS = 50176, 4096  # fc1's weight


def bias_scalars(s, t: int, lr: float, device) -> torch.Tensor:
    """The kernel's (4,) float32 scalars: clip scale ``s`` (a float or a 0-dim
    tensor, left on the device), c1 = 1/(1 - B1^t), c2 = 1/(1 - B2^t), lr."""
    rest = torch.tensor([1.0 / (1.0 - B1**t), 1.0 / (1.0 - B2**t), lr], dtype=torch.float32,
                        device=device)
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(1)
    return torch.cat([s, rest])


# ------------------------------------------------------------------ twin
def plain_update(p, m, v, g, scalars) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """New (p, m, v): JAX's ``xla_update`` (experiments/opt_update_microbench.py:56-62)
    in torch, each operation rounded on its own, in the kernel's order."""
    s, c1, c2, lr = scalars.unbind(0)
    g = g * s + WD * p
    m = B1 * m + (1.0 - B1) * g
    v = B2 * v + (1.0 - B2) * g * g
    p = p - lr * (m * c1) / (torch.sqrt(v * c2) + EPS)
    return p, m, v


# ------------------------------------------------------------------ kernel
def _check(p, m, v, g, scalars) -> None:
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.device.type != "cuda":
            raise ValueError(f"cuda_update: {name} lies on {t.device}; the kernel takes CUDA "
                             f"tensors (the plain twin is plain_update)")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != p.shape:
            raise ValueError(f"cuda_update: {name} must be contiguous float32 of p's shape "
                             f"{tuple(p.shape)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != p.device or t.data_ptr() % 16:
            raise ValueError(f"cuda_update: {name} must be 16-byte aligned on p's device")
    if scalars.device != p.device or scalars.dtype != torch.float32 or \
            tuple(scalars.shape) != (4,) or not scalars.is_contiguous():
        raise ValueError(f"cuda_update: scalars must be a contiguous (4,) float32 tensor on "
                         f"p's device, got {scalars.dtype} {tuple(scalars.shape)} on "
                         f"{scalars.device}")


def cuda_update(p, m, v, g, scalars) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One clip + L2 + Adam step of ``csrc/adam_update.cu``, in place on p, m, v
    (returned). ``scalars``: (4,) float32 on the card = s, c1, c2, lr."""
    global LAUNCHES
    from yolo_tpu_torch.utils import kernels

    _check(p, m, v, g, scalars)
    lib = kernels.load()
    with torch.cuda.device(p.device):
        code = lib.yolo_adam_update(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                                    scalars.data_ptr(), p.numel(),
                                    torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "yolo_adam_update launch")
    LAUNCHES += 1
    return p, m, v


def work(rows: int, cols: int) -> Tuple[int, int]:
    """(flops, device-memory bytes) of one update: ~20 flops and 4 reads + 3
    writes of float32 per element."""
    n = rows * cols
    return 20 * n, 7 * 4 * n


# ------------------------------------------------------------------ checks
def check_vs_torch_adam(rows: int = 512, cols: int = 256, step: int = 7,
                        device: str = "cpu") -> float:
    """Hold the kernel (on a CUDA device) or the twin (on the CPU) against
    step ``step + 1`` of the port's Adam (experiments/opt_update_microbench.py:
    101-135 against optax). Returns the largest |difference| of p; raises
    past rtol 1e-6, atol 1e-7. torch's Adam orders its arithmetic otherwise
    (``m / bc1``, ``sqrt(v) / sqrt(bc2)``), hence a tolerance."""
    import numpy as np

    from yolo_tpu_torch.training.optim import make_optimizer

    dev = torch.device(device)
    r = np.random.default_rng(0)
    p0 = torch.from_numpy(r.standard_normal((rows, cols), dtype=np.float32)).to(dev)
    g = torch.from_numpy(r.standard_normal((rows, cols), dtype=np.float32) * 3).to(dev)
    holder = torch.nn.ParameterDict({"w": torch.nn.Parameter(p0.clone())})
    w = holder["w"]
    opt, schedule = make_optimizer(holder, lr=1e-4, weight_decay=WD)

    def torch_step():
        w.grad = g.clone()
        torch.nn.utils.clip_grad_norm_([w], 10.0)
        opt.step()
        schedule.step()

    for _ in range(step):
        torch_step()
    state = opt.state[w]
    m, v = state["exp_avg"].clone(), state["exp_avg_sq"].clone()
    p = w.detach().clone()
    # clip_grad_norm_'s coefficient, kept on the device.
    s = torch.clamp(10.0 / (torch.linalg.vector_norm(g) + 1e-6), max=1.0)
    scalars = bias_scalars(s, step + 1, opt.param_groups[0]["lr"], dev)
    torch_step()
    update = cuda_update if dev.type == "cuda" else plain_update
    got = update(p, m, v, g, scalars)[0]
    torch.testing.assert_close(got, w.detach(), rtol=1e-6, atol=1e-7)
    return float((got - w.detach()).abs().max())


# ------------------------------------------------------------------ timing
def run(rows: int = ROWS, cols: int = COLS, iters: int = 8, device: str = "cuda") -> dict:
    """{variant: ms} on the card, by CUDA events; prints one line each."""
    from yolo_tpu_torch.utils.timing import device_time_ms

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("opt_update_microbench: needs a CUDA device (times are taken with "
                         "CUDA events)")
    err = check_vs_torch_adam(device=device)
    card = torch.cuda.get_device_name(dev)
    print(f"correctness vs torch.optim.Adam + clip_grad_norm_ (step 8): max |dp| {err:.3e} "
          f"(rtol 1e-6, atol 1e-7); {card}", flush=True)
    shape = (rows, cols)
    gen = torch.Generator(device=dev).manual_seed(1)

    def fresh():
        return [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]

    _, n_bytes = work(rows, cols)
    gb = n_bytes / 1e9
    scalars = torch.tensor([0.5, 1.1, 1.001, 1e-4], dtype=torch.float32, device=dev)
    results = {}

    def report(name, ms, note=""):
        results[name] = ms
        print(f"{name:12s} {shape} update: {ms:8.4f} ms {gb / (ms / 1e3):7.1f} GB/s "
              f"({gb:.2f} GB moved: 4 reads + 3 writes of float32{note}); {card}", flush=True)

    p, m, v, g = fresh()
    m.abs_()
    v.abs_()
    report("cuda_update", device_time_ms(cuda_update, p, m, v, g, scalars, iters=iters))
    state = [p, m, v]

    def plain_chained():
        state[:] = plain_update(*state, g, scalars)

    report("plain_update", device_time_ms(plain_chained, iters=iters))
    del p, m, v, g, state

    for name, kw in (("adam_fused", {"fused": True}), ("adam_foreach", {"foreach": True})):
        p, _, _, g = fresh()
        param = torch.nn.Parameter(p)
        param.grad = g
        opt = torch.optim.Adam([param], lr=1e-4, betas=(B1, B2), eps=EPS, weight_decay=WD, **kw)
        report(name, device_time_ms(opt.step, iters=iters),
               "; torch's Adam has no clip scale, the same bytes")
        del p, g, param, opt
    torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--cols", type=int, default=COLS)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = p.parse_args(argv)
    return run(args.rows, args.cols, args.iters, args.device)


if __name__ == "__main__":
    main()
