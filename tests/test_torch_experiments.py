"""The twins of the four ported experiments/ kernels held against the JAX harnesses.

Inputs are made with numpy from seeds and go through the JAX files under
experiments/ (loaded by path; their Pallas kernels run in interpret mode)
and through the port's plain twins in yolo_tpu_torch/experiments/:

- #11 ``plain_update`` against ``pallas_update(interpret=True)`` and
  ``xla_update`` at rtol 1e-6, atol 1e-7 (not bit for bit: JAX's two paths
  already differ from each other by ~1e-7 in v), and ``check_vs_torch_adam``
  on the CPU;
- #12 ``reference`` against ``fused_bottleneck(TH=16, interpret=True)``
  within one bf16 ulp of max|ref|;
- #13 ``int8_dot_reference`` against the TPU kernel's body, bit for bit;
- #14 ``conv3x3_bf16_reference`` against ``build(...)``'s kernel in
  interpret mode, y within one bf16 ulp of max|ref|, the sums within 1e-5 of
  sum|acc| (of sum acc^2 for the sum of squares);

and the wrappers refuse CPU tensors, the harnesses refuse to run without a
card, and the packers lay the weights out as the kernels read them.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu_torch.experiments import bf16_ulp
from yolo_tpu_torch.experiments import conv_bn_fuse_bench as cb
from yolo_tpu_torch.experiments import fused_block_pallas as fb
from yolo_tpu_torch.experiments import mosaic_int8_dot as md
from yolo_tpu_torch.experiments import opt_update_microbench as om

REPO = Path(__file__).resolve().parents[1]


def _load_jax_experiment(name):
    """experiments/<name>.py as a module. Two of the files set JAX's
    compilation cache directory when imported; the setting is restored."""
    saved = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_jax_experiment_{name}",
                                                  REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    return mod


def _bf16(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


# ------------------------------------------------------------ #11 Adam update
@pytest.mark.parametrize("path", ["pallas", "xla"])
def test_adam_twin_matches_jax(path):
    jom = _load_jax_experiment("opt_update_microbench")
    r = np.random.default_rng(11)
    p, m, v, g = (r.standard_normal((512, 256), dtype=np.float32) for _ in range(4))
    v = np.abs(v)
    s, c1, c2, lr = (np.float32(x) for x in (0.37, 1.0 / (1 - 0.9**8), 1.0 / (1 - 0.999**8),
                                              1e-4))
    args = [jnp.asarray(a) for a in (p, m, v, g)] + [jnp.float32(x) for x in (s, c1, c2, lr)]
    if path == "pallas":
        want = jom.pallas_update(*args, bm=16, interpret=True)
    else:
        want = jom.xla_update(*args)
    scalars = torch.tensor([s, c1, c2, lr], dtype=torch.float32)
    got = om.plain_update(*(torch.from_numpy(a) for a in (p, m, v, g)), scalars)
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)


def test_adam_twin_matches_torch_adam_on_the_cpu():
    assert om.check_vs_torch_adam() < 1e-6


def test_bias_scalars_order():
    sc = om.bias_scalars(torch.tensor(0.25), 3, 2e-4, "cpu")
    want = [0.25, 1 / (1 - 0.9**3), 1 / (1 - 0.999**3), 2e-4]
    assert sc.dtype == torch.float32 and sc.shape == (4,)
    np.testing.assert_array_equal(sc.numpy(), np.float32(want))


# --------------------------------------------------------- #13 int8 dot + requant
def _jax_int8_dot_body(a, w, m):
    """The TPU kernel's body, experiments/mosaic_int8_dot.py:55-61 (a closure
    inside main(), so restated here) on whole arrays."""
    acc = jax.lax.dot_general(a, w, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * m
    return jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8)


@pytest.mark.parametrize("case", md.CASES, ids=lambda c: c[0])
def test_int8_dot_twin_equals_jax_bit_for_bit(case):
    _, K, N = case
    r = np.random.default_rng(K)
    a = r.integers(-127, 128, size=(64, K), dtype=np.int8)
    w = r.integers(-127, 128, size=(K, N), dtype=np.int8)
    m = (r.uniform(0.5, 1.5, (1, N)) * (2e-2 / np.sqrt(K))).astype(np.float32)
    want = np.asarray(_jax_int8_dot_body(jnp.asarray(a), jnp.asarray(w), jnp.asarray(m)))
    got = md.int8_dot_reference(*(torch.from_numpy(x) for x in (a, w, m))).numpy()
    assert 0 < int((np.abs(want) == 127).sum()) < want.size  # the clips and the interior
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ #14 conv3x3 + BN stats
@pytest.mark.parametrize("stats", [False, True], ids=["conv", "conv_stats"])
def test_conv3x3_twin_matches_jax_kernel(stats):
    jcb = _load_jax_experiment("conv_bn_fuse_bench")
    n, h, c, k = 2, 8, 16, 16
    r = np.random.default_rng(14)
    xj, xt = _bf16(r.standard_normal((n, h, h, c), dtype=np.float32))
    wj, wt = _bf16(r.standard_normal((9, c, k), dtype=np.float32) / np.sqrt(9 * c))
    pallas_conv = jcb.build(H=h, C=c, K=k, batch=n, img_chunk=1, interpret=True)
    y_j, s_j = pallas_conv(xj, wj, stats=stats)
    y, s = cb.conv3x3_bf16_reference(xt, wt, stats=stats)
    y_j = np.asarray(y_j.astype(jnp.float32))
    assert y.shape == y_j.shape == (n, h, h, k) and y.dtype == torch.bfloat16
    assert np.abs(y.float().numpy() - y_j).max() <= bf16_ulp(np.abs(y_j).max())
    if stats:
        acc = cb.conv3x3_acc_reference(xt, wt).double()
        scale = torch.stack([acc.abs().sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))]).numpy()
        assert (np.abs(s.numpy() - np.asarray(s_j, np.float64)) <= 1e-5 * scale).all()
    else:
        assert s is None


# --------------------------------------------------- #12 bf16 fused bottleneck
@pytest.mark.parametrize("h", [32, 48])
def test_bottleneck_twin_matches_jax_kernel(h):
    jfb = _load_jax_experiment("fused_block_pallas")
    n, w, cin, p = 1, 8, 32, 16
    r = np.random.default_rng(h)
    arrays = [(r.normal(size=(n, h, w, cin)) * 0.5, True),
              (r.normal(size=(cin, p)) * (2 / cin) ** 0.5, True),
              (r.normal(size=(p,)) * 0.1, False),
              (r.normal(size=(3, 3, p, p)) * (2 / (9 * p)) ** 0.5, True),
              (r.normal(size=(p,)) * 0.1, False),
              (r.normal(size=(p, cin)) * (2 / p) ** 0.5, True),
              (r.normal(size=(cin,)) * 0.1, False)]
    jargs, targs = [], []
    for a, is_bf16 in arrays:
        a = a.astype(np.float32)
        if is_bf16:
            j, t = _bf16(a)
        else:
            j, t = jnp.asarray(a), torch.from_numpy(a)
        jargs.append(j)
        targs.append(t)
    want = np.asarray(jfb.fused_bottleneck(*jargs, TH=16, interpret=True).astype(jnp.float32))
    got = fb.reference(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cin)
    assert np.abs(got.float().numpy() - want).max() <= bf16_ulp(np.abs(want).max())


# ------------------------------------------------------------ wrappers, harnesses
def _cpu_calls():
    z = torch.zeros
    return {
        "cuda_update": lambda: om.cuda_update(z(4, 4), z(4, 4), z(4, 4), z(4, 4), z(4)),
        "int8_dot": lambda: md.int8_dot(z((8, 4), dtype=torch.int8), z((4, 2), dtype=torch.int8),
                                        z(2)),
        "conv3x3_bf16": lambda: cb.conv3x3_bf16(z((1, 4, 4, 8), dtype=torch.bfloat16),
                                                z((9, 8, 8), dtype=torch.bfloat16)),
        "fused_bottleneck": lambda: fb.fused_bottleneck(*fb.random_block(1, 4, 4, 16, 16, "cpu")),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_wrappers_refuse_cpu_tensors(name):
    with pytest.raises(ValueError, match="lies on cpu"):
        _cpu_calls()[name]()


@pytest.mark.parametrize("module", [om, md, cb, fb], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_harnesses_need_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        module.main([])


def test_packed_layouts():
    r = np.random.default_rng(3)
    w = torch.from_numpy(r.integers(-127, 128, size=(300, 6), dtype=np.int8))
    wk = md.pack_weight(w)
    assert wk.shape == (6, 320) and torch.equal(wk[:, :300], w.t()) and not wk[:, 300:].any()
    w9 = torch.from_numpy(r.standard_normal((9, 16, 8), dtype=np.float32)).to(torch.bfloat16)
    wk = cb.pack_weight(w9)  # row k: (tap, c) contiguous, 144 -> 160
    assert wk.shape == (8, 160) and not wk[:, 144:].any()
    assert torch.equal(wk[3, 2 * 16 + 5], w9[2, 5, 3])
    _, w1, _, w2, _, w3, _ = fb.random_block(1, 2, 2, 48, 16, "cpu")
    p1, p2, p3 = fb.pack_weights(w1, w2, w3)
    assert (p1.shape, p2.shape, p3.shape) == ((16, 64), (16, 160), (48, 32))
    assert torch.equal(p1[:, :48], w1.t()) and torch.equal(p3[:, :16], w3.t())
    assert torch.equal(p2[7, (1 * 3 + 2) * 16 + 4], w2[1, 2, 4, 7])


def test_work_counts_at_the_harness_geometries():
    # The bounds of PERF.md's kernel table follow from these.
    assert om.work(om.ROWS, om.COLS)[1] == 7 * 4 * 50176 * 4096  # 5.75 GB
    ops, n_bytes = md.work(md.M_DEFAULT, 1152, 128)
    assert ops == 2 * 2**20 * 1152 * 128 and round(n_bytes / 1e9, 2) == 1.34
    flops, n_bytes = cb.work(128, 28, 256, 256)
    assert round(flops / 1e9, 1) == 118.4 and round(n_bytes / 1e9, 2) == 0.10
    flops, n_bytes = fb.work(fb.N, fb.H, fb.W, fb.CIN, fb.P)
    assert round(flops / 1e9) == 112 and round(n_bytes / 1e9, 2) == 0.82
