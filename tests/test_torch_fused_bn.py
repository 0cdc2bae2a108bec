"""The port's fused BN against JAX's Pallas kernels (interpret mode on the CPU).

On CPU tensors the port's wrappers run the kernels' plain twins; JAX runs
``yolo_tpu/ops/fused_bn.py`` in interpret mode (it picks that off a TPU).
Both get the same numpy inputs.

Tolerances: the twins evaluate the JAX kernels' float32 expressions in the
same order (the affine ``x*mul + add``, the bf16 rounding before the
residual add, the ``out > 0`` masks); only the per-channel sums run in
another order. So float32 results agree to rtol 1e-5 with atol 1e-5 of the
largest value (the backward's ``A*gz - (B*x - D)`` cancels, so a small dx
carries the absolute error of a large term), and a bfloat16 result to one
bf16 ulp (rtol and atol 2**-7 of the largest value), where a last-bit
difference in float32 rounds the other way.

The modules: ``Bottleneck`` and ``ResNetBackbone(stage_sizes=(1, 1))`` in
train mode, unfused, ``"stats"`` and ``"full"``, on weights carried by
``backbone_state_dict_from_jax``: outputs, loss, every parameter gradient and
the running statistics. F1: torch's running_var takes the unbiased batch
variance, flax's the biased one, so the port's update equals JAX's scaled
by exactly M/(M-1), for the fused and the ``nn.BatchNorm2d`` path alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.models.backbones import Bottleneck as JBottleneck
from yolo_tpu.models.backbones import ResNetBackbone as JResNet
from yolo_tpu.models.layers import BatchNorm as JBatchNorm
from yolo_tpu.models.layers import FusedBatchNormAct as JFusedBN
from yolo_tpu.ops.fused_bn import bn_normalize as jax_normalize
from yolo_tpu.ops.fused_bn import bn_stats as jax_stats
from yolo_tpu.ops.fused_bn import fused_bn_act as jax_fused
from yolo_tpu_torch.convert import backbone_state_dict_from_jax, block_state_dict_from_jax
from yolo_tpu_torch.models import Bottleneck, ResNetBackbone
from yolo_tpu_torch.models.layers import FusedBatchNormAct, batch_norm
from yolo_tpu_torch.ops import fused_bn as fb

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2.0**-7)}


def _np(t):
    return np.array(t, np.float32)


def _close(got, ref, tol, what):
    ref = _np(ref)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max() + 1e-30,
                               err_msg=what)


def _nchw(a, dtype):
    """NHWC numpy -> NCHW torch tensor of ``dtype`` (bf16 from the same bits as JAX's)."""
    return torch.from_numpy(_np(a)).permute(0, 3, 1, 2).to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("c", [64, 256])  # JAX's nmin (C < 128) and cmin layouts
def test_twins_and_functions_match_jax_kernels(c, res, relu, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    r = np.random.default_rng(c + 2 * res + relu)
    shape = (2, 4, 4, c)
    x = jnp.asarray(r.normal(1.0, 2.0, size=shape).astype(np.float32), jdt)
    resid = jnp.asarray(r.normal(size=shape).astype(np.float32), jdt) if res else None
    g = jnp.asarray(r.normal(size=shape).astype(np.float32), jdt)
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = r.normal(0.0, 0.1, c).astype(np.float32)
    mul = r.uniform(0.5, 1.5, c).astype(np.float32)
    add = r.normal(0.0, 0.5, c).astype(np.float32)

    @jax.jit
    def ref_fn(x, scale, bias, resid):
        (out, mean, var), vjp = jax.vjp(
            lambda x, s, b, rr: jax_fused(x, s, b, residual=rr, relu=relu), x, scale, bias, resid)
        grads = vjp((g, jnp.zeros_like(mean), jnp.zeros_like(var)))
        return (out, mean, var, grads, jax_stats(x),
                jax_normalize(x, jnp.asarray(mul), jnp.asarray(add), resid, relu))

    out, mean, var, grads, stats, norm = ref_fn(x, jnp.asarray(scale), jnp.asarray(bias), resid)

    tx = _nchw(x, tdt)
    tres = _nchw(resid, tdt) if res else None
    # The bare wrappers (twins on the CPU) against bn_stats and bn_normalize.
    t_mean, t_var = fb.bn_stats(tx)
    _close(t_mean, stats[0], 1e-5, "bn_stats mean")
    _close(t_var, stats[1], 1e-5, "bn_stats var")
    t_norm = fb.bn_normalize(tx, torch.from_numpy(mul), torch.from_numpy(add), tres, relu)
    assert t_norm.dtype == tdt
    _close(t_norm.permute(0, 2, 3, 1), norm, tol, "bn_normalize")

    # The autograd Function against fused_bn_act and its custom VJP.
    args = [tx.clone().requires_grad_(), torch.from_numpy(scale).requires_grad_(),
            torch.from_numpy(bias).requires_grad_()]
    if res:
        args.append(tres.clone().requires_grad_())
    t_out, t_m, t_v = fb.fused_bn_act(*args[:3], args[3] if res else None, relu)
    (t_out.float() * _nchw(g, tdt).float()).sum().backward()
    assert t_out.dtype == tdt
    _close(t_out.permute(0, 2, 3, 1), out, tol, "out")
    _close(t_m, mean, 1e-5, "mean")
    _close(t_v, var, 1e-5, "var")
    names = ("dx", "dscale", "dbias", "dres")
    for name, got, want in zip(names, [a.grad for a in args], grads):
        if name in ("dx", "dres"):
            assert got.dtype == tdt
            got = got.permute(0, 2, 3, 1)
        _close(got, want, tol if name in ("dx", "dres") else 1e-5 if dtype == "f32" else 1e-4,
               name)


def _grads_and_stats(module, variables, x):
    def loss(params):
        out, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x, True, mutable=["batch_stats"])
        return jnp.mean(out.astype(jnp.float32) ** 2), (out, mut["batch_stats"])

    (value, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return float(value), np.asarray(out), grads, stats


def _bn_rows(model):
    """Rows M = N*H*W seen by each BN layer in the last forward, by state-dict prefix."""
    rows = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: rows.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    return rows


MODULES = {
    "bottleneck": (lambda fused: JBottleneck(planes=16, stride=2, downsample=True,
                                             fused_bn=fused),
                   lambda fused: Bottleneck(64, 16, 2, True, device="cpu", fused_bn=fused),
                   block_state_dict_from_jax, (2, 8, 8, 64)),
    "resnet_1_1": (lambda fused: JResNet(stage_sizes=(1, 1), fused_bn=fused),
                   lambda fused: ResNetBackbone((1, 1), device="cpu", fused_bn=fused),
                   backbone_state_dict_from_jax, (2, 32, 32, 3)),
}


@pytest.mark.parametrize("name,fused", [("bottleneck", False), ("bottleneck", "stats"),
                                        ("bottleneck", "full"), ("resnet_1_1", "stats"),
                                        ("resnet_1_1", "full")])
def test_modules_match_jax_in_train_mode(name, fused):
    make_jax, make_port, convert, shape = MODULES[name]
    r = np.random.default_rng(3)
    x = r.normal(size=shape).astype(np.float32)
    jmod = make_jax(fused)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(4), jnp.asarray(x), False))
    # Non-trivial BN affine parameters, so the BN arithmetic matters.
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (r.uniform(0.5, 1.5, v.shape).astype(np.float32)
                      if "scale" in jax.tree_util.keystr(p) else v), variables)
    value, out, grads, new_stats = _grads_and_stats(jmod, variables, jnp.asarray(x))

    port = make_port(fused)
    port.load_state_dict(convert(variables["params"], variables["batch_stats"]))
    port.train()
    rows = _bn_rows(port)
    y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    t_loss = (y.float() ** 2).mean()
    t_loss.backward()

    atol = 1e-4 * np.abs(out).max()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), out, rtol=1e-4,
                               atol=atol)
    np.testing.assert_allclose(float(t_loss.detach()), value, rtol=1e-4)
    want = convert(jax.tree.map(np.asarray, grads), None)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-8,
                                   err_msg=k)

    # Running statistics: mean as JAX's, var JAX's scaled by M/(M-1) (F1).
    ref = convert(variables["params"], jax.tree.map(np.asarray, new_stats))
    sd = port.state_dict()
    assert set(rows) and all(f"{p}.running_var" in sd for p in rows)
    for prefix, m in rows.items():
        np.testing.assert_allclose(sd[f"{prefix}.running_mean"].numpy(),
                                   ref[f"{prefix}.running_mean"].numpy(), rtol=1e-5, atol=1e-6)
        jax_delta = ref[f"{prefix}.running_var"].numpy() - 0.9
        np.testing.assert_allclose(sd[f"{prefix}.running_var"].numpy() - 0.9,
                                   jax_delta * m / (m - 1), rtol=1e-4, atol=1e-7,
                                   err_msg=prefix)
        assert int(sd[f"{prefix}.num_batches_tracked"]) == 1


@pytest.mark.parametrize("mode", [False, "stats", "full"])
def test_running_var_is_torch_unbiased_f1(mode):
    """F1 on one BN layer: port - 0.9*old == (JAX - 0.9*old) * M/(M-1) exactly
    up to float32 rounding, for the nn.BatchNorm2d path and both fused modes."""
    c, shape = 64, (3, 5, 6, 64)
    x = np.random.default_rng(8).normal(0.5, 2.0, size=shape).astype(np.float32)
    old_var = np.random.default_rng(9).uniform(0.5, 1.5, c).astype(np.float32)
    jmod = JBatchNorm() if mode is False else JFusedBN(relu=False, mode=mode)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    variables["batch_stats"]["BatchNorm_0"]["var"] = old_var
    _, mut = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    jax_var = np.asarray(mut["batch_stats"]["BatchNorm_0"]["var"])

    bn = batch_norm(c, device="cpu") if mode is False else FusedBatchNormAct(c, False, mode)
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.copy_(torch.from_numpy(old_var))
    bn.train()
    bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    m = shape[0] * shape[1] * shape[2]
    got = bn.running_var.numpy() - 0.9 * old_var
    want = (jax_var - 0.9 * old_var) * (m / (m - 1))
    np.testing.assert_allclose(got, want, rtol=2e-6)
    # ... and not the biased update JAX makes.
    assert np.abs(got - (jax_var - 0.9 * old_var)).min() > 1e-4 * np.abs(want).min()


def test_fused_layer_keeps_batchnorm2d_state_and_eval_order():
    fused = FusedBatchNormAct(8, relu=True, mode="full")
    plain = batch_norm(8, device="cpu")
    assert isinstance(fused, torch.nn.BatchNorm2d)
    assert list(fused.state_dict()) == list(plain.state_dict())
    r = np.random.default_rng(2)
    with torch.no_grad():
        for t in (fused.weight, fused.bias, fused.running_mean):
            t.copy_(torch.from_numpy(r.normal(size=8).astype(np.float32)))
        fused.running_var.copy_(torch.from_numpy(r.uniform(0.5, 2, 8).astype(np.float32)))
    plain.load_state_dict(fused.state_dict())
    fused.eval(), plain.eval()
    x = torch.from_numpy(r.normal(size=(2, 8, 3, 3)).astype(np.float32))
    res = torch.from_numpy(r.normal(size=(2, 8, 3, 3)).astype(np.float32))
    torch.testing.assert_close(fused(x, res), torch.relu(plain(x) + res), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        FusedBatchNormAct(8, mode="bogus")
