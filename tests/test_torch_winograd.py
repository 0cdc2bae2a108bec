"""The port's per-tap int8 Winograd F(2,3) conv held against the JAX package's.

Inputs are made with numpy from seeds and go through yolo_tpu/serving/
winograd.py (and its Pallas kernel in interpret mode) and
yolo_tpu_torch/serving/winograd.py + cuda_wino.py (whose kernel wrappers
run the plain twins on CPU tensors):

- the int32 input taps exactly, at 14x14, 7x7, 8x8 and a non-square 7x9;
- the calibration's tap maxima exactly;
- ``wino_quantize`` bit for bit (uq, mw, t, dinv);
- the twin ``conv3x3_wino_rq`` bit for bit against JAX's XLA path, and
  against ``conv3x3_wino_pallas(interpret=True)`` where the Pallas kernel
  takes the shape (even and square: JAX's own two test cases);
- each ablation mode's twin against its definition, ``taps`` against JAX's
  tap build and requant.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.serving import winograd as jw
from yolo_tpu.serving.pallas_wino import conv3x3_wino_pallas
from yolo_tpu_torch.serving import cuda_wino
from yolo_tpu_torch.serving import winograd as pw

S_IN, S_OUT = 0.031, 0.047
# (N, H, W, C, K, leaky): JAX's two cases of tests/test_serving.py first.
CASES = [(2, 8, 8, 128, 256, True), (2, 14, 14, 64, 128, False), (2, 7, 7, 64, 64, True),
         (2, 7, 9, 64, 64, False)]


def _case(seed, n, h, w, c, k):
    """Float activations, their int8 grid, folded HWIO weights and a bias."""
    r = np.random.default_rng(seed)
    x_f = (r.normal(size=(n, h, w, c)) * 2).astype(np.float32)
    x_q = np.clip(np.round(x_f / S_IN), -127, 127).astype(np.int8)
    wt = (r.normal(size=(3, 3, c, k)) * 0.05).astype(np.float32)
    b = r.normal(size=(k,)).astype(np.float32)
    return x_f, x_q, wt, b


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def wino_reference_np(x_q, qw, leaky):
    """The Winograd conv in numpy, in the documented order with every float32
    step rounded on its own (numpy never fuses a multiply into an add):
    exact int taps, per-tap requant, exact dots (float64), m_t = f32(acc) *
    mw, Y_p summed over ascending t from the first nonzero term, bias,
    activation, round half to even, clip. (N, H, W, C) int8 -> (N, H, W, K)."""
    n, h, w, c = x_q.shape
    qw = {k: np.asarray(v) for k, v in qw.items()}
    t_n = (max(h, w) + 1) // 2
    xp = np.zeros((n, 2 * t_n + 2, 2 * t_n + 2, c), np.int64)
    xp[:, 1:h + 1, 1:w + 1] = x_q
    d = [[xp[:, u:u + 2 * t_n:2, v:v + 2 * t_n:2] for v in range(4)] for u in range(4)]
    b_t = jw.B_T.astype(np.int64)
    m = []
    for t in range(16):
        a, b = divmod(t, 4)
        v_t = sum(b_t[a, u] * b_t[b, v] * d[u][v] for u in range(4) for v in range(4))
        vq = np.clip(np.round(v_t.astype(np.float32) * qw["dinv"].reshape(16)[t]), -127, 127)
        acc = vq.reshape(-1, c).astype(np.float64) @ qw["uq"][t].astype(np.float64)
        m.append(acc.astype(np.float32) * qw["mw"].reshape(16, -1)[t])
    a2 = np.einsum("ra,sb->rsab", jw.A_T, jw.A_T).reshape(4, 16)
    out = np.zeros((n, 2 * t_n, 2 * t_n, qw["uq"].shape[-1]), np.int8)
    for p in range(4):
        y = None
        for t in range(16):
            if a2[p, t] != 0:
                term = m[t] if a2[p, t] > 0 else -m[t]
                y = term if y is None else y + term
        y = y + qw["t"]
        y = np.where(y > 0, y, np.float32(0.1) * y) if leaky else np.maximum(y, np.float32(0))
        q = np.clip(np.round(y), -127, 127).astype(np.int8)
        out[:, p // 2::2, p % 2::2] = q.reshape(n, t_n, t_n, -1)
    return out[:, :h, :w]


@pytest.mark.parametrize("hw", [(14, 14), (7, 7), (8, 8), (7, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_input_taps_and_tap_maxima_match_jax(hw):
    x_f, x_q, _, _ = _case(sum(hw), 2, *hw, 64, 64)
    n_tiles = (max(hw) + 1) // 2
    want = jw.input_taps_i32(jnp.asarray(x_q), n_tiles)
    got = pw.input_taps_i32(torch.from_numpy(x_q), n_tiles)
    assert len(got) == len(want) == 16
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"tap {t}")
    np.testing.assert_array_equal(pw.tap_maxima(torch.from_numpy(x_f)).numpy(),
                                  np.asarray(jw.tap_maxima(jnp.asarray(x_f))))
    # An NCHW tensor's permuted view gives the same maxima (folded_forward's use).
    nchw = torch.from_numpy(x_f).permute(0, 3, 1, 2).contiguous()
    assert torch.equal(pw.tap_maxima(nchw.permute(0, 2, 3, 1)),
                       pw.tap_maxima(torch.from_numpy(x_f)))


@pytest.mark.parametrize("ck", [(64, 128), (256, 512)], ids=lambda ck: f"{ck[0]}to{ck[1]}")
def test_wino_quantize_matches_jax_bit_for_bit(ck):
    x_f, _, wt, b = _case(3, 2, 8, 8, *ck)
    tm = np.asarray(jw.tap_maxima(jnp.asarray(x_f)))
    want = jw.wino_quantize(jnp.asarray(wt), jnp.asarray(b), S_IN, S_OUT, tm)
    got = pw.wino_quantize(torch.from_numpy(wt), torch.from_numpy(b), S_IN, S_OUT, tm)
    assert set(got) == set(want) == {"uq", "mw", "t", "dinv"}
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].numpy().dtype == w.dtype and tuple(got[key].shape) == w.shape, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    # The tap maxima may also come as a tensor (the port's calibration).
    again = pw.wino_quantize(torch.from_numpy(wt), torch.from_numpy(b), S_IN, S_OUT,
                             torch.from_numpy(tm.copy()))
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])) + (
    "-leaky" if c[5] else "-relu"))
def test_twin_matches_jax_xla_and_pallas_bit_for_bit(case):
    n, h, w, c, k, leaky = case
    x_f, x_q, wt, b = _case(sum(case[:5]), n, h, w, c, k)
    qc = {"wino": jw.wino_quantize(jnp.asarray(wt), jnp.asarray(b), S_IN, S_OUT,
                                   jw.tap_maxima(jnp.asarray(x_f)))}
    got = cuda_wino.conv3x3_wino(torch.from_numpy(x_q), {"wino": _torch_tree(qc["wino"])},
                                 leaky)
    assert got.dtype == torch.int8 and tuple(got.shape) == (n, h, w, k)
    want = np.asarray(jw.conv3x3_wino_rq(jnp.asarray(x_q), qc, leaky=leaky))
    np.testing.assert_array_equal(got.numpy(), want)
    if h == w and h % 2 == 0:  # what the Pallas kernel takes
        pallas = conv3x3_wino_pallas(jnp.asarray(x_q), qc, leaky=leaky, img_chunk=2,
                                     interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), wino_reference_np(x_q, qc["wino"], leaky))


def test_twin_keeps_its_rounding_where_jax_fuses_a_multiply_into_an_add():
    """Over many values, XLA:CPU now and then contracts the dequant multiply
    and the inverse transform's add into one fused multiply-add (one rounding
    instead of two), in either of JAX's paths: they then differ from each
    other and from the documented order in a value by 1. The twin keeps the
    order (the numpy reference) everywhere; JAX stays within 1 of it."""
    n, h, w, c, k = 4, 32, 32, 64, 64
    x_f, x_q, wt, b = _case(77, n, h, w, c, k)
    qw = jw.wino_quantize(jnp.asarray(wt), jnp.asarray(b), S_IN, S_OUT,
                          jw.tap_maxima(jnp.asarray(x_f)))
    got = cuda_wino.conv3x3_wino(torch.from_numpy(x_q), {"wino": _torch_tree(qw)}, False)
    ref = wino_reference_np(x_q, qw, False)
    np.testing.assert_array_equal(got.numpy(), ref)
    for path in (jw.conv3x3_wino_rq(jnp.asarray(x_q), {"wino": qw}, leaky=False),
                 conv3x3_wino_pallas(jnp.asarray(x_q), {"wino": qw}, leaky=False, img_chunk=2,
                                     interpret=True)):
        diff = np.abs(np.asarray(path, np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


@pytest.mark.parametrize("mode", ["full", "taps", "dots", "dots-raw"])
def test_ablation_twins_equal_their_definitions(mode):
    n, h, w, c, k = 2, 7, 9, 64, 64
    x_f, x_q, wt, b = _case(9, n, h, w, c, k)
    qw = jw.wino_quantize(jnp.asarray(wt), jnp.asarray(b), S_IN, S_OUT,
                          jw.tap_maxima(jnp.asarray(x_f)))
    got = cuda_wino.wino_ablate(torch.from_numpy(x_q), _torch_tree(qw), mode).numpy()
    assert got.dtype == np.int8 and got.shape == (n, h, w, k)
    if mode == "full":
        want = np.asarray(jw.conv3x3_wino_rq(jnp.asarray(x_q), {"wino": qw}, leaky=True))
    elif mode == "taps":
        # Output (2i + r, 2j + s, k) is tap 2r + s of tile (i, j) at channel k.
        n_tiles = (max(h, w) + 1) // 2
        taps = jw.input_taps_i32(jnp.asarray(x_q), n_tiles)
        dinv = np.asarray(qw["dinv"]).reshape(16)
        want = np.zeros((n, 2 * n_tiles, 2 * n_tiles, k), np.int8)
        for p in range(4):
            vq = np.clip(np.round(np.asarray(taps[p], np.float32) * dinv[p]), -127, 127)
            want[:, p // 2::2, p % 2::2, :] = vq[..., :k].astype(np.int8)
        want = want[:, :h, :w]
    else:
        # Zero taps: every output is the epilogue of the bias alone.
        t = np.asarray(qw["t"])
        y = np.where(t > 0, t, np.float32(0.1) * t)
        want = np.broadcast_to(np.clip(np.round(y), -127, 127).astype(np.int8), (n, h, w, k))
    np.testing.assert_array_equal(got, want)


def test_points_and_hooks():
    assert pw.valid_points((1, 1, 1, 1)) == ("l1b0_conv2", "head_conv1", "head_conv3",
                                             "head_conv4")
    assert len(pw.valid_points((3, 4, 6, 3))) == 16
    for bad in (["head_conv2"], ["l2b0_conv2"], ["l1b3_conv2"], ["conv1"]):
        with pytest.raises(ValueError, match="valid names: l1b0_conv2, l1b1_conv2"):
            pw.check_points(bad, (2, 2, 2, 2))
    for bad in (["head_conv2"], ["l3b0_conv2"], ["l5b1_conv2"]):
        with pytest.raises(ValueError, match="not stride-1 3x3 convs"):
            pw.wino_impl_hooks(bad)
    impl = pw.wino_impl_hooks(["l1b0_conv2", "l3b2_conv2", "head_conv1"], {"stem_front": 1})
    assert set(impl) == {"stem_front", "conv2_s1", "head_conv1"}
    assert set(impl["conv2_s1"]) == {"l1b0", "l3b2"}
    assert impl["head_conv1"].keywords == {"leaky": True}
    assert impl["conv2_s1"]["l1b0"].keywords == {"leaky": False}
    assert impl["conv2_s1"]["l1b0"].func is pw.conv3x3_wino_auto
    twin = pw.wino_impl_hooks(["head_conv4"], conv=pw.conv3x3_wino_rq)
    assert twin["head_conv4"].func is pw.conv3x3_wino_rq
