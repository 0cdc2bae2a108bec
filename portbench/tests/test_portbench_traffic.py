"""The traffic is a function of the seed: the same seed, the same inputs;
another seed, other values but the same amount of work."""

import numpy as np
import torch

from portbench import harness, traffic, weights
from portbench.tests import tiny

BIG = 2 ** 31 + 12345


def test_sub_seeds_take_any_whole_number():
    for seed in (0, 1, BIG, 2 ** 40 + 3, -5):
        s = harness.sub_seed(seed, "pool")
        assert 0 <= s < 2 ** 63
        torch.Generator().manual_seed(s)
    assert harness.sub_seed(BIG, "pool") != harness.sub_seed(BIG, "weights")
    assert harness.sub_seed(BIG, "pool") != harness.sub_seed(BIG + 1, "pool")


def test_images_repeat_for_a_seed_and_differ_across_seeds():
    a = traffic.uint8_images(harness.sub_seed(BIG, "pool"), 3, 16, "cpu")
    b = traffic.uint8_images(harness.sub_seed(BIG, "pool"), 3, 16, "cpu")
    c = traffic.uint8_images(harness.sub_seed(BIG + 1, "pool"), 3, 16, "cpu")
    assert a.dtype == torch.uint8 and tuple(a.shape) == (3, 16, 16, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_targets_hold_one_to_six_boxes_an_image():
    t = traffic.yolo_targets(3, 50, 7, 2, 20, (1, 6))
    objects = (t[..., 4] > 0).sum(axis=(1, 2))
    assert t.shape == (50, 7, 7, 30) and objects.min() >= 1 and objects.max() <= 6
    assert np.array_equal(t, traffic.yolo_targets(3, 50, 7, 2, 20, (1, 6)))
    assert not np.array_equal(t, traffic.yolo_targets(4, 50, 7, 2, 20, (1, 6)))
    cls = t[..., 10:].sum(-1)
    assert np.array_equal(cls, t[..., 4])  # one class per object cell, none elsewhere


def test_weights_repeat_for_a_seed():
    run = tiny.run("r50-int8-offline-b256")
    spec = run.reference().param_spec(run.model_config())
    a = weights.make(spec, 11, "cpu")
    b = weights.make(spec, 11, "cpu")
    c = weights.make(spec, 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.fc_layers.1.weight"], c["head.fc_layers.1.weight"])
    assert float(a["backbone.extractor.1.running_var"].min()) >= 0.8
