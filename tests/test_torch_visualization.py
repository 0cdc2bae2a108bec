"""The port's objectness helpers held against the JAX package's.

``extract_objectness_scores`` on the same seeded grids (numpy, and a tensor
for the port) equals JAX's; the grid overlay has JAX's size and the same
line pixels (the score labels' font may differ: the port draws with PIL's
built-in font); the 3-panel figure's heatmap is the scores, as JAX's is.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from yolo_tpu.utils import visualization as jvis
from yolo_tpu_torch.utils import visualization as vis

S, B = 7, 2


def _grid(seed: int, batch=None):
    shape = (S, S, B * 5 + 20) if batch is None else (batch, S, S, B * 5 + 20)
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("case", ["3-D", "4-D", "4-D tensor"])
def test_objectness_scores_match_jax(case):
    pred = _grid(0, None if case == "3-D" else 3)
    want = jvis.extract_objectness_scores(pred, S, B)
    got = vis.extract_objectness_scores(torch.from_numpy(pred) if "tensor" in case else pred,
                                        S, B)
    assert got.shape == (S, S) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_objectness_grid_overlay_matches_jax():
    """White grid lines where JAX draws them; yellow score text in each cell."""
    image = Image.new("RGB", (448, 336), (40, 80, 120))
    pred = _grid(1)
    got = np.asarray(vis.draw_objectness_grid_on_image(image, pred, S, B))
    want = np.asarray(jvis.draw_objectness_grid_on_image(image, pred, S, B))
    assert got.shape == want.shape == (336, 448, 3)
    white = np.all(want == 255, axis=-1)
    assert white.any()
    np.testing.assert_array_equal(np.all(got == 255, axis=-1), white)
    yellow = np.all(got == (255, 255, 0), axis=-1)
    cell_h, cell_w = 336 // S, 448 // S
    assert all(yellow[i * cell_h:(i + 1) * cell_h, j * cell_w:(j + 1) * cell_w].any()
               for i in range(S) for j in range(S))
    assert np.array_equal(np.asarray(image)[0, 0], (40, 80, 120))  # the input is untouched


def test_objectness_figure_matches_jax(tmp_path):
    image = Image.new("RGB", (448, 448), (90, 90, 90))
    pred = _grid(2, 2)
    fig = vis.visualize_objectness_grid(image, torch.from_numpy(pred), S, B)
    jfig = jvis.visualize_objectness_grid(image, pred, S, B)
    try:
        panels = [ax for ax in fig.axes if ax.get_title()]
        assert [ax.get_title() for ax in panels] == [ax.get_title() for ax in jfig.axes
                                                    if ax.get_title()]
        assert len(panels) == 3 and len(fig.axes) == len(jfig.axes)
        heat = np.asarray(panels[1].images[0].get_array())
        np.testing.assert_array_equal(heat, jvis.extract_objectness_scores(pred, S, B))
        overlay = np.asarray(panels[2].images[1].get_array())
        assert overlay.shape == (448 // S * S, 448 // S * S)
    finally:
        import matplotlib.pyplot as plt

        plt.close(fig)
        plt.close(jfig)
    out = tmp_path / "objectness.png"
    assert vis.visualize_objectness_grid(image, pred, S, B, save_path=str(out)) == str(out)
    assert Image.open(out).size == (15 * 120, 5 * 120)


def test_objectness_figure_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        vis.visualize_objectness_grid(Image.new("RGB", (64, 64)), _grid(3), S, B)
    # The grid overlay needs only PIL.
    assert vis.draw_objectness_grid_on_image(Image.new("RGB", (64, 64)), _grid(3)).size == (
        64, 64)
