"""The training step's share of the chip's bf16 peak (989 TFLOP/s): three
times the forward's operations of one image (``counts/<config>.py``: the
forward, and the backward's two products a layer) times
``train_images_per_s`` (images trained over the window, by the host's clock),
in percent."""

from portbench.metrics._common import peak_share, window_rate


def read(run):
    rate = window_rate(run, "train_images_per_s")
    if rate is None:
        return None
    ops = run.counts().ops_per_image(run.model_config(), "train")
    return peak_share({k: 3 * v for k, v in ops.items()}, rate)
