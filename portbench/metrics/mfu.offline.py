"""The served forward's share of the chip's peaks: the operations of one
image by precision (``counts/<config>.py``, from shapes), each over its
published peak (int8 1,979 TOP/s; float32 67 TFLOP/s), times ``images_per_s``
(every image of the window over the window, by the host's clock), in percent."""

from portbench.metrics._common import peak_share, window_rate


def read(run):
    rate = window_rate(run, "images_per_s")
    if rate is None:
        return None
    ops = run.counts().ops_per_image(run.model_config(), run.params["work"])
    return peak_share(ops, rate)
