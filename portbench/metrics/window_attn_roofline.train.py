"""The window attention's share of its roofline: the least time of the
attention cores of every step in the window (``counts/<config>.py``
``attention_least_seconds``: per block, forward and backward, the larger of
operations over 989 TFLOP/s and bytes over 3.35 TB/s, at the cell's batch)
times the window's steps, over the device time of the attention kernels
(``window_attn_share.train``'s), in percent."""

from portbench import harness

_SHARE = harness.load_file(harness.HERE / "metrics" / "window_attn_share.train.py")


def read(run):
    busy = _SHARE.attention_seconds(run)
    steps = run.window_counts.get("steps")
    if busy is None or not steps:
        return None
    least = run.counts().attention_least_seconds(run.model_config(), int(run.params["batch"]))
    return 100.0 * least * steps / busy
