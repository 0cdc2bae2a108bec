"""The int8 convs' share of their roofline: the least time of every int8
conv of the window's forwards (``counts/conv.py``: the larger of operations
over 1,979 TOP/s and bytes over 3.35 TB/s, from the model's geometries at
the cell's batch), over the device time of the kernels named in
:data:`KERNELS` in the traced window, in percent."""

from portbench.counts.conv import least_seconds

#: Substrings of the device kernels that run the int8 convs (``csrc/int8_conv.cu``:
#: ``int8_conv_kernel<...>`` and its split-K pass ``int8_conv_kernel_reduce``).
KERNELS = ("int8_conv_kernel",)


def read(run):
    t = run.trace_data
    batches = run.window_counts.get("batches")
    if t is None or not batches:
        return None
    busy = t.device_time(lambda name, cat: cat == "kernel" and any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    convs = run.counts().int8_convs(run.model_config(), run.params["work"])
    least = sum(least_seconds(c, int(run.params["batch"])) for c in convs) * batches
    return 100.0 * least / busy
