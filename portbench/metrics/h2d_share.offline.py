"""Share of the traced window in which a host-to-device copy ran and no
kernel did (the copy-in that nothing hides), in percent."""

from portbench import trace


def read(run):
    t = run.trace_data
    if t is None or t.window_s <= 0:
        return None
    h2d = t.intervals(lambda name, cat: cat == "gpu_memcpy" and "HtoD" in name)
    if not h2d:
        return None
    kernels = t.intervals(lambda name, cat: cat == "kernel")
    return 100.0 * trace.length(trace.subtract(h2d, kernels)) * 1e-6 / t.window_s
