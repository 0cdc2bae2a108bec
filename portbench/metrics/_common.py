"""Helpers the metric readers share."""

from __future__ import annotations

from portbench.counts.peaks import PEAK


def peak_share(ops_by_precision: dict, rate_per_s: float) -> float:
    """Percent of the chip's time at its peaks that ``rate_per_s`` units of
    ``ops_by_precision`` each would take: sum(ops / peak) x rate x 100."""
    return 100.0 * rate_per_s * sum(ops / PEAK[prec] for prec, ops in ops_by_precision.items())


def idle_percent(run):
    """Percent of the traced window with nothing running on the device, or None."""
    t = run.trace_data
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def window_rate(run, metric: str):
    """The run's end-to-end rate ``metric`` (host clock over the whole
    window) in a traced run on the card, or None."""
    if run.device.type != "cuda" or run.trace_data is None:
        return None
    return run.metrics.get(metric)
