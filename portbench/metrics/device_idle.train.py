"""Share of the traced window in which no kernel, copy or memset ran on the
device (``torch.profiler``'s trace), in percent."""

from portbench.metrics._common import idle_percent


def read(run):
    return idle_percent(run)
