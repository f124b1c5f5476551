"""The share of the traced window in which no kernel, copy or memset
ran on the device, from torch.profiler's trace."""

from solvebench import tracing


def read(ctx):
    return tracing.idle_pct(ctx)
