"""The median, over every request sent inside the window, of the time from
its submit to its first streamed token."""

from portbench import readers, stats


def read(obs):
    p = stats.percentile(readers.ttfts(obs), 50)
    return None if p is None else p * 1e3
