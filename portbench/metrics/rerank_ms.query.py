"""The cross-encoder's rerank (`rerank`: pair encoding, the forward and
its copy out), summed over a query's spans, mean over the window's
answered queries."""

from portbench import spans


def read(obs):
    return spans.stage_ms(obs, ("rerank",))
