"""The query encode (`retrieval.encode`: BGE-M3 over the question and its
variants), summed over a query's spans, mean over the window's answered
queries."""

from portbench import spans


def read(obs):
    return spans.stage_ms(obs, ("retrieval.encode",))
