"""The summary prefilter (`retrieval.prefilter`: host BM25 over the
documents' sheets to 40 documents), summed over a query's spans, mean
over the window's answered queries."""

from portbench import spans


def read(obs):
    return spans.stage_ms(obs, ("retrieval.prefilter",))
