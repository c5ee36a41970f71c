"""The search after the encode: the dense arm (`retrieval.dense`), the
BM25 arm with its host sort (`retrieval.sparse`) and the fusion
(`retrieval.fuse`), summed over a query's spans, mean over the window's
answered queries."""

from portbench import spans


def read(obs):
    return spans.stage_ms(obs, ("retrieval.dense", "retrieval.sparse",
                                "retrieval.fuse"))
