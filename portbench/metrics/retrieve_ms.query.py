"""The agent's `retrieve` node (retrieval and rerank; the prefetched
candidates when the query was not rewritten), as the reply's
`retrieval_time` gives it, mean over the window's answered queries."""


def read(obs):
    spans = obs["retrieve_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
