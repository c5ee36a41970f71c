from .types import RetrievedChunk, RetrievedDocument  # noqa: F401
from .bm25 import Bm25Stats, build_ell_corpus, SummaryBm25Index  # noqa: F401
from .retriever import HybridRetriever, RetrieverConfig  # noqa: F401
from .reranker import (  # noqa: F401
    CrossEncoderReranker,
    MaxSimReranker,
    default_reranker,
)
