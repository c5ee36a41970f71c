from .indexer import CorpusIndexer  # noqa: F401
