from .parsing import Section, parse_document, supported_formats  # noqa: F401
from .chunker import Chunk, StructuralChunker, ChunkerConfig  # noqa: F401
from .classify import DocumentClassifier, ChunkClassifier  # noqa: F401
from .filter import RelevanceFilter  # noqa: F401
from .dedup import deduplicate  # noqa: F401
from .indexer import CorpusIndexer  # noqa: F401
from .pipeline import IngestPipeline, STEP_ORDER  # noqa: F401
