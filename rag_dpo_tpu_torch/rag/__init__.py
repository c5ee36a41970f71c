from .acronyms import expand_acronyms, ACRONYMS  # noqa: F401
from .expander import QueryExpander  # noqa: F401
from .intent import IntentClassifier, QuestionIntent  # noqa: F401
from .topics import RGPD_TOPICS, parse_topic_tags, TopicMatcher  # noqa: F401
from .validators import GroundingValidator, RelevanceValidator  # noqa: F401
from .context import ContextBuilder  # noqa: F401
from .generator import Generator, GeneratedResponse  # noqa: F401
from .pipeline import RAGPipeline, RAGResponse, create_pipeline  # noqa: F401
