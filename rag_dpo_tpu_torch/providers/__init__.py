from .base import BaseLLMProvider, LLMResponse  # noqa: F401
from .fake import FakeLLMProvider  # noqa: F401
from .embedding import Embedder, EmbedderConfig  # noqa: F401
