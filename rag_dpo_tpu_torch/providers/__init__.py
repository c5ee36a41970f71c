from .base import BaseLLMProvider, LLMResponse  # noqa: F401
from .fake import FakeLLMProvider  # noqa: F401
from .http_llm import HTTPLLMProvider  # noqa: F401
from .embedding import Embedder, EmbedderConfig  # noqa: F401
from .factory import create_llm, HostedAPIProvider  # noqa: F401
