"""Host tokenizers (copies of the JAX package's jax-free modules).

The HF adapter (`rag_dpo_tpu/tokenize/hf.py`) is not carried: it loads
`transformers`, which the port never imports, so the port defaults to
`HashedTokenizer` where the JAX package would try a cached HF tokenizer
first (ROADMAP C-7). Inject a tokenizer to use another one.
"""

from .base import Tokenizer, Encoded  # noqa: F401
from .hashed import HashedTokenizer  # noqa: F401
from .french import tokenize_french_text, FRENCH_STOPWORDS  # noqa: F401
