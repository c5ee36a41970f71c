"""Config, paths, structured logging, query log and alerter (copies of the
JAX package's jax-free modules). The profiler wrapper is not carried yet:
the JAX one wraps `jax.profiler` and becomes a `torch.profiler` one in a
later slice."""

from .paths import Paths, default_paths  # noqa: F401
from .config import FrameworkConfig, load_config  # noqa: F401
from .logging import setup_structured_logging, JSONFormatter  # noqa: F401
from .query_logger import QueryLogger  # noqa: F401
from .alerter import Alerter, AlertConfig  # noqa: F401
