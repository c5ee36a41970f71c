"""Config, paths, query log and alerter (copies of the JAX package's
jax-free modules). Structured logging and the profiler wrapper are not
carried yet: the slice does not use them, and the JAX profiler wrapper
becomes a `torch.profiler` one in a later slice."""

from .paths import Paths, default_paths  # noqa: F401
from .config import FrameworkConfig, load_config  # noqa: F401
from .query_logger import QueryLogger  # noqa: F401
from .alerter import Alerter, AlertConfig  # noqa: F401
