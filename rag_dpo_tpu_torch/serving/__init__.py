"""Serving layer of the port: the micro-batcher (`batcher.py`).

The JAX package's `serving/__init__.py` also exports the continuous
decode engine (`continuous.py`), which waits for the decoder (ROADMAP
item 7c); this one exports the batcher's names only.
"""

from .batcher import (  # noqa: F401
    BatcherStats,
    MicroBatcher,
    batched_dense_search,
    batcher_stats,
    find_choose_batcher,
)
