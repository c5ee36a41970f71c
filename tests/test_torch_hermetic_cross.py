"""The hermetic replay's `"cross"` arm: the port's against JAX's.

The arm reranks with the cross-encoder `default_reranker` builds (random
weights, `EncoderConfig.tiny()`, seed 1). The port draws Flax's weights
from that seed (`models/flax_init.py`), so both packages replay the same
arm at the same seeds: the gated values agree to the record's four
decimals (held within 1e-4, one step of the last digit). No committed
record exists for the arm, so it is compared, not gated.
"""

import json

import pytest
import torch

from rag_dpo_tpu.evals.hermetic import gated_values as j_gated_values
from rag_dpo_tpu.evals.hermetic import run_hermetic_replay as j_replay
from rag_dpo_tpu_torch.evals.hermetic import (
    gated_values,
    run_hermetic_replay,
)

# the gated values are kept to four decimals
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cross_arm_matches_jax():
    record = run_hermetic_replay(n_runs=1, reranker="cross", device="cpu")
    want = j_gated_values(j_replay(n_runs=1, reranker="cross"))
    got = gated_values(record)
    print(json.dumps({"port": got, "jax": want}))
    assert record["reranker"] == "cross" and record["n_questions"] == 48
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert abs(got[name] - value) <= TOL, (name, got[name], value)
