"""The hermetic replay gate through the port: the random-init record.

The committed random-init record was made with Flax's threefry
initialisation. The port draws the same weights from the same seed
(`models/flax_init.py`), so its own random-init replay is gated against
that record; the replay with the weights exported from JAX stays beside
it. The replay itself imports nothing of JAX.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu_torch.evals.hermetic import (
    RESULTS_DIR,
    check_against_baseline,
    gated_values,
    run_hermetic_replay,
)

RECORD = RESULTS_DIR / "results_hermetic_20260820_143837.json"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_replay_with_flax_random_init_passes_the_gate():
    params = jax.tree.map(np.asarray, JEmbedder(JEmbedderConfig(
        model=JBgeM3Config(
            encoder=JEncoderConfig.tiny(use_flash_attention=False),
            colbert_dim=32))).load())
    record = run_hermetic_replay(n_runs=1, encoder_params=params,
                                 encoder_label="random-init", device="cpu")
    print(json.dumps(gated_values(record)))
    assert record["encoder"] == "random-init"
    assert record["reranker"] == "none" and record["n_questions"] == 48
    assert not check_against_baseline(record)
    # on the CPU the port reproduces the committed record to the digit
    committed = json.loads(RECORD.read_text())
    assert committed["encoder"] == "random-init"
    assert gated_values(record) == gated_values(committed)


def test_port_replay_with_its_own_random_init_passes_the_gate():
    """`encoder_params=None`: the port's seeded init, no JAX weights. Its
    weights are Flax's within 4 ulp, and on the CPU every gated value
    equals the committed record's."""
    record = run_hermetic_replay(n_runs=1, device="cpu")
    print(json.dumps(gated_values(record)))
    assert record["encoder"] == "random-init"
    assert record["reranker"] == "none" and record["n_questions"] == 48
    assert not check_against_baseline(record)
    committed = json.loads(RECORD.read_text())
    assert gated_values(record) == gated_values(committed)
