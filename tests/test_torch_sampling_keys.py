"""The port's sampling keys are JAX's (ROADMAP C-28, closed): threefry-2x32
on int64 tensors, `fold_in(fold_in(key(seed), pos), tag)`, JAX's
partitionable `random_bits` layout.

* `step_bits` and `step_uniforms` equal `jax.random.bits` and
  `jax.random.uniform` of `rag_dpo_tpu.models.generate.step_keys` bit for
  bit, for seeds 0, 1, 2³¹ and 2³² − 1, positions 0 … 300 and tags 0/1;
* `step_gumbel` equals `jax.random.gumbel` within `GUMBEL_TOL` (2e-6
  absolute): its uniforms are bit-equal, and torch's and XLA's f32 `log`
  differ in the last bits;
* a sampled `generate_ids` (temperature 0.8, top-k 20, top-p 0.9) on the
  tiny f32 decoder with JAX-exported weights gives JAX's tokens, or where
  they first differ, both tokens lie within `NEAR_TIE` of the solo run's
  top draw score (`divergence_gap`, ROADMAP C-29).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import generate as jgen
from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu_torch.models.generate import (
    SamplingConfig,
    TextGenerator,
    mix_seed,
    step_bits,
    step_gumbel,
    step_keys,
    step_uniforms,
    threefry2x32,
)
from rag_dpo_tpu_torch.serving.continuous import divergence_gap
from test_torch_continuous import NEAR_TIE
from test_torch_decoder import jax_params, port_config

SEEDS = [0, 1, 2**31, 2**32 - 1]
GUMBEL_TOL = 2e-6
JCFG = JDecoderConfig.tiny(num_heads=4, num_kv_heads=2, dtype=jnp.float32)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_draws(seed, tag, n=40):
    pos = np.arange(301, dtype=np.int32)
    keys = jgen.step_keys(jnp.full((301,), seed, jnp.uint32),
                          jnp.asarray(pos), tag)
    return tuple(np.asarray(jax.vmap(lambda k: f(k, (n,)))(keys))
                 for f in (jax.random.bits, jax.random.uniform,
                           jax.random.gumbel))


@pytest.mark.parametrize("tag", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_equal_jax_random(seed, tag):
    bits, uni, gum = _jax_draws(seed, tag)
    keys = step_keys(torch.full((301,), seed, dtype=torch.int64),
                     torch.arange(301), tag)
    np.testing.assert_array_equal(step_bits(keys, 40).numpy()
                                  .astype(np.uint32), bits)
    u = step_uniforms(keys, 40).numpy()
    np.testing.assert_array_equal(u.view(np.uint32), uni.view(np.uint32))
    np.testing.assert_allclose(step_gumbel(keys, 40).numpy(), gum,
                               atol=GUMBEL_TOL, rtol=0)


def test_threefry_is_jax_hash_and_keys_are_fold_ins():
    from jax._src import prng

    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = prng.threefry_2x32(jnp.asarray(k[:, 0]),
                              jnp.asarray(np.concatenate(x)))
    t = torch.from_numpy
    got = threefry2x32(t(k[0, :1].astype(np.int64)),
                       t(k[1, :1].astype(np.int64)),
                       t(x[0].astype(np.int64)), t(x[1].astype(np.int64)))
    np.testing.assert_array_equal(
        np.concatenate([g.numpy() for g in got]).astype(np.uint32),
        np.asarray(want))
    jk = jax.random.key_data(jgen.step_keys(
        jnp.asarray([7, 2**32 - 1], jnp.uint32), jnp.asarray([3, 300]), 1))
    keys = step_keys(torch.tensor([7, 2**32 - 1]), torch.tensor([3, 300]), 1)
    np.testing.assert_array_equal(
        np.stack([keys.k1.numpy(), keys.k2.numpy()], 1).astype(np.uint32),
        np.asarray(jk))


@pytest.fixture(scope="module")
def jax_and_port_generators():
    params = jax_params(JCFG)
    return (jgen.TextGenerator(JCFG, params=params),
            TextGenerator(port_config(JCFG), params=params, device="cpu"))


@pytest.mark.parametrize("rng_seed", [0, 7, 2**31])
def test_sampled_generation_gives_jax_tokens(rng_seed,
                                             jax_and_port_generators):
    jg, pg = jax_and_port_generators
    sampling = SamplingConfig(temperature=0.8, top_k=20, top_p=0.9,
                              max_new_tokens=12, eos_id=-1)
    jsampling = jgen.SamplingConfig(temperature=0.8, top_k=20, top_p=0.9,
                                    max_new_tokens=12, eos_id=-1)
    rng = np.random.default_rng(rng_seed % 1000)
    exact = 0
    for n in (5, 9, 14):
        prompt = rng.integers(4, 512, (1, n)).astype(np.int32)
        lens = np.asarray([n], np.int32)
        want = np.asarray(jg.generate_ids(prompt, lens, jsampling,
                                          rng_seed=rng_seed))[0]
        got = pg.generate_ids(prompt, lens, sampling, rng_seed=rng_seed)[0]
        if np.array_equal(got, want):
            exact += 1
            continue
        gap = divergence_gap(pg, prompt[0], list(want), list(got), sampling,
                             temperature=0.8, seed=mix_seed(rng_seed, 0))
        assert gap <= NEAR_TIE, (n, want, got, gap)
    assert exact >= 2      # near-ties are rare: most runs are bit-equal
