"""The port's generation (slice 16) against the JAX package's, on the CPU.

* `apply_penalties`, `truncated_token_prob`, `sampling_logprobs`,
  `mix_seed` and `default_row_seeds` on the same numpy inputs as JAX's
  (1e-6, or bit for bit where the arithmetic is integer);
* `score_choices` on JAX-exported weights within `SCORE_TOL` of JAX's
  (f32; a sum of ≤ 6 log-probs over a 512-token vocabulary);
* sampling: the draws are JAX's threefry keys (held bit for bit to
  `jax.random` in `tests/test_torch_sampling_keys.py`); here they are held
  to the distribution they sample (total variation against the numpy
  oracle of the kept set) and to `tests/test_seeds.py`'s properties (a
  stream is a pure function of its row seed and positions: any chunking,
  any batch composition; co-batched identical prompts differ);
* speculative decoding: `tests/test_speculative.py`'s direct-path cases,
  bit-equal to plain greedy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import generate as jgen
from rag_dpo_tpu.models import speculative as jspec
from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu_torch.models.decoder import DecoderConfig
from rag_dpo_tpu_torch.models.generate import (
    SamplingConfig,
    TextGenerator,
    apply_penalties,
    default_row_seeds,
    mix_seed,
    penalized_rows,
    sampling_logprobs,
    step_keys,
    step_uniforms,
    topk_topp_sample,
    truncated_token_prob,
)
from rag_dpo_tpu_torch.models.speculative import (
    SpeculativeGenerator,
    prompt_lookup_draft,
)
from test_sampling import _oracle_truncated_probs
from test_torch_decoder import jax_params, port_config

SCORE_TOL = 1e-4
CFG = DecoderConfig.tiny(num_heads=4, num_kv_heads=2, dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    g = TextGenerator(CFG, device="cpu")
    g.load()
    return g


def _prompt(rng, n):
    return rng.integers(4, CFG.vocab_size, (n,)).astype(np.int32)


def _greedy(max_new, eos=2):
    return SamplingConfig(temperature=0.0, max_new_tokens=max_new,
                          eos_id=eos, pad_id=1)


# ------------------------------------------------------ functions vs JAX
def test_seed_mixing_is_the_jax_packages():
    for a, b in [(0, 0), (7, 1), (2**32 - 1, 5), (12345, 99)]:
        assert mix_seed(a, b) == jgen.mix_seed(a, b)
    np.testing.assert_array_equal(default_row_seeds(7, 5),
                                  jgen.default_row_seeds(7, 5))


def test_penalties_and_logprobs_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 64)).astype(np.float32) * 3
    counts = rng.integers(0, 3, (4, 64)).astype(np.float32)
    freqs = np.asarray([0.0, 0.5, -0.3, 1.0], np.float32)
    pres = np.asarray([0.0, 0.2, 0.0, -0.7], np.float32)
    bias = rng.standard_normal((4, 64)).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 1.0, 1.3], np.float32)
    tokens = rng.integers(0, 64, (4,)).astype(np.int32)
    t = torch.from_numpy
    for b in (None, bias):
        want = np.asarray(jgen.apply_penalties(
            jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(freqs),
            jnp.asarray(pres), None if b is None else jnp.asarray(b)))
        got = apply_penalties(t(logits), t(counts), t(freqs), t(pres),
                              None if b is None else t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # zero penalties are a bitwise no-op
    z = np.zeros(4, np.float32)
    assert torch.equal(apply_penalties(t(logits), t(counts), t(z), t(z)),
                       t(logits))
    np.testing.assert_array_equal(
        penalized_rows(t(freqs), t(pres)).numpy(),
        np.asarray(jgen.penalized_rows(jnp.asarray(freqs),
                                       jnp.asarray(pres))))
    lp, ti, tv = sampling_logprobs(t(logits), t(temps),
                                   t(tokens).long())
    jlp, jti, jtv = jgen.sampling_logprobs(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tokens))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), atol=1e-5)
    for top_k, top_p in [(8, 1.0), (16, 0.8), (64, 0.95)]:
        want = np.asarray(jgen.truncated_token_prob(
            jnp.asarray(logits), jnp.asarray(np.abs(temps) + 0.1),
            jnp.asarray(tokens), top_k, top_p))
        got = truncated_token_prob(t(logits), t(np.abs(temps) + 0.1),
                                   t(tokens).long(), top_k, top_p)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_score_choices_match_jax():
    jcfg = JDecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                               dtype=jnp.float32)
    params = jax_params(jcfg, seed=1)
    want_gen = jgen.TextGenerator(jcfg,
                                  params=jax.tree.map(jnp.asarray, params))
    got_gen = TextGenerator(port_config(jcfg), params=params, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(4, 512, (11,)).astype(np.int32)
    cands = [rng.integers(4, 512, (n,)).astype(np.int32) for n in (1, 3, 5)]
    cand_ids = np.full((3, 5), 1, np.int32)
    for i, x in enumerate(cands):
        cand_ids[i, :len(x)] = x
    lens = np.asarray([1, 3, 5], np.int32)
    for p_len in (11, 7):
        want = want_gen.score_choices(prompt, p_len, cand_ids, lens)
        got = got_gen.score_choices(prompt, p_len, cand_ids, lens)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


def test_score_choices_match_a_full_forward(gen):
    """Prefill + copy + extend scoring == a cache-free forward over
    prompt + candidate (`tests/test_choose.py`'s oracle)."""
    rng = np.random.default_rng(0)
    prompt = _prompt(rng, 11)
    cands = [_prompt(rng, n) for n in (1, 3, 5)]
    cand_ids = np.full((3, 5), 1, np.int32)
    for i, x in enumerate(cands):
        cand_ids[i, :len(x)] = x
    got = gen.score_choices(prompt, 11, cand_ids,
                            np.asarray([1, 3, 5], np.int32))
    for i, x in enumerate(cands):
        row = torch.as_tensor(np.concatenate([prompt, x])[None]).long()
        with torch.no_grad():
            lp = torch.log_softmax(gen.model(row).double(), dim=-1)
        want = sum(float(lp[0, 10 + j, int(x[j])]) for j in range(len(x)))
        assert abs(got[i] - want) < 5e-4, (i, got[i], want)


def test_batched_choose_matches_single(gen):
    rng = np.random.default_rng(7)
    kb, s, cb, b = 4, 16, 4, 4
    pids = rng.integers(4, 512, (b, s)).astype(np.int32)
    plens = rng.integers(3, s, (b,)).astype(np.int32)
    cids = rng.integers(4, 512, (b, kb, cb)).astype(np.int32)
    clens = rng.integers(1, cb + 1, (b, kb)).astype(np.int32)
    batched = gen._choose(pids, plens, cids, clens)
    for i in range(b):
        solo = gen._choose(pids[i:i + 1], plens[i:i + 1], cids[i:i + 1],
                           clens[i:i + 1])
        np.testing.assert_allclose(batched[i], solo[0], atol=1e-5,
                                   rtol=0)


# ------------------------------------------------------------- sampling
def test_draws_are_position_keyed():
    seeds = torch.tensor([7, 7, 8, 7])
    pos = torch.tensor([3, 3, 3, 4])
    u = step_uniforms(step_keys(seeds, pos, 0), 40)
    assert u.dtype == torch.float32 and u.shape == (4, 40)
    assert bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u[0], u[1])                 # same (seed, pos, tag)
    assert not torch.equal(u[0], u[2])             # another seed
    assert not torch.equal(u[0], u[3])             # another position
    assert not torch.equal(u[0], step_uniforms(step_keys(seeds, pos, 1),
                                               40)[0])   # another tag
    many = step_uniforms(step_keys(torch.zeros(4096, dtype=torch.long),
                                   torch.arange(4096), 0), 8)
    assert abs(float(many.mean()) - 0.5) < 0.01
    assert abs(float(many.var()) - 1 / 12) < 0.005


@pytest.mark.parametrize("top_k,top_p,temp", [(16, 1.0, 0.8),
                                              (16, 0.9, 1.0),
                                              (48, 0.6, 1.3)])
def test_draws_follow_the_kept_set_distribution(top_k, top_p, temp):
    """4,096 draws of one row (4,096 positions) against the numpy oracle
    of the kept set: total variation < 0.05; never a token outside it."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(48).astype(np.float32) * 2
    n = 4096
    rows = torch.from_numpy(np.repeat(logits[None], n, axis=0))
    temps = torch.full((n,), temp)
    keys = step_keys(torch.full((n,), 11), torch.arange(n), 0)
    draws = topk_topp_sample(rows, temps, keys, top_k, top_p).numpy()
    want = _oracle_truncated_probs(logits, temp, top_k, top_p)
    assert np.all(want[draws] > 0)
    emp = np.bincount(draws, minlength=48) / n
    assert 0.5 * np.abs(emp - want).sum() < 0.05
    # exclude: never drawn, the residual distribution of the kept set
    excl = torch.full((n,), int(np.argmax(logits)))
    ex = topk_topp_sample(rows, temps, keys, top_k, top_p,
                          exclude=excl).numpy()
    if want[int(excl[0])] < 1:
        assert not np.any(ex == int(excl[0]))
        resid = _oracle_truncated_probs(logits, temp, top_k, top_p,
                                        exclude=int(excl[0]))
        emp = np.bincount(ex, minlength=48) / n
        assert 0.5 * np.abs(emp - resid).sum() < 0.05


def test_greedy_rows_and_the_nucleus_edges():
    x = np.zeros((4, 64), np.float32)
    x[:, 7] = 10.0
    peaked = torch.from_numpy(x)
    keys = step_keys(torch.arange(4), torch.zeros(4, dtype=torch.long), 0)
    # top_p below the peak's mass: only the peak, at any temperature
    out = topk_topp_sample(peaked, torch.tensor([0.7, 1.0, 1.5, 2.0]),
                           keys, 40, 0.5)
    assert out.tolist() == [7, 7, 7, 7]
    # greedy rows (temp ≤ 0) take the argmax whatever top_p says
    out = topk_topp_sample(peaked, torch.tensor([0.0, -1.0, 0.0, 0.0]),
                           keys, 8, 0.01)
    assert out.tolist() == [7, 7, 7, 7]
    # the first token survives top_p → 0
    rnd = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 64)).astype(np.float32))
    out = topk_topp_sample(rnd, torch.ones(4), keys, 16, 1e-9)
    assert torch.equal(out, rnd.argmax(-1))
    with pytest.raises(ValueError, match="top_p"):
        topk_topp_sample(rnd, torch.ones(4), keys, 16, 0.0)


# ------------------------------------------- the seed properties (JAX's)
def test_generate_ids_seed_determinism_and_sensitivity(gen):
    rng = np.random.default_rng(0)
    ids = np.stack([_prompt(rng, 8), np.pad(_prompt(rng, 6), (0, 2),
                                            constant_values=1)])
    lens = np.asarray([8, 6], np.int32)
    s = SamplingConfig(temperature=0.9, max_new_tokens=6, eos_id=-1)
    a = gen.generate_ids(ids, lens, s, rng_seed=7)
    assert np.array_equal(a, gen.generate_ids(ids, lens, s, rng_seed=7))
    assert not np.array_equal(a, gen.generate_ids(ids, lens, s,
                                                  rng_seed=8))


def test_sampled_stream_equals_generate_ids_any_chunking(gen):
    rng = np.random.default_rng(1)
    ids = _prompt(rng, 8)[None]
    lens = np.asarray([8], np.int32)
    s = SamplingConfig(temperature=1.1, max_new_tokens=12, eos_id=-1)
    want = gen.generate_ids(ids, lens, s, rng_seeds=[77])
    for chunk in (3, 5, 12):
        got = np.concatenate(list(gen.generate_stream(
            ids, lens, s, rng_seeds=[77], chunk=chunk)), axis=1)
        assert np.array_equal(got, want), chunk


def test_row_stream_independent_of_batch_composition(gen):
    rng = np.random.default_rng(2)
    p, q = _prompt(rng, 8), _prompt(rng, 8)
    s = SamplingConfig(temperature=0.8, max_new_tokens=8, eos_id=-1)
    solo = gen.generate_ids(p[None], np.asarray([8], np.int32), s,
                            rng_seeds=[505])[0]
    batched = gen.generate_ids(np.stack([q, p]),
                               np.asarray([8, 8], np.int32), s,
                               rng_seeds=[99, 505])
    assert np.array_equal(solo, batched[1])


def test_cobatched_identical_prompts_sample_independently(gen):
    rng = np.random.default_rng(3)
    p = _prompt(rng, 8)
    s = SamplingConfig(temperature=1.5, max_new_tokens=12, eos_id=-1)
    out = gen.generate_ids(np.stack([p, p]), np.asarray([8, 8], np.int32),
                           s, rng_seed=4)
    assert not np.array_equal(out[0], out[1])


def test_generate_stream_matches_generate_ids(gen):
    """Greedy streams equal the one-shot decode; a stream stops after the
    chunk in which every row emitted EOS."""
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 512, (2, 10)).astype(np.int32)
    lengths = np.asarray([10, 6])
    s = SamplingConfig(temperature=0.0, max_new_tokens=13, eos_id=-1)
    want = gen.generate_ids(ids, lengths, s)
    got = np.concatenate(list(gen.generate_stream(ids, lengths, s,
                                                  chunk=4)), axis=1)
    assert np.array_equal(got, want)
    first = int(want[0, 0])
    s3 = SamplingConfig(temperature=0.0, max_new_tokens=64, eos_id=first)
    chunks = list(gen.generate_stream(ids[:1], lengths[:1], s3, chunk=4))
    assert sum(c.shape[1] for c in chunks) == 4
    # generate_ids pads after EOS
    out = gen.generate_ids(ids[:1], lengths[:1], s3)
    assert out[0, 0] == first and np.all(out[0, 1:] == s3.pad_id)


# ------------------------------------ speculative (test_speculative.py)
@pytest.mark.parametrize("draft_len,ngram", [(4, 2), (7, 2), (3, 3)])
def test_spec_bit_parity_with_plain_greedy(gen, draft_len, ngram):
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 512, (3, 12)).astype(np.int32)
    lengths = np.asarray([12, 7, 4], np.int32)
    plain = gen.generate_ids(ids, lengths, _greedy(24))
    spec = SpeculativeGenerator(gen, draft_len=draft_len, ngram=ngram)
    out, stats = spec.generate_ids(ids, lengths, _greedy(24))
    np.testing.assert_array_equal(out, plain)
    assert stats.tokens >= 3


def test_spec_bit_parity_including_eos_and_pad_tail(gen):
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 512, (2, 10)).astype(np.int32)
    lengths = np.asarray([10, 6], np.int32)
    eos = int(gen.generate_ids(ids, lengths, _greedy(20))[0, 4])
    plain = gen.generate_ids(ids, lengths, _greedy(20, eos=eos))
    assert np.any(plain == eos)
    out, _ = SpeculativeGenerator(gen, draft_len=5, ngram=2).generate_ids(
        ids, lengths, _greedy(20, eos=eos))
    np.testing.assert_array_equal(out, plain)


def test_spec_parity_over_many_seeds(gen):
    spec = SpeculativeGenerator(gen, draft_len=6, ngram=2)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        ids = rng.integers(4, 512, (2, 8)).astype(np.int32)
        lengths = np.asarray([8, 8], np.int32)
        plain = gen.generate_ids(ids, lengths, _greedy(16))
        out, _ = spec.generate_ids(ids, lengths, _greedy(16))
        np.testing.assert_array_equal(out, plain, err_msg=f"seed {seed}")


def test_spec_oracle_drafts_reach_full_acceptance(gen):
    rng = np.random.default_rng(7)
    ids = rng.integers(4, 512, (2, 8)).astype(np.int32)
    lengths = np.asarray([8, 8], np.int32)
    max_new, k = 32, 7
    plain = gen.generate_ids(ids, lengths, _greedy(max_new))
    oracle = torch.as_tensor(plain, dtype=torch.long)
    lens = torch.as_tensor(lengths, dtype=torch.long)

    def oracle_draft(ids_buf, cur):
        n_emit = cur - lens - 1
        src = n_emit[:, None] + 1 + torch.arange(k)[None, :]
        return oracle.gather(1, src.clamp(0, max_new - 1))

    spec = SpeculativeGenerator(gen, draft_len=k, draft_fn=oracle_draft)
    out, stats = spec.generate_ids(ids, lengths, _greedy(max_new))
    np.testing.assert_array_equal(out, plain)
    assert stats.tokens_per_step >= (1 + k) * 0.8, stats
    assert stats.steps <= -(-max_new // (1 + k)) + 1, stats


def test_lookup_draft_finds_latest_occurrence(gen):
    """The draft is what followed the LATEST earlier occurrence of the tail
    2-gram, pad where it never occurred; on random small-alphabet buffers
    it equals JAX's `prompt_lookup_draft`."""
    spec = SpeculativeGenerator(gen, draft_len=4, ngram=2)
    buf = [[10, 20, 31, 32, 33, 10, 20, 41, 42, 10, 20, 0],
           [10, 20, 31, 32, 33, 34, 35, 36, 37, 50, 60, 0]]
    drafts = spec.lookup_draft(torch.tensor(buf), torch.tensor([11, 11]))
    assert drafts.tolist() == [[41, 42, 10, 20], [1, 1, 1, 1]]
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 4, (6, 20)).astype(np.int32)
    cur = rng.integers(2, 20, (6,)).astype(np.int32)
    want = np.asarray(jspec.prompt_lookup_draft(jnp.asarray(rand),
                                                jnp.asarray(cur), 5, 2))
    got = prompt_lookup_draft(torch.from_numpy(rand).long(),
                              torch.from_numpy(cur).long(), 5, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_sampling_falls_back_to_plain(gen):
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 512, (1, 6)).astype(np.int32)
    lengths = np.asarray([6], np.int32)
    sampling = SamplingConfig(temperature=0.8, max_new_tokens=8, eos_id=2,
                              pad_id=1)
    out, _ = SpeculativeGenerator(gen).generate_ids(ids, lengths, sampling)
    np.testing.assert_array_equal(out, gen.generate_ids(ids, lengths,
                                                        sampling))


def test_spec_bit_parity_under_int8_kv_cache(gen):
    import dataclasses

    gq = TextGenerator(dataclasses.replace(CFG, quantize_kv=True),
                       device="cpu")
    gq.load().load_state_dict(gen.model.state_dict())   # an int8 cache
    rng = np.random.default_rng(21)
    ids = rng.integers(4, 512, (3, 12)).astype(np.int32)
    lengths = np.asarray([12, 9, 5], np.int32)
    plain = gq.generate_ids(ids, lengths, _greedy(16))
    out, stats = SpeculativeGenerator(gq, draft_len=4).generate_ids(
        ids, lengths, _greedy(16))
    np.testing.assert_array_equal(out, plain)
    assert stats.tokens >= 3
