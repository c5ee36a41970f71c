"""The port's continuous decode-slot pool (`serving/continuous.py`) on the
CPU, against the JAX engine and against the port's own solo runs.

* JAX parity: one staggered arrival schedule (late joins, slot reuse,
  chunked prefill, a prefix-cache hit, a preemption, a cancel, a
  `logit_bias` row, penalties, a logprobs request) through
  `rag_dpo_tpu.serving.continuous.ContinuousEngine` and the port's engine
  on the same JAX-exported tiny weights (f32). Greedy tokens are equal
  under the near-tie rule (ROADMAP C-29: where two runs first differ, the
  solo forward's logits of both tokens lie within `NEAR_TIE` of the top),
  logprobs and their top values agree within `LOGPROB_TOL`, and the
  engines' counters are equal.
* The port's own solo runs: the cases of the JAX test files that need a
  torch-side change (a draft source on the card, the prefix cache's entry
  layout, the int8 cache's entries, warm-up without compiled programs);
  `tests/test_torch_continuous_cases.py` runs the rest of those files'
  engine cases on the port. Sampled requests are held to the port's solo
  `generate_ids` with the same seed (the draws are JAX's keys,
  `tests/test_torch_sampling_keys.py`). The tensor-parallel case runs on
  gloo ranks in `tests/test_torch_continuous_cases.py`. The multimodal
  prefixes' own cases are in `tests/test_torch_llava.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu.models.generate import SamplingConfig as JSamplingConfig
from rag_dpo_tpu.models.generate import TextGenerator as JTextGenerator
from rag_dpo_tpu.serving.continuous import ContinuousEngine as JEngine
from rag_dpo_tpu_torch.models.decoder import DecoderConfig
from rag_dpo_tpu_torch.models.generate import SamplingConfig, TextGenerator
from rag_dpo_tpu_torch.serving import ContinuousDriver, ContinuousEngine
from rag_dpo_tpu_torch.serving.continuous import divergence_gap
from test_torch_decoder import jax_params, port_config

CFG = DecoderConfig.tiny(num_heads=4, num_kv_heads=2, dtype=torch.float32)
SAMPLING = SamplingConfig(temperature=0.0, eos_id=2, pad_id=1)
# two tokens whose f32 logits lie this close may swap places between a
# batch of one and a pool (another GEMM shape, another order of sums)
NEAR_TIE = 1e-4
LOGPROB_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    return TextGenerator(CFG, device="cpu")


def _prompt(rng, n, vocab=CFG.vocab_size):
    return rng.integers(4, vocab, (n,)).astype(np.int32)


class SoloTokens(list):
    """A solo run's tokens. Equal to another run's when the tokens are, or
    when they first differ at a near-tie of this run's own logits
    (`divergence_gap` ≤ NEAR_TIE): the pool's rule (ROADMAP C-29)."""

    def __init__(self, tokens, gen, prompt, sampling, temperature, seed):
        super().__init__(tokens)
        self._args = (gen, prompt, sampling, temperature, seed)

    def __eq__(self, other):
        if list.__eq__(self, list(other)):
            return True
        gen, prompt, sampling, temperature, seed = self._args
        return divergence_gap(gen, prompt, list(self), list(other),
                              sampling, temperature, seed) <= NEAR_TIE

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = None


def solo(gen, ids, max_new, temperature=0.0, seed=None, eos=2, pad=1,
         top_p=1.0):
    """The request's tokens from the port's solo `generate_ids`, cut at
    the first EOS or pad, as a `SoloTokens`."""
    sampling = SamplingConfig(temperature=temperature, eos_id=eos,
                              pad_id=pad, max_new_tokens=max_new,
                              top_p=top_p)
    out = gen.generate_ids(ids[None], np.asarray([len(ids)], np.int32),
                           sampling,
                           rng_seeds=None if seed is None else [seed])[0]
    toks = []
    for t in out:
        if int(t) in (eos, pad):
            break
        toks.append(int(t))
    return SoloTokens(toks, gen, ids, sampling, temperature,
                      0 if seed is None else seed)


# ------------------------------------------------------------ JAX parity
JCFG = JDecoderConfig.tiny(num_heads=4, num_kv_heads=2, dtype=jnp.float32)
POOL = dict(slots=2, chunk=2, prefill_chunk=8, prefix_cache=2,
            prefix_block=4, preemption=True)


def staggered(eng) -> tuple:
    """One arrival schedule, driven step by step: returns each request's
    prompt, tokens and logprobs and the engine's counters."""
    rng = np.random.default_rng(5)
    base = _prompt(rng, 13)
    prompts = {"a": _prompt(rng, 6), "b": base,
               "c": np.concatenate([base[:8], _prompt(rng, 4)]),
               "d": _prompt(rng, 5), "e": _prompt(rng, 7),
               "f": _prompt(rng, 9)}
    rids = {"a": eng.submit(prompts["a"], 6, 10),
            "b": eng.submit(base, 13, 6, logprobs=3)}   # chunked prefill
    eng.step()
    # c shares b's first two prefix blocks
    rids["c"] = eng.submit(prompts["c"], 12, 6,
                           logit_bias={7: 4.0, 9: -100.0})
    eng.step()
    eng.step()
    rids["d"] = eng.submit(prompts["d"], 5, 5, priority=-1,
                           frequency_penalty=0.5, presence_penalty=0.3)
    eng.step()                                  # preempts a pool member
    rids["e"] = eng.submit(prompts["e"], 7, 20)
    for _ in range(3):
        eng.step()
    eng.cancel(rids["e"])
    rids["f"] = eng.submit(prompts["f"], 9, 8)  # reuses a freed slot
    eng.run()
    return (prompts, {k: list(eng.result(r).tokens) for k, r in rids.items()},
            {k: eng.result(r).logprobs for k, r in rids.items()},
            dict(eng.stats))


@pytest.fixture(scope="module")
def twin_runs():
    """The schedule through the JAX engine and the port's, on the same
    JAX-exported weights."""
    params = jax_params(JCFG, seed=3)
    jgen = JTextGenerator(JCFG, params=jax.tree.map(jnp.asarray, params))
    jeng = JEngine(jgen, sampling=JSamplingConfig(temperature=0.0, eos_id=2,
                                                  pad_id=1), **POOL)
    tgen = TextGenerator(port_config(JCFG), params=params, device="cpu")
    teng = ContinuousEngine(tgen, sampling=SAMPLING, **POOL)
    return staggered(jeng), staggered(teng), tgen


def test_schedule_exercises_every_pool_feature(twin_runs):
    (_, _, _, jstats), (_, _, _, tstats), _ = twin_runs
    assert jstats["prefix_hits"] >= 1 and jstats["preempted"] >= 1
    assert jstats["cancelled"] == 1 and jstats["prefill_segments"] >= 2
    assert jstats["admitted"] > 6          # a resumed request admits again
    assert tstats["prefix_hits"] == jstats["prefix_hits"]


@pytest.mark.parametrize("key", ["admitted", "prefix_hits",
                                 "prefix_saved_tokens", "preempted",
                                 "cancelled", "prefill_segments", "steps",
                                 "tokens", "occupancy_sum"])
def test_counters_equal_jax(twin_runs, key):
    (_, _, _, jstats), (_, _, _, tstats), _ = twin_runs
    assert tstats[key] == jstats[key], (key, tstats, jstats)


@pytest.mark.parametrize("req", list("abcdef"))
def test_greedy_tokens_equal_jax_up_to_near_ties(twin_runs, req):
    (prompts, jtok, _, _), (_, ttok, _, _), tgen = twin_runs
    want, got = jtok[req], ttok[req]
    gap = divergence_gap(tgen, prompts[req], got, want, SAMPLING)
    assert gap <= NEAR_TIE, (req, gap, want, got)
    if req != "e":                       # e was cancelled mid-decode
        assert got, req


def test_logprobs_equal_jax(twin_runs):
    (_, jtok, jlp, _), (_, ttok, tlp, _), _ = twin_runs
    assert len(tlp["b"]) == len(ttok["b"]) > 0
    for k in jlp:
        n = next((i for i, (x, y) in enumerate(zip(jtok[k], ttok[k]))
                  if x != y), min(len(jtok[k]), len(ttok[k])))
        for (jl, jtop), (tl, ttop) in list(zip(jlp[k], tlp[k]))[:n]:
            assert abs(jl - tl) <= LOGPROB_TOL
            assert len(jtop) == len(ttop) == 3
            np.testing.assert_allclose([v for _, v in ttop],
                                       [v for _, v in jtop],
                                       atol=LOGPROB_TOL)
            assert [i for i, _ in ttop] == [i for i, _ in jtop] \
                or np.ptp([v for _, v in jtop]) < LOGPROB_TOL


def test_bias_and_penalties_shape_the_run(twin_runs):
    """c's −100 bans its token and d's penalties hold in both engines."""
    (_, jtok, _, _), (_, ttok, _, _), _ = twin_runs
    for toks in (jtok, ttok):
        assert 9 not in toks["c"]


# -------------------------------------------------- the port's own runs
def test_sampled_requests_in_the_staggered_pool_equal_their_solo(gen):
    """Sampled requests (their own seeds) beside greedy ones, joining late,
    through chunked prefill and a prefix-cache hit: each equals its solo
    `generate_ids` with that seed."""
    rng = np.random.default_rng(8)
    base = _prompt(rng, 13)
    reqs = [(base, 8, 0.9, 11), (_prompt(rng, 6), 10, 0.0, None),
            (np.concatenate([base[:8], _prompt(rng, 5)]), 7, 1.2, 12),
            (_prompt(rng, 9), 9, 0.7, 13)]
    eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=3,
                           prefill_chunk=8, prefix_cache=2, prefix_block=4)
    rids = []
    for i, (ids, m, t, s) in enumerate(reqs):
        rids.append(eng.submit(ids, len(ids), m, temperature=t, seed=s))
        if i == 1:
            eng.step()
    results = eng.run()
    assert eng.stats["prefix_hits"] == 1
    for rid, (ids, m, t, s) in zip(rids, reqs):
        assert results[rid] == solo(gen, ids, m, t, s), rid


def test_slot_reuse_after_a_longer_request_sees_no_stale_rows(gen):
    """A slot whose previous occupant ran far longer (its cache rows reach
    past the newcomer's whole run) serves a short request exactly: the
    causal mask hides the stale rows, nothing zeroes them."""
    rng = np.random.default_rng(9)
    long_ids, short_ids = _prompt(rng, 30), _prompt(rng, 4)
    eng = ContinuousEngine(gen, slots=1, sampling=SAMPLING, chunk=4)
    r1 = eng.submit(long_ids, len(long_ids), 40)
    eng.run()
    k = eng._carry.caches[0]["k"]
    assert k[0, 30:60].abs().sum() > 0          # the long run's rows stay
    r2 = eng.submit(short_ids, len(short_ids), 6)
    results = eng.run()
    assert results[r1] == solo(gen, long_ids, 40)
    assert results[r2] == solo(gen, short_ids, 6)


def test_pool_tensors_are_allocated_once(gen):
    """Admission copies into the pool in place and release touches no
    cache row: the pool's tensors are the ones made at construction."""
    rng = np.random.default_rng(10)
    eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=2,
                           prefix_cache=2, prefix_block=4)
    ptrs = [t.data_ptr() for layer in eng._carry.caches
            for t in layer.values()]
    state = [eng._counts.data_ptr(), eng._bias.data_ptr(),
             eng._temps.data_ptr()]
    for n in (5, 9, 13, 6, 11):
        eng.submit(_prompt(rng, n), n, 5, frequency_penalty=0.2,
                   logit_bias={5: 1.0})
        eng.step()
    eng.run()
    assert eng.stats["admitted"] == 5
    assert ptrs == [t.data_ptr() for layer in eng._carry.caches
                    for t in layer.values()]
    assert state == [eng._counts.data_ptr(), eng._bias.data_ptr(),
                     eng._temps.data_ptr()]


@pytest.mark.parametrize("speculative", [False, True])
def test_logprobs_are_computed_only_while_a_resident_asks(
        gen, monkeypatch, speculative):
    """The full-vocab log-softmax and top-k run on a pool step only while
    some resident asked for logprobs; skipping them changes no token."""
    import rag_dpo_tpu_torch.models.generate as generate_mod
    import rag_dpo_tpu_torch.serving.continuous as continuous_mod

    calls = []
    real = generate_mod.sampling_logprobs

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(generate_mod, "sampling_logprobs", counting)
    monkeypatch.setattr(continuous_mod, "sampling_logprobs", counting)
    rng = np.random.default_rng(12)
    plain_ids, lp_ids = _prompt(rng, 7), _prompt(rng, 5)

    def run(with_logprobs):
        eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=2,
                               speculative=speculative, draft_len=3)
        rid = eng.submit(plain_ids, len(plain_ids), 8)
        if with_logprobs:
            eng.submit(lp_ids, len(lp_ids), 3, logprobs=2)
        return eng.run()[rid]

    alone = run(False)
    assert not calls
    beside = run(True)
    assert calls
    assert alone == beside == solo(gen, plain_ids, 8)


def test_prompt_bucketing_bounds_prefill_widths():
    """Prompts prefill at their length bucket: four lengths that bucket to
    32 prefill at width 32 (plus the engine's 8-token dtype probe)."""
    fresh = TextGenerator(CFG, device="cpu")
    widths = []
    prefill = fresh._prefill

    def recording(ids, lengths, cache_len=None):
        widths.append(ids.shape[1])
        return prefill(ids, lengths, cache_len)

    fresh._prefill = recording
    rng = np.random.default_rng(4)
    eng = ContinuousEngine(fresh, slots=2, sampling=SAMPLING, chunk=2)
    for n in (3, 7, 19, 30):
        eng.submit(_prompt(rng, n), n, 2)
    eng.run()
    assert set(widths) == {8, 32}


def _oracle_table(gen, prompts, max_new):
    L = CFG.max_seq_len
    tab = np.ones((len(prompts), L), np.int64)
    for r, p in enumerate(prompts):
        raw = gen.generate_ids(p[None], np.asarray([len(p)], np.int32),
                               SamplingConfig(temperature=0.0, eos_id=2,
                                              pad_id=1,
                                              max_new_tokens=max_new))[0]
        tab[r, :len(p)] = p
        tab[r, len(p):len(p) + max_new] = raw
    keys = torch.as_tensor(np.stack([p[:4] for p in prompts]))
    return torch.as_tensor(tab), keys


def _device_oracle(table, keys, k):
    """A draft source on the pool's device: each slot's own solo
    continuation at its position (full acceptance)."""
    L = table.shape[1]

    def oracle(ids_buf, cur):
        m = (ids_buf[:, None, :4] == keys[None]).all(-1)
        r = m.to(torch.int64).argmax(dim=1)
        src = cur[:, None] + torch.arange(k)[None, :]
        return table[r].gather(1, src.clamp(0, L - 1))

    return oracle


@pytest.mark.parametrize("temperature", [0.0, 1e-4])
def test_device_oracle_drafts_compress_dispatches(gen, temperature):
    """device_draft_fn feeding each slot its solo continuation drives full
    acceptance: 24 tokens in ≤ 3 dispatches of chunk·(1+K) = 12, outputs
    equal solo. At temperature 1e-4 the truncated target is a near point
    mass, so speculative SAMPLING accepts the same drafts."""
    rng = np.random.default_rng(25)
    prompts = [_prompt(rng, 6), _prompt(rng, 9)]
    max_new, k = 24, 5
    table, keys = _oracle_table(gen, prompts, max_new)
    eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=2,
                           speculative=True, draft_len=k,
                           device_draft_fn=_device_oracle(table, keys, k))
    rids = [eng.submit(p, len(p), max_new, temperature=temperature)
            for p in prompts]
    results = eng.run()
    for rid, p in zip(rids, prompts):
        assert results[rid] == solo(gen, p, max_new), rid
    assert eng.stats["steps"] <= 3, eng.stats
    assert eng.stats["plain_dispatches"] == 0, eng.stats


def test_adaptive_fallback_on_low_acceptance(gen):
    """Never-accepted drafts (constant pad): the adaptive engine leaves
    speculation after its probe window and decodes the rest plainly,
    outputs equal solo through the switch."""
    rng = np.random.default_rng(31)
    prompts = [_prompt(rng, 7), _prompt(rng, 5)]
    max_new, k = 24, 4
    bad = lambda buf, cur: torch.ones((buf.shape[0], k),  # noqa: E731
                                      dtype=torch.int64)
    eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=2,
                           speculative=True, draft_len=k,
                           device_draft_fn=bad, adaptive=True,
                           spec_probe=2, spec_hold=4)
    rids = [eng.submit(p, len(p), max_new) for p in prompts]
    results = eng.run()
    for rid, p in zip(rids, prompts):
        assert results[rid] == solo(gen, p, max_new), rid
    assert eng.stats["plain_dispatches"] > 0, eng.stats
    assert eng.stats["spec_dispatches"] >= 2, eng.stats


def test_engine_warm_leaves_no_trace(gen):
    """warm() runs a throwaway request per bucket with speculation on and
    off, then restores counters, prefix entries and the adaptive posture;
    later requests still equal solo."""
    eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=2,
                           speculative=True, draft_len=3, prefix_cache=4,
                           prefix_block=8, prefill_chunk=16)
    eng.warm(prompt_buckets=(16, 32))
    assert eng.stats == dict.fromkeys(eng.stats, 0)
    assert not eng._pentries and not eng._phash and not eng._requests
    assert eng._spec_mode and eng._accept_ema is None
    ids = _prompt(np.random.default_rng(15), 20)
    rid = eng.submit(ids, len(ids), 6)
    assert eng.run()[rid] == solo(gen, ids, 6)


BLK = 8


@pytest.mark.parametrize("host", [False, True])
def test_prefix_entries_hold_only_the_prefix_rows(gen, host):
    """Entries hold [1, prefix, ...] slices (not full-context rows): on the
    pool's device, or in host memory (pinned when the pool is on a card);
    hits and outputs are the same either way."""
    rng = np.random.default_rng(8)
    shared = _prompt(rng, 2 * BLK)
    reqs = [(np.concatenate([shared, _prompt(rng, n)]), m)
            for n, m in ((5, 6), (9, 6), (3, 8))]
    eng = ContinuousEngine(gen, slots=2, sampling=SAMPLING, chunk=2,
                           prefix_cache=4, prefix_block=BLK,
                           prefix_cache_host=host)
    rids = [eng.submit(ids, len(ids), m) for ids, m in reqs]
    results = eng.run()
    for rid, (ids, m) in zip(rids, reqs):
        assert results[rid] == solo(gen, ids, m), rid
    assert eng.stats["prefix_hits"] >= 2
    assert eng._pentries
    for entry in eng._pentries.values():
        layers = entry["kv_host" if host else "kv_dev"]
        assert len(layers) == CFG.num_layers
        for t in (t for layer in layers for t in layer.values()):
            assert t.shape[1] == entry["len"] < CFG.max_seq_len
            assert t.device.type == "cpu"


@pytest.mark.parametrize("host", [False, True])
def test_entry_longer_than_the_borrowers_window(gen, host):
    """An entry of four 16-token blocks serves a request that shares only
    its first block and has a short suffix: the borrower's row (one block
    + a 32-token suffix bucket) is shorter than the entry, so only the
    rows that fit are copied."""
    rng = np.random.default_rng(13)
    donor = _prompt(rng, 70)
    short = np.concatenate([donor[:16], _prompt(rng, 3)])
    eng = ContinuousEngine(gen, slots=1, sampling=SAMPLING, chunk=2,
                           prefix_cache=2, prefix_block=16,
                           prefix_cache_host=host)
    rd = eng.submit(donor, len(donor), 4)
    eng.run()
    assert next(iter(eng._pentries.values()))["len"] == 64
    rs = eng.submit(short, len(short), 6)
    eng.run()
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_saved_tokens"] == 16
    assert eng.result(rd).tokens == solo(gen, donor, 4)
    assert eng.result(rs).tokens == solo(gen, short, 6)


def test_int8_kv_pool_parity_with_speculation_prefix_cache_chunking():
    """The int8 KV cache under the whole pool (speculation, host prefix
    entries, chunked prefill) equals each request's solo int8 run; host
    entries carry the scale rows too."""
    qgen = TextGenerator(dataclasses.replace(CFG, quantize_kv=True),
                         device="cpu")
    rng = np.random.default_rng(3)
    shared = _prompt(rng, 2 * BLK)
    reqs = [(np.concatenate([shared, _prompt(rng, n)]), m)
            for n, m in ((5, 8), (11, 6), (3, 10), (7, 7))]
    eng = ContinuousEngine(qgen, slots=2, sampling=SAMPLING, chunk=2,
                           speculative=True, draft_len=3, ngram=2,
                           prefix_cache=4, prefix_block=BLK,
                           prefix_cache_host=True, prefill_chunk=BLK)
    rids = [eng.submit(ids, len(ids), m) for ids, m in reqs]
    results = eng.run()
    for rid, (ids, m) in zip(rids, reqs):
        assert results[rid] == solo(qgen, ids, m), rid
    assert eng.stats["prefix_hits"] >= 2
    for entry in eng._pentries.values():
        layer = entry["kv_host"][0]
        assert set(layer) == {"k", "k_scale", "v", "v_scale"}
        assert layer["k"].dtype == torch.int8


def test_divergence_gap_measures_the_first_difference(gen):
    """The rule's measure: 0 for equal runs; at a forced difference, the
    gap between the top logit and the other token's."""
    rng = np.random.default_rng(12)
    ids = _prompt(rng, 7)
    want = list(solo(gen, ids, 6))
    assert divergence_gap(gen, ids, want, want, SAMPLING) == 0.0
    other = want[:3] + [(want[3] + 1) % CFG.vocab_size] + want[4:]
    gap = divergence_gap(gen, ids, want, other, SAMPLING)
    model = gen.load()
    with torch.no_grad():
        logits = model(torch.as_tensor(
            np.concatenate([ids, want[:3]]), dtype=torch.int64)[None])
    row = logits[0, -1]
    assert gap == pytest.approx(float(row.max() - row[other[3]]),
                                abs=1e-5)
    assert gap > NEAR_TIE
    assert solo(gen, ids, 6) != other


def test_multimodal_prefixes_raise_naming_item_8(gen):
    """The embeds paths, which raised naming item 8 until the vision
    model came, now serve: a prefix of a prompt's own embedding rows
    decodes through each of them as the prompt's ids do."""
    eng = ContinuousEngine(gen, slots=1, sampling=SAMPLING)
    rng = np.random.default_rng(13)
    ids = _prompt(rng, 9)
    rows = torch.from_numpy(gen.embed_ids(ids))
    rid = eng.submit(ids, len(ids), 5)
    eng.run()
    want = eng.result(rid).tokens
    rid = eng.submit_embeds(rows, len(ids), 5)
    eng.run()
    assert eng.result(rid).tokens == want
    driver = ContinuousDriver(eng)
    try:
        assert driver.submit_embeds(rows, len(ids), 5).result() == want
        assert driver.generate_embeds(rows, len(ids), 5) == want
        assert list(driver.generate_embeds_stream(rows, len(ids), 5)) \
            == want
    finally:
        driver.close()
