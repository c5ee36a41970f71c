"""The traffic generator: every request a function of the seed and its
index, the same set of sizes for every seed, prompts of the stated token
counts that the serving front never cuts."""

import pytest

from portbench import spec
from portbench.reference import tokenizer as tok
from portbench.traffic import Traffic, full_text

SEEDS = (1, 2 ** 31 + 77, 5_000_000_000)


@pytest.mark.parametrize("name", ["context-8c", "agent-16c"])
def test_requests_repeat_for_a_seed(name):
    params = spec.load_traffic(name)
    a, b = Traffic(params, SEEDS[1]), Traffic(params, SEEDS[1])
    assert [a.request(i) for i in range(10)] == \
        [b.request(i) for i in range(10)]
    other = Traffic(params, SEEDS[2])
    assert [a.request(i) for i in range(10)] != \
        [other.request(i) for i in range(10)]


@pytest.mark.parametrize("name", ["context-8c"])
def test_every_seed_gets_the_same_sizes(name):
    params = spec.load_traffic(name)
    strata = params["strata"]
    sets = []
    for seed in SEEDS:
        t = Traffic(params, seed)
        reqs = [t.request(i) for i in range(2 * strata)]
        for block in (reqs[:strata], reqs[strata:]):
            sets.append(sorted((r["prompt_tokens"], r["max_tokens"])
                               for r in block)
                        if params["max_tokens"]["low"] ==
                        params["max_tokens"]["high"] else
                        (sorted(r["prompt_tokens"] for r in block),
                         sorted(r["max_tokens"] for r in block)))
    assert all(s == sets[0] for s in sets)


@pytest.mark.parametrize("name", ["context-8c"])
def test_prompts_hold_their_token_count_uncut(name):
    params = spec.load_traffic(name)
    lo, hi = params["prompt_tokens"]["low"], params["prompt_tokens"]["high"]
    t = Traffic(params, SEEDS[0])
    for i in range(params["strata"]):
        r = t.request(i)
        text = full_text(r)
        n = tok.count(text) + 2
        assert n == r["prompt_tokens"] and lo <= n <= hi
        assert len(text) // 3 + 2 >= n          # the front's width rule
        assert len(tok.generation_prompt(text, 131072, 16384,
                                         r["max_tokens"])) == n


def test_questions_are_reworded_to_their_length():
    params = spec.load_traffic("agent-16c")
    t = Traffic(params, SEEDS[0])
    lengths = [len(t.request(i)["question"].split()) for i in range(48)]
    lo, hi = params["question_words"]["low"], params["question_words"]["high"]
    assert min(lengths) >= lo - 2 and max(lengths) <= hi + 2
    assert len({t.request(i)["base"] for i in range(48)}) == 48


def test_open_loop_arrivals_repeat():
    params = {"loop": "open", "request": "question", "rate": 5.0,
              "burst": 3, "burst_every": 2.0,
              "question_words": {"low": 8, "high": 40}}
    a = Traffic(params, 9).arrivals(10.0)
    assert a == Traffic(params, 9).arrivals(10.0)
    assert a == sorted(a) and a[-1] < 10.0
    assert sum(1 for x in a if x in (2.0, 4.0, 6.0, 8.0)) >= 12
