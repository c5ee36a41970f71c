"""The LLM-judge axis through the port (`scripts/run_judge_axis.py`).

Both packages' `llm_judge_score_choose`, and `EvalHarness` with
`judge_mode="choose"`, over the same tiny decoder (JAX's init exported
into the port, f32) on 4 hermetic questions: the same bucket and veto up
to C-29's near-tie rule (where the choices differ, the port's scores of
both lie within the choose tolerance), the same combined score to 1e-6.
`evals/judge_axis.py::run_judge_axis` on the CPU with a tiny judge: every
question judged, the trace's buckets and vetoes from the choice sets, exit
0; a judge that raises gives None scores, its first exception in the
record, and exit 1.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.evals.harness import EvalConfig as JEvalConfig
from rag_dpo_tpu.evals.harness import EvalHarness as JEvalHarness
from rag_dpo_tpu.evals.harness import (
    llm_judge_score_choose as j_llm_judge_score_choose,
)
from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu.providers.tpu_llm import TPULLMProvider as JTPULLMProvider
from rag_dpo_tpu_torch.evals import load_qa_dataset
from rag_dpo_tpu_torch.evals.harness import (
    JUDGE_CHOOSE_PROMPT,
    JUDGE_SCORE_BUCKETS,
    JUDGE_VETO_PROMPT,
    EvalConfig,
    EvalHarness,
    llm_judge_score_choose,
)
from rag_dpo_tpu_torch.evals.judge_axis import run_judge_axis, verdict
from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider
from test_torch_decoder import jax_params, port_config

SCORE_TOL = 1e-4      # choose scores, as tests/test_torch_tpu_llm.py
WRONG = ("Le délai est de douze mois selon l'article 99, et aucune "
         "notification n'est requise.")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    """The JAX provider and the port's over the same JAX-exported f32
    weights, with room for a judge prompt (1,024 positions)."""
    jcfg = JDecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                               dtype=jnp.float32, max_seq_len=1024)
    params = jax_params(jcfg, seed=4)
    jllm = JTPULLMProvider(jcfg, params=jax.tree.map(jnp.asarray, params),
                           max_new_tokens=8)
    tllm = TPULLMProvider(port_config(jcfg), params=params,
                          max_new_tokens=8, device="cpu")
    return jllm, tllm


@pytest.fixture(scope="module")
def cases():
    """4 hermetic questions, each with its expected summary as the answer
    or a wrong one."""
    items = load_qa_dataset()[:4]
    return [(item, item["expected_answer_summary"] if i % 2 else WRONG)
            for i, item in enumerate(items)]


def _prompts(item, answer):
    fields = dict(question=item["question"],
                  expected=item.get("expected_answer_summary", ""),
                  answer=answer[:6000])
    return {"bucket": (JUDGE_CHOOSE_PROMPT.format(**fields),
                       list(JUDGE_SCORE_BUCKETS)),
            "veto": (JUDGE_VETO_PROMPT.format(**fields), ["non", "oui"])}


def _same_up_to_near_ties(twins, item, answer, jt, tt) -> bool:
    """The choices both judges made agree, or differ only at a near-tie
    of the port's scores (C-29); the scores agree within SCORE_TOL.
    → whether they agree."""
    jllm, tllm = twins
    agree = True
    for key, (prompt, choices) in _prompts(item, answer).items():
        want, got = jllm.choose(prompt, choices), tllm.choose(prompt, choices)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_TOL)
        chosen = jt[key] if key == "bucket" else ("oui" if jt[key] else "non")
        mine = tt[key] if key == "bucket" else ("oui" if tt[key] else "non")
        assert (chosen, mine) == (want[0], got[0])
        if mine != chosen:
            gap = abs(got[1][choices.index(mine)]
                      - got[1][choices.index(chosen)])
            assert gap <= SCORE_TOL, (key, mine, chosen, gap)
            agree = False
    return agree


def test_choose_judge_matches_jax(twins, cases):
    jllm, tllm = twins
    n_agree = 0
    for item, answer in cases:
        jt, tt = {}, {}
        want = j_llm_judge_score_choose(jllm, item, answer, trace=jt)
        got = llm_judge_score_choose(tllm, item, answer, trace=tt)
        assert want is not None and got is not None
        assert tt["bucket"] in JUDGE_SCORE_BUCKETS
        if _same_up_to_near_ties(twins, item, answer, jt, tt):
            n_agree += 1
            assert abs(got - want) <= 1e-6
    assert n_agree >= 3


class _Answers:
    """A pipeline stub answering each question with a fixed text."""

    def __init__(self, answers):
        self.answers = answers

    def query(self, question, **_):
        return types.SimpleNamespace(
            answer=self.answers[question], grounded=True,
            grounding_issues=[], total_time=0.0, intent="factuel",
            sources=[{"title": "Notifier une violation",
                      "url": "https://cnil.fr/fr/violations"}])


def test_harness_choose_mode_matches_jax(twins, cases):
    jllm, tllm = twins
    items = [item for item, _ in cases]
    pipe = _Answers({item["question"]: answer for item, answer in cases})
    want = JEvalHarness(pipe, judge_llm=jllm, config=JEvalConfig(
        use_llm_judge=True, judge_mode="choose")).run(items)
    got = EvalHarness(pipe, judge_llm=tllm, config=EvalConfig(
        use_llm_judge=True, judge_mode="choose")).run(items)
    n_agree = 0
    for (item, answer), w, g in zip(cases, want["results"], got["results"]):
        assert g["judge_score"] is not None and w["judge_score"] is not None
        jt, tt = {}, {}
        j_llm_judge_score_choose(jllm, item, answer, trace=jt)
        llm_judge_score_choose(tllm, item, answer, trace=tt)
        if not _same_up_to_near_ties(twins, item, answer, jt, tt):
            continue
        n_agree += 1
        for key in ("judge_score", "correctness", "global_score"):
            assert abs(g[key] - w[key]) <= 1e-6, key
    assert n_agree >= 3
    if n_agree == len(cases):
        assert abs(got["global_score"] - want["global_score"]) <= 1e-6


def test_run_judge_axis_judges_every_question(twins):
    _, tllm = twins
    record = run_judge_axis(tllm, n_questions=4, device="cpu")
    assert record["n_questions"] == record["n_judged_non_null"] == 4
    assert record["first_judge_error"] is None
    assert record["judge_calls"] == 2 * 4   # in the run, not the trace
    assert record["judge_seconds"] > 0 and record["device"] == {"name": "cpu"}
    assert len(record["bucket_sample"]) == len(record["veto_sample"]) == 4
    assert set(record["bucket_sample"]) <= set(JUDGE_SCORE_BUCKETS)
    assert set(record["veto_sample"]) <= {"non", "oui"}
    assert record["judge_vetoes_sample"] == record["veto_sample"].count("oui")
    assert 0.0 <= record["judge_mean"] <= 1.0
    assert verdict(record)[0] == 0


class _Failing:
    def choose(self, prompt, choices):
        raise RuntimeError("the judge's card is gone")


def test_run_judge_axis_fails_on_a_none_score():
    record = run_judge_axis(_Failing(), n_questions=2, device="cpu")
    assert record["n_judged_non_null"] == 0
    assert "the judge's card is gone" in record["first_judge_error"]
    assert record["bucket_sample"] == [None, None]
    code, line = verdict(record)
    assert code == 1 and "INCOMPLETE" in line
