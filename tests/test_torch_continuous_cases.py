"""The JAX test files' cases of the continuous slot pool, run on the port.

Each case below is the JAX test function itself, called with its module's
names bound to the port's counterparts on the CPU: the engine, driver and
`DeadlineExceeded`, `TextGenerator` / `TPULLMProvider` / `create_tpu_llm` /
`create_llm` / `build_system` / `build_demo_stack` with `device="cpu"`, the
port's server, providers, tagger and query logger, and a tiny config of the
same widths. The cases' own imports inside their bodies resolve to the same
port modules (`sys.modules` entries patched for the call).

Every decoder those cases build starts from the JAX module's own init of
its config and seed (`init_random_` patched to load it), so the token
streams the cases' data choices rest on (a run long enough to cancel, an
EOS the speculative cut must meet) are JAX's. The solo oracles (`_solo`,
`_solo_sampled`) return `SoloTokens`: a pool's
run equals them when its tokens are equal, or first differ at a near-tie of
the solo run's logits (ROADMAP C-29, `test_torch_continuous.NEAR_TIE`).

The image cases (`test_server.py`'s chat completions with an image,
`test_advisor_r4_fixes.py`'s vision budget and error kinds,
`test_providers_extra.py`'s image classifier, and the
`test_real_weights_rehearsal.py` run of every converter → boot → `/query`
and a vision chat, with the port's `convert_weights` in place of
`scripts/convert_weights.py`) run the same way: `rag_dpo_tpu.models.vit`'s
`ViTConfig` is bound to the port's (the JAX dtypes mapped), and the
rehearsal's encoders, index, reranker and stack are the port's on the CPU.

Cases not here are in `tests/test_torch_continuous.py` (those whose bodies
use jax draft sources, compiled-program tables or the JAX prefix-entry
layout). `test_engine_with_tp_sharded_params_matches_solo` needs a mesh of
processes, so its port runs its body's steps on 2 gloo ranks
(`tests/torch_ranks.py`): the engine over each rank's TP-sharded
generator, every request against its unsharded solo run.
"""

import dataclasses
import functools
import inspect
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rag_dpo_tpu_torch.app.demo as tdemo
import rag_dpo_tpu_torch.bootstrap as tbootstrap
import rag_dpo_tpu_torch.ingest.images as timages
import rag_dpo_tpu_torch.ingest.indexer as tindexer
import rag_dpo_tpu_torch.models as tmodels
import rag_dpo_tpu_torch.models.convert as tconvert
import rag_dpo_tpu_torch.models.convert_weights as tconvert_weights
import rag_dpo_tpu_torch.models.generate as tgenerate
import rag_dpo_tpu_torch.models.vit as tvit
import rag_dpo_tpu_torch.app.server as tserver
import rag_dpo_tpu_torch.ingest.tagging as ttagging
import rag_dpo_tpu_torch.providers as tproviders
import rag_dpo_tpu_torch.retrieval.reranker as treranker
import rag_dpo_tpu_torch.providers.base as tbase
import rag_dpo_tpu_torch.providers.factory as tfactory
import rag_dpo_tpu_torch.serving as tserving
import rag_dpo_tpu_torch.serving.continuous as tcontinuous
import rag_dpo_tpu_torch.utils.paths as tpaths
import rag_dpo_tpu_torch.utils.query_logger as tqlog
from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu.models.decoder import DecoderModel as JDecoderModel
from rag_dpo_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderModel,
    load_decoder_params,
)
from rag_dpo_tpu_torch.models.generate import SamplingConfig, TextGenerator
from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider
from test_torch_continuous import SoloTokens
from test_torch_decoder import port_config

import test_advisor_r4_fixes
import test_continuous
import test_deadlines
import test_kv_quant
import test_logit_bias
import test_logprobs
import test_penalties
import test_prefix_cache
import test_priority
import test_providers_extra
import test_real_weights_rehearsal
import test_sampling
import test_seeds
import test_server
import test_serving_stress

CASES = {
    test_continuous: [
        "test_engine_matches_solo_generation",
        "test_late_join_and_slot_reuse",
        "test_budget_frees_slot_immediately",
        "test_streaming_callback_fires_per_token",
        "test_driver_concurrent_callers_match_single_stream",
        "test_provider_continuous_mode",
        "test_driver_stream_matches_blocking",
        "test_mixed_pool_greedy_rows_unaffected_by_sampled_neighbors",
        "test_sampled_requests_are_independent_across_submissions",
        "test_sampled_rows_ride_the_speculative_pool",
        "test_provider_sampled_calls_ride_the_pool",
        "test_speculative_engine_matches_solo",
        "test_speculative_slot_reuse_matches_solo",
        "test_speculative_pool_acceleration_with_oracle_drafts",
        "test_adaptive_oscillation_is_lossless",
        "test_chunked_prefill_matches_solo",
        "test_chunked_prefill_interleaves_decode",
        "test_chunked_prefill_composes_with_prefix_cache",
        "test_chunked_prefill_rides_the_speculative_pool",
        "test_speculative_eos_cut_matches_solo",
        "test_provider_continuous_speculative_matches_direct",
        "test_provider_stream_rides_continuous_pool",
        "test_driver_step_failure_fails_callers_instead_of_hanging",
        "test_driver_bad_request_fails_only_its_caller",
        "test_factory_decode_chunk_reaches_engine",
        "test_raising_on_token_fails_only_its_request",
        "test_close_fails_pending_and_inflight_callers",
        "test_driver_warm_runs_on_driver_thread_and_pool_still_serves",
        "test_cancel_active_frees_slot_and_neighbor_unaffected",
        "test_cancel_queued_request_never_admits",
        "test_cancel_during_chunked_prefill",
        "test_cancel_under_speculation_slot_reuse_clean",
        "test_driver_handle_cancel_returns_partial",
        "test_stream_close_cancels_request",
        "test_provider_stream_close_cancels_continuous_request",
        "test_spec_sampling_mixed_pool_keeps_greedy_parity",
    ],
    test_deadlines: [
        "test_deadline_expiry_returns_partial_and_frees_slot",
        "test_deadline_neighbor_unaffected",
        "test_queue_wait_counts_against_deadline",
        "test_handle_timed_out_flag_and_no_deadline_never_expires",
        "test_invalid_deadline_rejected",
        "test_provider_timeout_returns_partial_in_band",
        "test_provider_stream_timeout_raises_after_partial",
        "test_server_generate_timeout_field",
    ],
    test_prefix_cache: [
        "test_shared_prefix_hit_matches_solo",
        "test_identical_prompt_reuses_all_but_last_partial_block",
        "test_exact_block_multiple_prompt_leaves_one_suffix_token",
        "test_partial_block_overlap_is_a_miss",
        "test_lru_eviction_bounds_entries_and_stays_correct",
        "test_cached_entry_serves_shorter_prefix_of_longer_prompt",
        "test_prefix_cache_composes_with_speculative",
        "test_store_on_hit_extends_the_cached_chain",
        "test_host_mode_composes_with_chunked_prefill_and_speculation",
        "test_provider_prefix_cache_serves_shared_system_prompt",
    ],
    test_priority: [
        "test_priority_admission_order",
        "test_aging_prevents_starvation",
        "test_preemption_resumes_bit_identically",
        "test_preempt_pin_bounds_thrash",
        "test_preemption_under_speculation",
        "test_preemption_spares_prefix_cache",
        "test_background_pipelines_mark_their_class",
        "test_driver_threads_priority_through",
    ],
    test_penalties: [
        "test_huge_presence_penalty_forbids_repeats",
        "test_zero_penalties_bitwise_parity",
        "test_frequency_penalty_mounts_with_repetition",
        "test_penalized_slot_in_spec_pool_neighbors_keep_speculating",
        "test_penalty_counts_survive_preemption",
        "test_negative_penalties_gate_speculation_too",
    ],
    test_logit_bias: [
        "test_ban_and_force",
        "test_none_and_empty_are_noops",
        "test_biased_neighbor_does_not_perturb",
        "test_spec_pool_matches_plain_pool",
        "test_sampled_bias_reproducible",
        "test_validation",
        "test_provider_and_http_surface",
        "test_review_fixes_bias_http",
    ],
    test_logprobs: [
        "test_greedy_logprobs_align_and_top1",
        "test_logprobs_do_not_change_tokens",
        "test_sampled_logprobs_reproducible",
        "test_spec_pool_logprobs_match_plain",
        "test_logprobs_with_bias_reflect_adjustment",
        "test_validation_and_provider_surface",
        "test_http_chat_logprobs",
        "test_review_fixes_http_contracts",
    ],
    test_kv_quant: ["test_factory_quantize_kv_flag"],
    test_sampling: ["test_pool_sampled_rows_respect_top_p",
                    "test_provider_top_p_plumbing"],
    test_seeds: [
        "test_pool_sampled_request_is_pure_function_of_seed",
        "test_same_seed_reproduces_different_seed_differs",
        "test_sampled_request_survives_preemption_bit_identically",
        "test_spec_pool_sampled_seed_reproduces",
        "test_provider_seed_reproduces_on_continuous_scheduler",
    ],
    test_serving_stress: ["test_randomized_abort_traffic"],
    test_server: ["test_stats_exposes_decode_pool_for_continuous_llm",
                  "test_penalties_over_http",
                  "test_openai_multimodal_image_content",
                  "test_openai_vision_true_streaming"],
    test_providers_extra: ["test_factory_tpu_mode_schedulers_and_spec",
                           "test_image_classifier_vision_path",
                           "test_image_classifier_default_keeps",
                           "test_image_manifest_filtering"],
    test_advisor_r4_fixes: ["test_logprobs_never_cross_the_stop_cut",
                            "test_vision_budget_reserves_draft_window",
                            "test_input_errors_carry_error_kind"],
    test_real_weights_rehearsal: [
        "test_convert_boot_query_vision_rehearsal"],
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _on_cpu(fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        kwargs.setdefault("device", "cpu")
        return fn(*args, **kwargs)

    return call


def _port_cfg(cfg):
    return cfg if isinstance(cfg, DecoderConfig) else port_config(cfg)


def _generator(config, params=None, **kwargs):
    return TextGenerator(_port_cfg(config), params=params, device="cpu",
                         **kwargs)


_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_JAX_INITS: dict = {}


def _jax_init_(model, generator):
    """`init_random_`'s stand-in: the JAX module's init of the same config
    and seed, as the JAX `TextGenerator.load` makes it."""
    kw = {f.name: getattr(model.config, f.name)
          for f in dataclasses.fields(model.config)}
    kw["dtype"] = _JAX_DTYPE[kw["dtype"]]
    kw["param_dtype"] = _JAX_DTYPE[kw["param_dtype"]]
    key = (tuple(sorted(kw.items(), key=str)), generator.initial_seed())
    if key not in _JAX_INITS:
        params = JDecoderModel(JDecoderConfig(**kw)).init(
            jax.random.key(generator.initial_seed()),
            jnp.zeros((1, 8), jnp.int32))
        _JAX_INITS[key] = jax.tree.map(np.asarray, params)
    return load_decoder_params(model, _JAX_INITS[key])


class _ViTConfig:
    """`rag_dpo_tpu.models.vit.ViTConfig` as the cases call it, making the
    port's config (JAX dtypes mapped to torch's)."""

    @staticmethod
    def _kw(kw):
        return {k: {jnp.float32: torch.float32,
                    jnp.bfloat16: torch.bfloat16}.get(v, v)
                for k, v in kw.items()}

    @classmethod
    def tiny(cls, **kw):
        return tvit.ViTConfig.tiny(**cls._kw(kw))

    @classmethod
    def clip_vit_l_336(cls, **kw):
        return tvit.ViTConfig.clip_vit_l_336(**cls._kw(kw))


def _cpu_class(cls):
    """A subclass of a port class whose `device` defaults to the CPU."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        cls.__init__(self, *args, **kwargs)

    return type(cls.__name__, (cls,), {"__init__": __init__})


def _port_convert(kind, snapshot, out):
    """The rehearsal's `_convert`, through the port's converter."""
    assert tconvert_weights.main([kind, str(snapshot), str(out)]) == 0
    return out


class CpuTPULLMProvider(TPULLMProvider):
    """The port's provider on the CPU; `params` may be another provider's
    loaded model (the JAX cases share weights so), whose weights are
    copied."""

    def __init__(self, config=None, params=None, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        shared = params if isinstance(params, DecoderModel) else None
        super().__init__(None if config is None else _port_cfg(config),
                         None if shared is not None else params, *args,
                         **kwargs)
        if shared is not None:
            self.generator.load().load_state_dict(shared.state_dict())


def _shim(name, real, **overrides):
    mod = types.ModuleType(name)
    mod.__dict__.update({k: v for k, v in vars(real).items()
                         if not k.startswith("__")})
    mod.__dict__.update(overrides)
    return mod


def _near_tie_solo(orig, temperature_arg=None):
    """Wrap a JAX test file's solo oracle: same tokens, held by the
    near-tie rule."""

    def solo(gen, ids, *args):
        toks = orig(gen, ids, *args)
        temp, seed = (args[1], args[2]) if temperature_arg else (0.0, 0)
        sampling = SamplingConfig(temperature=temp, eos_id=2, pad_id=1)
        return SoloTokens(toks, gen, ids, sampling, temp, seed)

    return solo


@pytest.fixture
def on_port(monkeypatch):
    """Bind the JAX modules' names, and the modules their bodies import,
    to the port on the CPU for the duration of one case."""
    create_tpu_llm = _on_cpu(tfactory.create_tpu_llm)
    create_llm = _on_cpu(tfactory.create_llm)
    build_system = _on_cpu(tserver.build_system)
    names = {
        "DecoderConfig": DecoderConfig, "DecoderModel": DecoderModel,
        "SamplingConfig": SamplingConfig, "TextGenerator": _generator,
        "ContinuousEngine": tcontinuous.ContinuousEngine,
        "ContinuousDriver": tcontinuous.ContinuousDriver,
        "DeadlineExceeded": tcontinuous.DeadlineExceeded,
        "TPULLMProvider": CpuTPULLMProvider, "create_llm": create_llm,
        "create_tpu_llm": create_tpu_llm, "build_system": build_system,
        "serve": tserver.serve,
        "FakeLLMProvider": tproviders.FakeLLMProvider,
        "LLMResponse": tbase.LLMResponse,
        "ImageClassifier": timages.ImageClassifier,
        "_convert": _port_convert,
    }
    for mod in CASES:
        for name, value in names.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)
        if hasattr(mod, "CFG"):
            monkeypatch.setattr(mod, "CFG", _port_cfg(mod.CFG))
        if hasattr(mod, "SAMPLING"):
            monkeypatch.setattr(mod, "SAMPLING",
                                SamplingConfig(**vars(mod.SAMPLING)))
        if hasattr(mod, "_solo"):
            monkeypatch.setattr(mod, "_solo", _near_tie_solo(mod._solo))
        if hasattr(mod, "_solo_sampled"):
            monkeypatch.setattr(mod, "_solo_sampled", _near_tie_solo(
                mod._solo_sampled, temperature_arg=True))
    modules = {
        "rag_dpo_tpu.serving": tserving,
        "rag_dpo_tpu.serving.continuous": tcontinuous,
        "rag_dpo_tpu.providers": _shim(
            "rag_dpo_tpu.providers", tproviders,
            Embedder=_cpu_class(tproviders.Embedder)),
        "rag_dpo_tpu.providers.base": tbase,
        "rag_dpo_tpu.providers.tpu_llm": _shim(
            "rag_dpo_tpu.providers.tpu_llm",
            sys.modules[TPULLMProvider.__module__],
            TPULLMProvider=CpuTPULLMProvider),
        "rag_dpo_tpu.providers.factory": _shim(
            "rag_dpo_tpu.providers.factory", tfactory,
            create_tpu_llm=create_tpu_llm, create_llm=create_llm),
        "rag_dpo_tpu.app.server": _shim("rag_dpo_tpu.app.server", tserver,
                                        build_system=build_system),
        "rag_dpo_tpu.app.demo": _shim(
            "rag_dpo_tpu.app.demo", tdemo,
            build_demo_stack=_on_cpu(tdemo.build_demo_stack)),
        "rag_dpo_tpu.ingest.tagging": ttagging,
        "rag_dpo_tpu.utils.query_logger": tqlog,
        "rag_dpo_tpu.models.vit": _shim("rag_dpo_tpu.models.vit", tvit,
                                        ViTConfig=_ViTConfig),
        # the rehearsal's components, on the CPU
        "rag_dpo_tpu.models": tmodels,
        "rag_dpo_tpu.models.convert": tconvert,
        "rag_dpo_tpu.retrieval.reranker": _shim(
            "rag_dpo_tpu.retrieval.reranker", treranker,
            CrossEncoderReranker=_cpu_class(
                treranker.CrossEncoderReranker)),
        "rag_dpo_tpu.bootstrap": _shim(
            "rag_dpo_tpu.bootstrap", tbootstrap,
            build_stack=_on_cpu(tbootstrap.build_stack)),
        "rag_dpo_tpu.ingest.indexer": tindexer,
        "rag_dpo_tpu.utils.paths": tpaths,
    }
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(tgenerate, "init_random_", _jax_init_)
    env = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(env)


class _TmpDirs:
    """`tmp_path_factory`'s `mktemp` under one case's `tmp_path`."""

    def __init__(self, root):
        self.root = root

    def mktemp(self, name):
        path = self.root / name
        path.mkdir()
        return path


def _params():
    for mod, names in CASES.items():
        for name in names:
            if name == "test_randomized_abort_traffic":
                for seed in (7, 8):
                    yield pytest.param(mod, name, {"seed": seed},
                                       id=f"{mod.__name__}::{name}[{seed}]")
            else:
                yield pytest.param(mod, name, {},
                                   id=f"{mod.__name__}::{name}")


@pytest.mark.parametrize("mod, name, extra", list(_params()))
def test_jax_case_on_the_port(on_port, tmp_path, monkeypatch, mod, name,
                              extra):
    fn = getattr(mod, name)
    args = {}
    for arg in inspect.signature(fn).parameters:
        if arg == "gen":
            args[arg] = _generator(mod.CFG)
        elif arg == "pool":
            args[arg] = pool = CpuTPULLMProvider(
                DecoderConfig.tiny(), max_new_tokens=8, continuous=True,
                max_batch=2)
        elif arg == "tmp_path":
            args[arg] = tmp_path
        elif arg == "tmp_path_factory":
            args[arg] = _TmpDirs(tmp_path)
        elif arg == "monkeypatch":
            args[arg] = monkeypatch
        else:
            args[arg] = extra[arg]
    try:
        fn(**args)
    finally:
        if "pool" in args:
            pool._driver.close()


# ------------------------------------------ the slot pool over TP params
def _tp_pool_rank(rank, world, params):
    """`test_continuous.py::test_engine_with_tp_sharded_params_matches_solo`
    on one rank of a model axis of `world`."""
    from rag_dpo_tpu_torch.models.generate import SamplingConfig
    from rag_dpo_tpu_torch.models.generate import TextGenerator
    from rag_dpo_tpu_torch.models.sharding import shard_params
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh
    from rag_dpo_tpu_torch.serving.continuous import ContinuousEngine

    mesh = create_mesh(MeshSpec(data=1, model=world, shard=1),
                       device_type="cpu")
    gen_tp = TextGenerator(_TP_CFG, params=shard_params(params, mesh),
                           device="cpu")
    rng = np.random.default_rng(50)
    prompts = [rng.integers(4, _TP_CFG.vocab_size, (n,)).astype(np.int32)
               for n in (9, 5, 12)]
    eng = ContinuousEngine(gen_tp, slots=2, sampling=SamplingConfig(
        temperature=0.0, eos_id=2, pad_id=1), chunk=3)
    rids = [eng.submit(p, len(p), 8) for p in prompts]
    results = eng.run()
    return prompts, [results[r] for r in rids]


_TP_CFG = tgenerate.DecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                                       dtype=torch.float32)


def test_engine_with_tp_sharded_params_matches_solo():
    from test_torch_continuous import solo
    from test_torch_decoder import jax_params
    from torch_ranks import run_ranks

    params = jax_params(JDecoderConfig.tiny(num_heads=4, num_kv_heads=2,
                                            dtype=jnp.float32))
    gen = tgenerate.TextGenerator(_TP_CFG, params=params, device="cpu")
    for prompts, tokens in run_ranks(_tp_pool_rank, 2, params):
        for p, got in zip(prompts, tokens):
            assert solo(gen, p, 8) == got
