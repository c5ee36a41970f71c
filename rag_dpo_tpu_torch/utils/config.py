"""Unified typed configuration.

SURVEY.md §5 flags the reference's config as fragmented: `config.yaml` is
only partially read at runtime, most values are duplicated as Python
defaults, and env vars overlay both. Here ONE dataclass tree is the single
source of truth; YAML (or JSON) files and `RAGDPO_*` env vars overlay it
explicitly. The retrieval recipe section carries the reference's tuned
constants (`configs/config.yaml:48-81`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Any


@dataclasses.dataclass
class RetrievalSection:
    n_documents: int = 5
    n_chunks_per_doc: int = 3
    max_context_chars: int = 32_000
    hybrid: bool = True
    prefilter_top_docs: int = 40
    n_expansions: int = 3
    expansion_temperature: float = 0.7
    # None = auto: fan expansion out as n parallel single-reformulation
    # decodes on pool providers (the solo-TTFT long pole); true/false
    # forces it
    expansion_parallel: bool | None = None
    n_candidates: int = 40
    rerank_top_k: int = 10
    rerank_min_score: float = 0.08
    rrf_k: int = 60
    relevance_threshold: float = 0.80
    use_reranker: bool = True
    dense_exact: bool = False          # exact blocked kernel vs approx
    # sparse-engine rescore pool override for a LOADED index (0 = keep
    # the index's own setting). Serving at batch ≥512 runs lossless at
    # 64 on the 1M benchmark corpus and keeps the hybrid within ~9% of
    # the dense arm (BENCHMARKS.md "Hybrid tracking dense")
    postings_candidates: int = 0
    # fast intent path on choice-capable providers: intent by
    # constrained scoring (~84 ms at 12B vs ~1 s JSON decode) + topics
    # by deterministic trigger match — frees decode-pool capacity
    # under concurrent serving
    intent_fast: bool = False
    rerank_batch: int = 0              # coalesce concurrent rerank
                                       # pair-scoring into shared
                                       # forwards (0 = off)


@dataclasses.dataclass
class EmbeddingSection:
    dim: int = 1024
    batch_size: int = 64
    max_seq_len: int = 8192
    query_max_len: int = 512
    device_dtype: str = "bfloat16"
    checkpoint_path: str = ""
    query_batch: int = 0               # coalesce concurrent query
                                       # encodes into one forward
                                       # (0 = off)


@dataclasses.dataclass
class LLMSection:
    mode: str = "local"                # local | hybrid | hosted | tpu | fake
    base_url: str = "http://localhost:11434"
    model: str = "mistral-nemo:12b"
    num_ctx: int = 16_384
    temperature: float = 0.1
    vision_model: str = "llava:7b"
    # mode "tpu": generation served by the in-process JAX decoder
    # (providers/tpu_llm.py) instead of an HTTP sidecar
    checkpoint_path: str = ""          # converted decoder params (.npz)
    tokenizer_path: str = ""           # local HF tokenizer ("" → hashed)
    arch: str = "mistral-nemo-12b"     # DecoderConfig preset | "tiny"
    quantize_int8: bool = True         # weight-only int8 (12B fits one chip)
    quantize_kv: bool = False          # int8 KV cache (2x slots per HBM)
    scheduler: str = "direct"          # direct | batch | continuous
    speculative: bool = False          # prompt-lookup speculation (lossless,
                                       # greedy AND sampled)
    max_batch: int = 8                 # micro-batch / slot-pool width
    prefix_cache: int = 0              # APC entries (continuous only)
    prefix_block: int = 64             # APC block size (tokens)
    prefix_cache_host: bool = False    # APC entries in host RAM, not HBM
    prefill_chunk: int = 0             # chunked prefill segment (0 = whole)
    decode_chunk: int = 4              # decode tokens per device dispatch
    top_p: float = 1.0                 # nucleus cutoff (sampled calls)
    request_timeout_s: float = 0.0     # per-request wall budget on the
                                       # continuous scheduler (queue +
                                       # decode); 0 = unbounded
    age_steps: int = 0                 # priority aging: one level per N
                                       # engine steps waited (0 = off)
    preemption: bool = False           # higher-priority arrivals evict
                                       # the worst active slot (victim
                                       # resumes bit-identically)
    choose_batch: int = 0              # coalesce concurrent choose()
                                       # calls into one batched scoring
                                       # dispatch (0 = off)


@dataclasses.dataclass
class AgentSection:
    enable: bool = True
    enable_expert_refinement: bool = False
    enable_completeness: bool = True
    coverage_threshold: int = 80
    max_generation_retries: int = 1
    max_re_retrievals: int = 1


@dataclasses.dataclass
class ChunkingSection:
    max_words: int = 600
    min_words: int = 100
    overlap_words: int = 50
    ell_width: int = 32


@dataclasses.dataclass
class ObservabilitySection:
    log_level: str = "INFO"
    log_rotate_mb: int = 20
    query_log_rotate_mb: int = 10
    alert_error_rate: float = 0.20
    alert_avg_time_s: float = 60.0
    alert_satisfaction: float = 0.50
    alert_zero_citation_rate: float = 0.30
    smtp_enabled: bool = False
    smtp_host: str = ""
    smtp_to: str = ""


@dataclasses.dataclass
class FrameworkConfig:
    retrieval: RetrievalSection = dataclasses.field(
        default_factory=RetrievalSection)
    embedding: EmbeddingSection = dataclasses.field(
        default_factory=EmbeddingSection)
    llm: LLMSection = dataclasses.field(default_factory=LLMSection)
    agent: AgentSection = dataclasses.field(default_factory=AgentSection)
    chunking: ChunkingSection = dataclasses.field(
        default_factory=ChunkingSection)
    observability: ObservabilitySection = dataclasses.field(
        default_factory=ObservabilitySection)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _coerce(value: str, target: Any) -> Any:
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if target is None:
        # Optional fields (expansion_parallel, request_timeout_s...):
        # infer from the literal — the old passthrough made
        # "...=false" a TRUTHY string
        low = value.lower()
        if low in ("none", "null", "auto", ""):
            return None
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value
    return value


def _overlay(cfg, data: dict, path: str = ""):
    for key, value in data.items():
        if not hasattr(cfg, key):
            raise ValueError(f"unknown config key: {path}{key}")
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            _overlay(cur, value, path=f"{path}{key}.")
        else:
            setattr(cfg, key, value)


def load_config(path: str | os.PathLike | None = None,
                env: dict | None = None) -> FrameworkConfig:
    """defaults ← file (yaml or json) ← RAGDPO_<SECTION>_<FIELD> env."""
    cfg = FrameworkConfig()
    if path:
        text = pathlib.Path(path).read_text()
        if str(path).endswith((".yaml", ".yml")):
            data = _parse_simple_yaml(text)
        else:
            data = json.loads(text)
        _overlay(cfg, data)
    env = os.environ if env is None else env
    for section_field in dataclasses.fields(cfg):
        section = getattr(cfg, section_field.name)
        for f in dataclasses.fields(section):
            var = f"RAGDPO_{section_field.name.upper()}_{f.name.upper()}"
            if var in env:
                setattr(section, f.name,
                        _coerce(env[var], getattr(section, f.name)))
    return cfg


def _parse_simple_yaml(text: str) -> dict:
    """Two-level YAML subset parser (section: / key: value) — keeps the
    dependency surface at zero (PyYAML is not a baked-in requirement)."""
    out: dict = {}
    current: dict | None = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, value = line.strip().partition(":")
        value = value.strip()
        if indent == 0:
            if not value:
                current = out.setdefault(key, {})
            else:
                out[key] = _yaml_scalar(value)
                current = None
        elif current is not None and value:
            current[key] = _yaml_scalar(value)
    return out


def _yaml_scalar(v: str):
    low = v.lower()
    if low in ("null", "~", "none"):
        return None
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v.strip("'\"")
