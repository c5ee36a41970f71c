"""Tiny sizes of the benchmark's cells, for runs on the CPU: the cells'
own configuration and traffic files with small widths and short texts."""

from __future__ import annotations

import copy

from portbench import run, spec

BENCH = spec.load_benchmark()


def decoder_config() -> dict:
    cfg = spec.load_config(BENCH, "mistral-nemo-12b-int8")
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=512, max_position_embeddings=512)
    return cfg


def decoder_traffic() -> dict:
    tr = spec.load_traffic("context-8c")
    tr.update(system_prompt=None, clients=3,
              context={"documents": 1, "chunks_per_document": 2},
              prompt_tokens={"low": 100, "high": 240, "scale": "log"},
              max_tokens={"low": 4, "high": 12}, check={"requests": 50})
    return tr


def agent_config() -> dict:
    cfg = spec.load_config(BENCH, "bge-m3-rerank-cnil16k")
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, vocab_size=1024,
               max_position_embeddings=514, colbert_dim=32)
    cfg["index"].update(chunks=300, documents=60, dim=64,
                        chunk_words={"low": 20, "high": 60},
                        summary_words={"low": 20, "high": 50})
    cfg["settings"]["rerank_max_len"] = 128
    return cfg


def agent_traffic() -> dict:
    tr = spec.load_traffic("agent-16c")
    tr.update(clients=3, check={"requests": 2})
    return tr


CELLS = {"prefill.context-8c": (decoder_config, decoder_traffic),
         "query.agent-16c": (agent_config, agent_traffic)}


def execute(cell: str, seed: int = 11, seconds: float = 2.0,
            hook=None, controls: tuple = ()) -> dict:
    make_config, make_traffic = CELLS[cell]
    return run.execute(copy.deepcopy(BENCH), cell, seed, seconds, False,
                       device="cpu", config=make_config(),
                       traffic=make_traffic(), system_hook=hook,
                       controls=controls)
