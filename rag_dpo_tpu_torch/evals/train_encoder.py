"""Train the retrieval encoder on the hermetic corpus, through the port.

Port of `rag_dpo_tpu/evals/train_encoder.py`. `family_key`,
`build_training_pairs` and `mine_hard_negatives` are host code carried
unchanged (training queries come from document content only: titles,
keyword footers and body-sentence term subsets; the 48 eval questions never
appear in training). `train_eval_encoder` runs the reference's recipe on a
torch device or a mesh — the tiny BGE-M3-style encoder with reference
attention, in-batch InfoNCE with mined hard negatives — and saves the
checkpoint through `models.convert.save_params_npz`, the npz format both
packages' `bootstrap.build_stack` and `load_params_npz` read.
"""

from __future__ import annotations

import pathlib
import re

from ..tokenize.french import tokenize_french_text

# the QA dataset and the trained checkpoint the JAX package ships (data
# files, read, not imported)
_JAX_DATA = pathlib.Path(__file__).resolve().parents[2] / "rag_dpo_tpu" \
    / "evals" / "data"
QA_DATASET = _JAX_DATA / "qa_dataset.json"
TRAINED_NPZ = _JAX_DATA / "trained_encoder_v2.npz"

_KW_LINE = re.compile(r"Mots-clés\s*:\s*(.+?)(?:\.|$)")


def family_key(chunk_id: str) -> str:
    """Near-miss family of a chunk: `qa_X`, `twin_X`, `blend_X` and
    `nav_X` all map to `X`, so grouped batching puts an item and its
    confusable variants in the SAME InfoNCE batch (hard in-batch
    negatives — the blend rows share the item's title/keywords with a
    different body, exactly the confusion the retriever must learn to
    resolve)."""
    for pre in ("qa_", "twin_", "blend_", "nav_"):
        if chunk_id.startswith(pre):
            return chunk_id[len(pre):]
    return chunk_id


def build_training_pairs(chunks: list[dict],
                         return_groups: bool = False,
                         return_chunk_ids: bool = False):
    """(query, passage) pairs from corpus content only.

    Per chunk: its title, its keyword footer, and a content-term subset
    of each body sentence each form a query whose positive is the
    chunk's full text. In-batch negatives (train/contrastive.py) then
    push different chunks apart — including the near-miss distractors,
    which are their own rows. With `return_groups`, also returns the
    per-pair family key for grouped hard-negative batching; with
    `return_chunk_ids`, the per-pair source chunk_id (the label set
    fusion-weight calibration consumes — retrieval/calibrate.py)."""
    pairs: list[tuple[str, str]] = []
    groups: list[str] = []
    chunk_ids: list[str] = []
    for c in chunks:
        n_before = len(pairs)
        text = c["text"]
        title = c.get("title") or c.get("heading") or ""
        if title:
            pairs.append((title, text))
        m = _KW_LINE.search(text)
        if m:
            pairs.append((m.group(1), text))
        body = _KW_LINE.sub("", text)
        for sent in re.split(r"(?<=[.!?])\s+", body):
            terms = tokenize_french_text(sent)
            if len(terms) < 5:
                continue
            # content-word subset, question-length: the query STYLE a
            # natural question shares (content terms, no syntax)
            pairs.append((" ".join(terms[:8]), text))
        n_new = len(pairs) - n_before
        groups.extend(
            [family_key(c.get("chunk_id", c.get("title", "")))] * n_new)
        chunk_ids.extend([c.get("chunk_id", "")] * n_new)
    out = [pairs]
    if return_groups:
        out.append(groups)
    if return_chunk_ids:
        out.append(chunk_ids)
    return out[0] if len(out) == 1 else tuple(out)


def mine_hard_negatives(pairs: list[tuple[str, str]],
                        families: list[str],
                        chunks: list[dict]) -> list:
    """Per-pair hardest CROSS-FAMILY negative passage, or None.

    For each (query, positive) pair, scores every chunk from a
    DIFFERENT near-miss family by idf-weighted token overlap with the
    query and returns the top scorer's text. Cross-family only: the
    measured intrusion classes in the per-category mining
    (scripts/mine_categories.py) are `other_qa` and foreign `blend`
    chunks — and restricting to other families avoids the
    contradictory-label failure of grouped batching (same-family
    variants are other pairs' POSITIVES for near-identical queries;
    forcing them in as negatives cost −2pt true-doc@5, measured
    results_hermetic_20260820_115917.json vs ..._105608.json)."""
    import math

    chunk_tokens = [set(tokenize_french_text(c["text"]))
                    for c in chunks]
    chunk_fams = [family_key(c.get("chunk_id", c.get("title", "")))
                  for c in chunks]
    df: dict[str, int] = {}
    for toks in chunk_tokens:
        for t in toks:
            df[t] = df.get(t, 0) + 1
    n_chunks = max(1, len(chunks))
    idf = {t: math.log(n_chunks / (1 + d)) for t, d in df.items()}

    negatives: list = []
    for (query, positive), fam in zip(pairs, families):
        q_toks = set(tokenize_french_text(query))
        best, best_score = None, 0.0
        for toks, cfam, c in zip(chunk_tokens, chunk_fams, chunks):
            if cfam == fam:
                continue
            score = sum(idf.get(t, 0.0) for t in q_toks & toks)
            if score > best_score:
                best, best_score = c["text"], score
        negatives.append(best)
    return negatives


def _shared_tmpdir(mesh):
    """A temporary directory every rank of `mesh` names (the first rank's,
    its path broadcast), removed by the first rank once all are done;
    without a mesh, a plain one."""
    import contextlib
    import shutil
    import tempfile

    if mesh is None:
        return tempfile.TemporaryDirectory()
    import torch.distributed as dist

    @contextlib.contextmanager
    def shared():
        first = dist.get_rank() == 0
        name = [tempfile.mkdtemp() if first else None]
        dist.broadcast_object_list(name, src=0)
        try:
            yield name[0]
        finally:
            dist.barrier()
            if first:
                shutil.rmtree(name[0], ignore_errors=True)

    return shared()


def train_eval_encoder(out_npz, steps: int = 800, batch_size: int = 32,
                       seq_len: int = 96, learning_rate: float = 3e-4,
                       log_every: int = 50, hard_negatives: bool = True,
                       grouped: bool = False, device=None,
                       dataset_path=QA_DATASET, mesh=None) -> dict:
    """Train on the v2 corpus and save the checkpoint to `out_npz` in the
    shared npz format. → {"loss_first", "loss_last", "n_pairs", ...}.

    The reference writes its committed checkpoint by default; the port
    takes the path, so a run never overwrites that record. `mesh`: a
    `DeviceMesh` to train on (every rank calls this), as the reference's
    `create_mesh()`; else `device`. On a mesh the first rank writes the
    npz (the model gathered whole) and every rank returns its numbers."""
    import json

    import torch.distributed as dist

    from ..models import BgeM3Config, EncoderConfig
    from ..models.bge_m3 import full_flax_tree
    from ..models.convert import save_params_npz
    from ..train.contrastive import TrainConfig
    from ..train.loop import LoopConfig, train_retriever
    from .synthetic import build_synthetic_corpus

    dataset = json.loads(pathlib.Path(dataset_path).read_text(
        encoding="utf-8"))
    chunks = build_synthetic_corpus(dataset)
    pairs, groups = build_training_pairs(chunks, return_groups=True)
    negatives = (mine_hard_negatives(pairs, groups, chunks)
                 if hard_negatives else None)

    model_cfg = BgeM3Config(
        encoder=EncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32,
    )
    train_cfg = TrainConfig(model=model_cfg,
                            learning_rate=learning_rate,
                            warmup_steps=max(20, steps // 10))
    with _shared_tmpdir(mesh) as tmp:
        metrics_path = pathlib.Path(tmp) / "metrics.jsonl"
        state = train_retriever(
            pairs, train_cfg, device if mesh is None else mesh,
            pathlib.Path(tmp) / "ckpt",
            loop_config=LoopConfig(batch_size=batch_size,
                                   max_steps=steps, seq_len=seq_len,
                                   checkpoint_every=steps,
                                   log_every=log_every),
            metrics_path=metrics_path,
            groups=groups if grouped else None,
            negatives=negatives,
        )
        tree = full_flax_tree(state.model)
        if mesh is not None:
            dist.barrier()            # the first rank's metrics are written
        lines = [json.loads(ln) for ln in
                 metrics_path.read_text().splitlines()]
    out_npz = pathlib.Path(out_npz)
    if mesh is None or dist.get_rank() == 0:
        out_npz.parent.mkdir(parents=True, exist_ok=True)
        save_params_npz(tree, out_npz)
    return {
        "n_pairs": len(pairs),
        "n_hard_negatives": (sum(x is not None for x in negatives)
                             if negatives else 0),
        "steps": steps,
        "loss_first": lines[0]["loss"] if lines else None,
        "loss_last": lines[-1]["loss"] if lines else None,
        "accuracy_last": lines[-1]["accuracy"] if lines else None,
        "npz": str(out_npz),
    }


def load_trained_params(npz_path=TRAINED_NPZ):
    """Committed checkpoint → param tree for Embedder(params=...)."""
    from ..models.convert import load_params_npz

    return load_params_npz(npz_path)
