"""rag_dpo_tpu_torch — the PyTorch/CUDA port of `rag_dpo_tpu`.

A second package beside the JAX one, with the same subpackage layout, so
every ported file has one JAX counterpart at the same relative path. It
imports torch and never jax, flax, optax, orbax, transformers or
`rag_dpo_tpu`, so it runs on a machine that has none of them. The host
modules it needs that have no jax of their own are carried here as copies
with only the package prefix changed.

Slice 1 is the hybrid-RAG query path: `bootstrap.build_stack` loads a
saved `index.DeviceIndex`, encodes queries with BGE-M3
(`providers.Embedder`), runs dense and BM25 top-k, weighted RRF, the
cross-encoder rerank, then context, generation and validation
(`rag.RAGPipeline`). Its two TPU kernels are hand-written CUDA for Hopper
in `csrc/`: flash-attention forward and the ELL BM25 top-k.

Slice 2 is contrastive training of the encoder on one device:
`train.loop.train_retriever` batches (query, passage, hard negative)
texts, steps InfoNCE with the reference's clipped AdamW
(`train.contrastive`), checkpoints and resumes (`train.checkpoint`), and
`models.convert.save_params_npz` exports the weights in the npz format
both packages read. The flash-attention backward (dq; dk and dv) is
hand-written CUDA in `csrc/flash_bwd.cu`.

Package layout::

    ops/        CUDA kernel wrappers + plain-torch twins, dense top-k, RRF
    csrc/       the CUDA sources (built at first use into build/)
    models/     encoder, BGE-M3 heads, cross-encoder, Flax param load/save
    train/      InfoNCE step, optimizer, checkpoints, training loop
    index/      single-device index, metadata filters, checkpoints
    retrieval/  hybrid retriever, BM25, cross-encoder reranker
    rag/        sequential pipeline, prompts, validators (copies)
    providers/  embedder, LLM provider base + deterministic fake
    ingest/     corpus indexer
    evals/      synthetic corpus + extractive fake LLM (copy), the
                training recipe
    tokenize/   host tokenizers (copies; no HF adapter)
    utils/      config, paths, query log, alerter (copies)
"""

__version__ = "0.1.0"
