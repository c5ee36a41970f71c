"""Device-resident vector + lexical index on one torch device.

Port of `rag_dpo_tpu/index/store.py` for a single device, with bf16 or
int8 dense storage. The host store (f16 dense rows, ELL
terms/impacts/tf/dl, alive flags, metadata, string ids) and the checkpoint
format (`arrays.npz`, `manifest.json`, `metadata.json`, `bm25.json`) are
the JAX package's, so a checkpoint saved by either package loads in the
other. The device image is
the same padded layout: rows rounded up to `row_block`, padding rows with
zero vectors, −1 terms and a −1e4 penalty. Its dense columns are padded
with zeros to what the card's kernels read in one load (a multiple of 8
for bf16 and f32 rows, of 16 for int8 ones, after quantizing, so the
per-row scales do not move), and the queries with them: a zero column adds
+0 to every score, so any `dim` runs without a copy per search.

Search engines:
* dense, bf16: exact top-k with the lowest row first among ties
  (`ops.topk`: approx, exact = blocked, masked = penalty-folded approx),
  which on the card is the fused top-k kernel (K4);
* dense, int8 (`quantize_int8`): the reference's default, step for step:
  the queries quantized per row, their int8 × int8 scores against the
  int8 rows × both scales + the combined penalty (`ops.quantize.
  approx_topk_int8`), the best min(4k, n_pad) of them, then an exact f32
  re-score against the host f16 rows. Approximate by design, and `exact`
  does not apply;
* dense, int8 with `device_refine`: the reference's on-card search, int8 ×
  int8 as it ranks (`ops.quantize`): the sweep's best 4k, re-scored
  against the dequantized int8 rows on the card, over the whole image at
  once or, past a [Q, n_pad] budget of 512 Mi scores (or with
  `sweep_block_rows` set), in row blocks;
* sparse: the ELL kernel (`ops.sparse.ell_topk`, K3) over the whole padded
  image for unfiltered queries and the plain full scorer for filtered
  ones, below `postings_threshold` rows and Q·T ≤ 128; above either, the
  impact-ordered postings engine (`ops.postings`), filtered queries
  through an unfiltered overfetch and a host filter.
ColBERT rows stay on the host in f16 (`colbert_vectors`, for the MaxSim
rerank).

With a mesh (`DeviceIndex(config, mesh=mesh)`, `parallel.create_mesh`) the
device image is row-sharded over the mesh's `shard` axis, as the
reference's is: `n_pad` rounds up to `row_block × shards`, and each rank
uploads only its own block of rows (`_put_rows`). Every engine then runs
its single-device local function on the rank's block and merges the
shards' top-k lists through one all-gather (`parallel.collectives`):
dense bf16 is K4 with the penalty (ties lowest row first, as `lax.top_k`
on the CPU); int8 is the sweep's best 4k (by row blocks past the score
budget), refined on the host against the f16 rows or, with
`device_refine`, on the card: each rank re-scores the candidates it holds
and one all-reduce (max) gives every rank all of them; the sparse arm is
`ell_scores` + a stable top-k below `postings_threshold` rows a shard, else
each rank's own postings inversion. Every rank of the mesh must call the
same searches in the same order.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import approx_topk, blocked_topk, default_device
from ..ops import topk
from ..ops.postings import PostingsIndex, postings_candidates_topk
from ..ops.quantize import (
    _dequant_rows,
    _rescore,
    _stable_topk,
    _top_refined,
    approx_topk_int8,
    approx_topk_int8_blockscan,
    approx_topk_int8_selfrefined,
    int8_blockscan_candidates,
    quantize_rows,
)
from ..ops.sparse import ell_scores, ell_topk
from ..ops.topk import fused_topk, pad_columns
from ..parallel import mesh as pmesh
from ..parallel.collectives import sharded_topk_multi
from ..utils.profiling import span
from .metadata import MetadataStore, compile_filter

NEG_INF = -1e30
# the int8 image's column multiple: `torch._int_mm` reads D in multiples of
# 8, and the int8 kernels (`ops.int8_matmul`, `ops.pooled`) in 16
INT8_COL_MULTIPLE = 16
# device_refine's live [Q, n_pad] score budget before the sweep goes by row
# blocks: the reference's (store.py:641-643)
SCORE_BUDGET = 512 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    dim: int = 1024
    ell_width: int = 32          # sparse terms stored per chunk
    colbert_dim: int = 0         # 0 = no multi-vector storage
    colbert_len: int = 0
    row_block: int = 1024        # device padding granularity
    device_dtype: Any = torch.bfloat16
    # sparse engine: the ELL kernel is O(N) per query; above this row
    # count (or for Q·T > 128) the impact-ordered postings engine takes over
    postings_threshold: int = 100_000
    postings_cap: int = 512
    postings_candidates: int = 512
    # int8 dense storage: int8 rows + f32 scales on the device, candidates
    # refined exactly against the host f16 rows
    quantize_int8: bool = False
    # refine the int8 sweep's candidates on the card against the dequantized
    # int8 rows instead of on the host against the f16 rows: one pass on the
    # card, no candidate round trip; scores carry the rows' int8
    # quantization instead of f16
    device_refine: bool = False
    # device_refine's sweep blocking: 0 = by rows of `SCORE_BUDGET // Q`
    # (at least `row_block`) once [Q, n_pad] exceeds the budget; > 0 forces
    # that block size
    sweep_block_rows: int = 0


class DeviceIndex:
    """`mesh`: a (data, model, shard) `DeviceMesh` to row-shard the device
    image over (this rank's device then holds its block); None: one
    device."""

    def __init__(self, config: IndexConfig, device=None, mesh=None):
        self.config = config
        self.mesh = mesh
        if mesh is not None and device is None:
            device = pmesh.mesh_device(mesh)
        self.device = default_device(device)
        self.ids: list[str] = []
        self._id_pos: dict[str, int] = {}
        self.meta = MetadataStore()
        self._dense = np.zeros((0, config.dim), np.float16)
        self._terms = np.full((0, config.ell_width), -1, np.int32)
        self._impacts = np.zeros((0, config.ell_width), np.float32)
        self._tf = np.zeros((0, config.ell_width), np.int32)
        self._dl = np.zeros((0,), np.int32)
        self.bm25_stats = None
        self._colbert = (
            np.zeros((0, config.colbert_len, config.colbert_dim), np.float16)
            if config.colbert_dim
            else None
        )
        self._alive = np.zeros((0,), bool)
        self._device = None  # dict of device tensors, rebuilt on change

    # ------------------------------------------------------------ basics
    def __len__(self) -> int:
        return int(self._alive.sum())

    @property
    def n_rows(self) -> int:
        return len(self.ids)

    def __contains__(self, chunk_id: str) -> bool:
        pos = self._id_pos.get(chunk_id)
        return pos is not None and bool(self._alive[pos])

    # ------------------------------------------------------------- write
    def add(
        self,
        chunk_ids: Sequence[str],
        dense: np.ndarray,
        metadatas: Sequence[Mapping[str, Any]] | None = None,
        terms: np.ndarray | None = None,
        impacts: np.ndarray | None = None,
        colbert: np.ndarray | None = None,
        tf: np.ndarray | None = None,
        dl: np.ndarray | None = None,
    ):
        """Append rows. Existing ids are updated in place (upsert)."""
        cfg = self.config
        dense = np.asarray(dense, np.float16)
        assert dense.shape == (len(chunk_ids), cfg.dim), dense.shape
        metadatas = metadatas or [{} for _ in chunk_ids]
        if terms is None:
            terms = np.full((len(chunk_ids), cfg.ell_width), -1, np.int32)
        terms = np.asarray(terms, np.int32)
        if impacts is None:  # terms without impacts: zero contribution
            impacts = np.zeros(terms.shape, np.float32)
        impacts = np.asarray(impacts, np.float32)
        tf = (np.zeros(terms.shape, np.int32) if tf is None
              else np.asarray(tf, np.int32))
        dl = (np.zeros((len(chunk_ids),), np.int32) if dl is None
              else np.asarray(dl, np.int32))

        fresh_rows, fresh_meta = [], []
        batch_pos: dict[str, int] = {}  # id → row WITHIN this batch
        for row, cid in enumerate(chunk_ids):
            pos = self._id_pos.get(cid)
            if pos is None and cid in batch_pos:
                # duplicate id inside one batch: the later occurrence wins
                dup_idx = fresh_rows.index(batch_pos[cid])
                fresh_rows[dup_idx] = row
                fresh_meta[dup_idx] = metadatas[row]
                batch_pos[cid] = row
                continue
            if pos is not None:  # in-place update
                self._dense[pos] = dense[row]
                self._terms[pos] = terms[row]
                self._impacts[pos] = impacts[row]
                self._tf[pos] = tf[row]
                self._dl[pos] = dl[row]
                if self._colbert is not None:
                    self._colbert[pos] = (
                        colbert[row] if colbert is not None else 0
                    )
                self._alive[pos] = True
                self.meta.update(pos, metadatas[row])
            else:
                batch_pos[cid] = row
                fresh_rows.append(row)
                fresh_meta.append(metadatas[row])

        if fresh_rows:
            sel = np.asarray(fresh_rows)
            base = len(self.ids)
            for row in fresh_rows:
                self._id_pos[chunk_ids[row]] = base
                self.ids.append(chunk_ids[row])
                base += 1
            self._dense = np.concatenate([self._dense, dense[sel]])
            self._terms = np.concatenate([self._terms, terms[sel]])
            self._impacts = np.concatenate([self._impacts, impacts[sel]])
            self._tf = np.concatenate([self._tf, tf[sel]])
            self._dl = np.concatenate([self._dl, dl[sel]])
            if self._colbert is not None:
                cb = (
                    np.asarray(colbert, np.float16)[sel]
                    if colbert is not None
                    else np.zeros(
                        (len(sel), cfg.colbert_len, cfg.colbert_dim),
                        np.float16,
                    )
                )
                self._colbert = np.concatenate([self._colbert, cb])
            self._alive = np.concatenate(
                [self._alive, np.ones((len(sel),), bool)]
            )
            self.meta.append(fresh_meta)
        self._device = None  # invalidate device image

    def delete(self, chunk_ids: Sequence[str]):
        """Tombstone rows (device mask; storage reclaimed on compact())."""
        for cid in chunk_ids:
            pos = self._id_pos.get(cid)
            if pos is not None:
                self._alive[pos] = False
        self._device = None

    def recompute_impacts(self, stats):
        """Re-derive every row's BM25 impacts from stored (tf, dl) under
        new stats and adopt `stats` as the index's query-side stats."""
        from ..retrieval.bm25 import impacts_from_tf

        if self.n_rows:
            self._impacts = impacts_from_tf(self._tf, self._dl, stats)
        self.bm25_stats = stats
        self._device = None

    def compact(self):
        keep = np.nonzero(self._alive)[0]
        self._dense = self._dense[keep]
        self._terms = self._terms[keep]
        self._impacts = self._impacts[keep]
        self._tf = self._tf[keep]
        self._dl = self._dl[keep]
        if self._colbert is not None:
            self._colbert = self._colbert[keep]
        kept_ids = [self.ids[i] for i in keep]
        kept_docs = [self.meta._docs[i] for i in keep]
        self.ids = kept_ids
        self._id_pos = {cid: i for i, cid in enumerate(kept_ids)}
        meta = MetadataStore()
        meta.append(kept_docs)
        self.meta = meta
        self._alive = np.ones((len(keep),), bool)
        self._device = None

    # ------------------------------------------------------------ device
    def _shards(self) -> int:
        return 1 if self.mesh is None else pmesh.axis_size(self.mesh)

    def _put_rows(self, x):
        """An array [n_pad, ...] on the device: whole without a mesh, else
        only this rank's block of rows along the shard axis (no rank ships
        another's rows)."""
        if self.mesh is None:
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return pmesh.shard_leading_axis(self.mesh, np.ascontiguousarray(x))

    def _n_pad(self) -> int:
        blk = self.config.row_block * self._shards()
        return max(blk, -(-self.n_rows // blk) * blk)

    def device_image(self):
        if self._device is not None:
            return self._device
        cfg = self.config
        n, n_pad = self.n_rows, self._n_pad()
        embs = np.zeros((n_pad, cfg.dim), np.float32)
        embs[:n] = self._dense.astype(np.float32)
        terms = np.full((n_pad, cfg.ell_width), -1, np.int32)
        terms[:n] = self._terms
        impacts = np.zeros((n_pad, cfg.ell_width), np.float32)
        impacts[:n] = self._impacts
        alive = np.zeros((n_pad,), np.float32)
        alive[:n] = self._alive.astype(np.float32)
        alive_penalty = (alive - 1.0) * 1e4  # 0 for live, -1e4 otherwise

        put = self._put_rows
        embs_d, embs_i8, embs_scale = put(embs), None, None
        if cfg.quantize_int8:  # the bf16 image is not kept, as in JAX
            embs_i8, embs_scale = quantize_rows(embs_d)
            embs_i8 = pad_columns(embs_i8, self._col_multiple())
            embs_d = None
        else:
            embs_d = pad_columns(embs_d.to(cfg.device_dtype),
                                 self._col_multiple())
        self._device = {
            "embs": embs_d,
            "embs_i8": embs_i8,
            "embs_scale": embs_scale,
            "terms": put(terms),
            "impacts": put(impacts),
            "alive_penalty": put(alive_penalty),
            "row_ids": put(np.arange(n_pad, dtype=np.int32)),
            "n_pad": n_pad,
        }
        return self._device

    # ------------------------------------------------------------ search
    def _mask_vector(self, where) -> np.ndarray | None:
        mask = compile_filter(self.meta, where)
        alive = self._alive
        if mask is None:
            if alive.all():
                return None
            mask = alive.copy()
        else:
            mask = mask & alive
        return mask

    def _combined_penalty(self, mask, dev):
        """[n_pad] additive score penalty: 0 for selectable rows, −1e4 for
        padding, tombstones, and filtered-out rows."""
        if mask is None:
            return dev["alive_penalty"]
        m = np.full((dev["n_pad"],), -1e4, np.float32)
        m[: len(mask)] = np.where(mask, 0.0, -1e4)
        return self._put_rows(m)

    def _finish(self, s, i, k):
        """Any slot whose score carries the −1e4 penalty (or points past
        the live corpus) becomes (-inf, -1)."""
        s, i = _host(s), _host(i)
        i = np.where((i >= 0) & (i < self.n_rows) & (s > -5e3), i, -1)
        s = np.where(i >= 0, s, NEG_INF).astype(np.float32)
        return s, i

    def _col_multiple(self) -> int:
        """The column multiple of the device image: what the int8 product
        (int8) or K4 (otherwise) reads whole."""
        return (INT8_COL_MULTIPLE if self.config.quantize_int8
                else topk.COL_MULTIPLE)

    def _queries(self, queries, dtype=None):
        """Queries on the device in `dtype` (default the image's), padded
        with the image's zero columns."""
        q = torch.from_numpy(np.asarray(queries, np.float32))
        q = q.to(self.device).to(dtype or self.config.device_dtype)
        return pad_columns(q, self._col_multiple())

    def search_dense(self, queries: np.ndarray, k: int, where=None,
                     exact: bool = False):
        """queries [Q, D] (L2-normalized) → (scores [Q,k], ids [Q,k] int
        rows; -1 = empty). Filter `where` is a ChromaDB-style tree."""
        dev = self.device_image()
        mask = self._mask_vector(where)
        if self.mesh is not None:
            if dev["embs_i8"] is not None:
                return self._sharded_int8(queries, k, mask, dev)
            return self._sharded_dense(self._queries(queries), k, mask, dev)
        if dev["embs_i8"] is not None:
            return self._int8_dense(queries, k, mask, dev)
        q = self._queries(queries)
        if mask is not None:
            if exact:
                pen = self._combined_penalty(mask, dev)
                s, i = blocked_topk(q, dev["embs"], k, penalty=pen)
                return self._finish(s, i, k)
            return self._masked_dense(q, k, mask)
        if exact:
            s, i = blocked_topk(q, dev["embs"], k,
                                penalty=dev["alive_penalty"])
            s, i = _host(s), _host(i)
            ok = (i >= 0) & (i < self.n_rows) & (s > -5e3)
            i = np.where(ok, i, -1)
            s = np.where(ok, s, NEG_INF).astype(np.float32)
            return s, i
        s, i = approx_topk(q, dev["embs"], k, penalty=dev["alive_penalty"])
        s, i = _host(s), _host(i)
        i = np.where((i >= 0) & (i < self.n_rows), i, -1)
        return self._strip_dead(s, i, k)

    # --------------------------------------------------- sharded engines
    def _sharded_dense(self, q, k: int, mask, dev):
        """Each shard's exact top-min(k, n_local) by K4 with the combined
        penalty, merged (the reference's exact and approximate arms select
        the same rows on the CPU)."""
        def local_fn(qs, shard_embs, pen):
            return fused_topk(qs, shard_embs, min(k, shard_embs.shape[0]),
                              penalty=pen)

        pen = self._combined_penalty(mask, dev)
        s, i = sharded_topk_multi(self.mesh, local_fn, k, 2)(
            q, dev["row_ids"], dev["embs"], pen)
        return self._finish(s, i, k)

    def _sharded_int8(self, queries, k: int, mask, dev):
        """The sharded int8 sweep: each shard's best min(4k, n_local) by
        the sweep (over row blocks past the score budget, or
        `sweep_block_rows`), merged to 4k; then the exact refine on the
        host against the f16 rows, or with `device_refine` on the card
        against the dequantized int8 rows of the shard that holds each
        candidate."""
        qf32 = np.asarray(queries, np.float32)
        qf = self._queries(qf32, torch.float32)
        q_i8, q_scale = quantize_rows(qf)
        k_fetch = min(4 * k, dev["n_pad"])
        blk = self.config.sweep_block_rows or max(
            self.config.row_block, SCORE_BUDGET // max(qf.shape[0], 1))

        def local_fn(qi, e_i8, e_scale, pen):
            kk = min(k_fetch, e_i8.shape[0])
            if blk < e_i8.shape[0]:
                return int8_blockscan_candidates(
                    qi, q_scale, e_i8, e_scale, kk, blk, penalty=pen)
            return approx_topk_int8(qi, q_scale, e_i8, e_scale, kk,
                                    oversample=1, penalty=pen)

        pen = self._combined_penalty(mask, dev)
        s, i = sharded_topk_multi(self.mesh, local_fn, k_fetch, 3)(
            q_i8, dev["row_ids"], dev["embs_i8"], dev["embs_scale"], pen)
        if self.config.device_refine:
            return self._finish(*self._sharded_refine(qf, s, i, k, dev), k)
        s, i = _host(s), _host(i)
        ok = (i >= 0) & (i < self.n_rows) & (s > -5e3)
        return self._host_refine(qf32, s, i, ok, k)

    def _sharded_refine(self, qf, cand_s, cand_i, k: int, dev):
        """`dequant_refine` over the shards: each rank re-scores, against
        its dequantized int8 rows, the candidates it holds (the rest
        −1e30), one all-reduce (max) gives every rank every exact score,
        then the exact top-k of them as `dequant_refine` takes it."""
        lo, hi = _local_row_range(self.mesh, dev["n_pad"])
        mine = (cand_i >= lo) & (cand_i < hi) & (cand_s > -5e3)
        local = torch.where(mine, cand_i - lo, 0).long()
        exact = _rescore(qf, _dequant_rows(dev["embs_i8"],
                                           dev["embs_scale"], local))
        exact = torch.where(mine, exact, NEG_INF).contiguous()
        dist.all_reduce(exact, op=dist.ReduceOp.MAX,
                        group=self.mesh.get_group(pmesh.AXIS_SHARD))
        safe = torch.where(cand_i >= 0, cand_i, 0).long()
        return _top_refined(exact, safe, k, drop_empty=True)

    def _sharded_postings(self, dev):
        """This rank's impact-ordered posting table over its own block of
        rows (local doc ids; the merge maps them to global)."""
        if "postings_sharded" not in dev:
            lo, hi = _local_row_range(self.mesh, dev["n_pad"])
            n_pad = dev["n_pad"]
            nloc = hi - lo
            vocab = int(self._terms.max()) + 1 if self.n_rows else 1
            cap = min(self.config.postings_cap,
                      max(64, -(-nloc // 64) * 64))
            w = self.config.ell_width
            terms = np.full((n_pad, w), -1, np.int32)
            terms[: self.n_rows] = self._terms
            imps = np.zeros((n_pad, w), np.float32)
            imps[: self.n_rows] = self._impacts
            dev["postings_sharded"] = PostingsIndex.build(
                terms[lo:hi], imps[lo:hi], vocab_size=max(vocab, 1),
                cap=cap).device_arrays(self.device)
        return dev["postings_sharded"]

    def _sharded_sparse(self, qt, qw, k: int, mask, dev):
        """Row-sharded lexical top-k, the single-device engine choice a
        shard: the ELL scores + a stable top-k (JAX's `lax.top_k`; not K3,
        whose C-1 tie order would move zero-score ranks), or above
        `postings_threshold` rows a shard (or Q·T > 128) the rank's own
        postings; the penalty folds filters and tombstones in."""
        nloc = dev["n_pad"] // self._shards()
        heavy = qt.shape[0] * qt.shape[1] > 128
        pen = self._combined_penalty(mask, dev)
        if nloc > self.config.postings_threshold or heavy:
            post_docs, post_imps = self._sharded_postings(dev)
            n_cand = self.config.postings_candidates

            def local_fn(q_pack, terms, impacts, pen_l):
                s, ids = postings_candidates_topk(
                    post_docs, post_imps, terms, impacts, *q_pack,
                    k=min(k, terms.shape[0]), n_candidates=n_cand,
                    penalty=pen_l)
                return s, torch.where(ids >= 0, ids, 0)
        else:
            def local_fn(q_pack, terms, impacts, pen_l):
                s = ell_scores(terms, impacts, *q_pack) + pen_l[None, :]
                return _stable_topk(s, min(k, s.shape[1]))

        s, i = sharded_topk_multi(self.mesh, local_fn, k, 3)(
            (qt, qw), dev["row_ids"], dev["terms"], dev["impacts"], pen)
        return self._finish(s, i, k)

    def _int8_dense(self, queries, k: int, mask, dev):
        """Int8 search; filters fold into the penalty. The reference's
        default (`rag_dpo_tpu/index/store.py::_int8_dense`): the queries
        quantized per row, the int8 × int8 sweep's best min(4k, n_pad)
        (`approx_topk_int8`, one pass), re-scored exactly on the host. The
        zero columns of the image and of the padded queries change neither
        a query's scale (its max |x|) nor any product. With
        `device_refine`, the reference's on-card int8 × int8 search."""
        qf32 = np.asarray(queries, np.float32)
        penalty = self._combined_penalty(mask, dev)
        if self.config.device_refine:
            return self._device_refine(qf32, k, penalty, dev)
        q_i8, q_scale = quantize_rows(self._queries(qf32, torch.float32))
        kk = min(4 * k, dev["n_pad"])
        s, i = approx_topk_int8(q_i8, q_scale, dev["embs_i8"],
                                dev["embs_scale"], kk, oversample=1,
                                penalty=penalty)
        s, i = _host(s), _host(i)
        ok = (i >= 0) & (i < self.n_rows) & (s > -5e3)
        return self._host_refine(qf32, s, i, ok, k)

    def _device_refine(self, qf32, k: int, penalty, dev):
        """The sweep and the dequant refine on the card, 4× oversampled:
        over the whole image at once, or in row blocks when forced by
        `sweep_block_rows` or when [Q, n_pad] scores would pass
        `SCORE_BUDGET` (blocks of budget // Q rows, at least `row_block`)."""
        cfg = self.config
        q = self._queries(qf32, torch.float32)
        q_n, n_pad = q.shape[0], dev["n_pad"]
        if cfg.sweep_block_rows:
            blk = cfg.sweep_block_rows
        elif q_n * n_pad > SCORE_BUDGET:
            blk = max(cfg.row_block, SCORE_BUDGET // q_n)
        else:
            blk = 0
        if blk and blk < n_pad:
            s, i = approx_topk_int8_blockscan(
                q, dev["embs_i8"], dev["embs_scale"], k, oversample=4,
                block_rows=blk, penalty=penalty)
        else:
            s, i = approx_topk_int8_selfrefined(
                q, dev["embs_i8"], dev["embs_scale"], k, oversample=4,
                penalty=penalty)
        return self._finish(s, i, k)

    def _host_refine(self, qf32, s, i, ok, k: int):
        """Exact f32 re-score of device-selected candidates against the
        host f16 rows; invalid slots stay excluded."""
        safe = np.where(ok, i, 0)
        rows = self._dense[safe].astype(np.float32)      # [Q, C, D]
        exact = np.einsum("qd,qcd->qc", qf32, rows)
        exact = np.where(ok, exact, NEG_INF)
        order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        top = np.take_along_axis(exact, order, axis=1)
        ids = np.take_along_axis(np.where(ok, i, -1), order, axis=1)
        ids = np.where(top > NEG_INF / 2, ids, -1)
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            top = np.pad(top, ((0, 0), (0, pad)), constant_values=NEG_INF)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return top.astype(np.float32), ids

    def _masked_dense(self, q, k: int, mask: np.ndarray):
        """Filtered dense search: the mask folds into a score penalty and
        the approx selector runs unchanged."""
        dev = self.device_image()
        penalty = self._combined_penalty(mask, dev)
        s, i = approx_topk(q, dev["embs"], k, penalty=penalty)
        s, i = _host(s), _host(i)
        i = np.where((i >= 0) & (i < self.n_rows) & (s > -5e3), i, -1)
        s = np.where(i >= 0, s, NEG_INF)
        return s, i

    def _postings_index(self):
        dev = self.device_image()
        if "postings" not in dev:
            vocab = int(self._terms.max()) + 1 if self.n_rows else 1
            cap = min(self.config.postings_cap,
                      max(64, -(-self.n_rows // 64) * 64))
            dev["postings"] = PostingsIndex.build(
                self._terms, self._impacts, vocab_size=max(vocab, 1),
                cap=cap).device_arrays(self.device)
        return dev["postings"]

    def search_sparse(self, q_terms: np.ndarray, q_weights: np.ndarray,
                      k: int, where=None):
        """Lexical top-k (BM25 / learned sparse). q padding id: -2.

        Below `postings_threshold` rows and Q·T ≤ 128: unfiltered, the ELL
        top-k kernel over the whole padded image; filtered, exact full
        scores, then mask and a stable host top-k. Above either: the
        postings engine, filtered queries through an unfiltered overfetch
        of min(max(4k, 64), 256) and a host filter."""
        dev = self.device_image()
        mask = self._mask_vector(where)
        heavy_query = q_terms.shape[0] * q_terms.shape[1] > 128
        postings = self.n_rows > self.config.postings_threshold or heavy_query
        qt = torch.from_numpy(np.asarray(q_terms, np.int32)).to(self.device)
        qw = torch.from_numpy(np.asarray(q_weights, np.float32)).to(
            self.device)
        if self.mesh is not None:
            return self._sharded_sparse(qt, qw, k, mask, dev)
        if postings:
            arrays = self._postings_index()
            fetch = k if mask is None else min(max(4 * k, 64), 256)
            s, i = postings_candidates_topk(
                *arrays, dev["terms"], dev["impacts"], qt, qw, k=fetch,
                n_candidates=self.config.postings_candidates)
            s, i = _host(s), _host(i)
            if mask is None:
                i = np.where((i >= 0) & (i < self.n_rows), i, -1)
                return self._strip_dead(s, i, k)
            ok = (i >= 0) & (i < self.n_rows)
            ok &= np.where(ok, mask[np.clip(i, 0, self.n_rows - 1)], False)
            s = np.where(ok, s, NEG_INF)
            i = np.where(ok, i, -1)
            order = np.argsort(-s, axis=1, kind="stable")[:, :k]
            return (np.take_along_axis(s, order, axis=1),
                    np.take_along_axis(i, order, axis=1))
        if mask is None:
            s, i = ell_topk(dev["terms"], dev["impacts"], qt, qw, k=k)
            s, i = _host(s), _host(i)
            i = np.where((i >= 0) & (i < self.n_rows), i, -1)
            return self._strip_dead(s, i, k)
        # masked, small corpus: exact full scores then mask+topk
        s = _host(ell_scores(dev["terms"], dev["impacts"], qt, qw))
        with span("retrieval.sparse.sort"):    # host: mask and sort
            s = s[:, : self.n_rows]
            s = np.where(mask[None, :], s, NEG_INF)
            idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
            top = np.take_along_axis(s, idx, axis=1)
            idx = np.where(top > NEG_INF / 2, idx, -1).astype(np.int32)
        if idx.shape[1] < k:  # corpus smaller than k: fixed width
            pad = k - idx.shape[1]
            top = np.pad(top, ((0, 0), (0, pad)), constant_values=NEG_INF)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        return top.astype(np.float32), idx

    def _strip_dead(self, s, i, k):
        """Drop tombstoned rows from (already unfiltered) results."""
        if self._alive.all():
            return s, i
        dead = ~self._alive
        bad = (i >= 0) & dead[np.clip(i, 0, self.n_rows - 1)]
        s = np.where(bad, NEG_INF, s)
        i = np.where(bad, -1, i)
        order = np.argsort(-s, axis=1, kind="stable")
        return np.take_along_axis(s, order, axis=1), np.take_along_axis(
            i, order, axis=1
        )

    def warm(self, batch_sizes: Sequence[int] = (1, 64, 256),
             k: int = 10, sparse_terms: int = 16):
        """Run the search engines once at each query batch shape before
        live traffic, results discarded (zero-vector queries with one unit
        column, one live term). On the card, first load every kernel the
        engines launch: a library's first use runs nvcc (seconds), and a
        server's micro-batcher thread must not hold its waiting callers
        behind it. Then, as in the JAX store, the searches: the device
        image, the postings inversion and the allocator's first blocks of
        each shape are made here instead of on the first live request."""
        if self.device.type == "cuda":
            from ..ops import _kernels

            # K3 for the sparse arm below the postings threshold; K4 for
            # bf16 rows (the int8 arms run `torch._int_mm` and plain passes)
            for name in (("ell_topk",) if self.config.quantize_int8
                         else ("ell_topk", "fused_topk")):
                _kernels.load(name)
        if not self.n_rows:
            return
        d = self.config.dim
        for b in batch_sizes:
            q = np.zeros((int(b), d), np.float32)
            q[:, 0] = 1.0
            self.search_dense(q, k)
            if sparse_terms:
                qt = np.full((int(b), sparse_terms), -2, np.int32)
                qt[:, 0] = 0
                qw = np.ones((int(b), sparse_terms), np.float32)
                self.search_sparse(qt, qw, k)

    def colbert_vectors(self, rows: Sequence[int]) -> np.ndarray:
        """Host f16 ColBERT rows [len(rows), colbert_len, colbert_dim],
        zero past each chunk's length."""
        if self._colbert is None:
            raise ValueError("index built without colbert")
        return self._colbert[np.asarray(rows)]

    def dense_vectors(self, rows: Sequence[int]) -> np.ndarray:
        """Host dense rows [len(rows), dim] in f32."""
        return self._dense[np.asarray(rows)].astype(np.float32)

    def chunk_ids(self, rows) -> list[str | None]:
        return [self.ids[r] if r >= 0 else None for r in np.asarray(rows)]

    # -------------------------------------------------------- checkpoint
    def save(self, directory):
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        np.savez(
            d / "arrays.npz",
            dense=self._dense,
            terms=self._terms,
            impacts=self._impacts,
            tf=self._tf,
            dl=self._dl,
            alive=self._alive,
            **({"colbert": self._colbert} if self._colbert is not None else {}),
        )
        manifest = {
            "config": {
                f.name: getattr(self.config, f.name)
                for f in dataclasses.fields(self.config)
                if f.name != "device_dtype"  # a dtype object, not JSON
            },
            "ids": self.ids,
            "n_rows": self.n_rows,
        }
        (d / "manifest.json").write_text(json.dumps(manifest))
        self.meta.save(d / "metadata.json")
        if self.bm25_stats is not None:
            (d / "bm25.json").write_text(
                json.dumps(self.bm25_stats.to_dict())
            )

    @classmethod
    def load(cls, directory, device=None, mesh=None) -> "DeviceIndex":
        d = pathlib.Path(directory)
        manifest = json.loads((d / "manifest.json").read_text())
        cfg = IndexConfig(**manifest["config"])
        idx = cls(cfg, device=device, mesh=mesh)
        arrays = np.load(d / "arrays.npz")
        idx._dense = arrays["dense"]
        idx._terms = arrays["terms"]
        idx._impacts = arrays["impacts"]
        idx._alive = arrays["alive"]
        n = idx._terms.shape[0]
        idx._tf = (arrays["tf"] if "tf" in arrays
                   else np.zeros_like(idx._terms))
        idx._dl = (arrays["dl"] if "dl" in arrays
                   else np.zeros((n,), np.int32))
        if "colbert" in arrays:
            idx._colbert = arrays["colbert"]
        idx.ids = list(manifest["ids"])
        idx._id_pos = {cid: i for i, cid in enumerate(idx.ids)}
        idx.meta = MetadataStore.load(d / "metadata.json")
        bm25_path = d / "bm25.json"
        if bm25_path.exists():
            from ..retrieval.bm25 import Bm25Stats

            idx.bm25_stats = Bm25Stats.from_dict(
                json.loads(bm25_path.read_text())
            )
        return idx


def _local_row_range(mesh, n_pad: int) -> tuple[int, int]:
    """[lo, hi) of the image rows this rank holds (all without a mesh)."""
    return (0, n_pad) if mesh is None else pmesh.local_row_range(n_pad, mesh)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
