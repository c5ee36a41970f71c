"""The decoder's attention dispatch (`ops/causal_attention.py`) on the CPU.

On the CPU `GQAttention` takes the plain twin, whose outputs are the
pre-kernel decoder's bit for bit: the blocked f32 einsums below are that
code as it stood, patched in for the comparison. Calls of a decode step's
1 + k rows are sent to the plain path by shape; the twin's valid rows do
not depend on what the padding rows hold. The kernel itself is held to the
twin on the card (`tests/test_torch_cuda.py`).
"""

import numpy as np
import pytest
import torch

from rag_dpo_tpu_torch.models import decoder
from rag_dpo_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderModel,
    build_decoder,
    init_random_,
)
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops.causal_attention import (
    TILE_ROWS,
    causal_attention,
    causal_attention_plain,
    kernel_fits,
)


def _pre_kernel_attention(q, k_all, v_all, positions, write_mask=None,
                          attn_mask=None, rows=None):
    """`GQAttention.forward`'s attention before the kernel, verbatim, cast
    to the activation dtype as its `o_proj(_as(ctx, cfg.dtype))` did."""
    b, s, nh, dh = q.shape
    nkv, kv_len = k_all.shape[2], k_all.shape[1]
    group = nh // nkv
    kf, vf = k_all.to(torch.float32), v_all.to(torch.float32)
    qg = q.to(torch.float32).reshape(b, s, nkv, group, dh)
    key_pos = torch.arange(kv_len, device=q.device)
    ctx = torch.empty((b, s, nkv, group, dh), dtype=torch.float32,
                      device=q.device)
    step = max(1, (1 << 29) // (4 * b * nh * kv_len))
    for i in range(0, s, step):
        logits = torch.einsum("bskgd,bmkd->bksgm", qg[:, i:i + step],
                              kf) / (dh ** 0.5)
        mask = key_pos[None, None, None, None, :] \
            <= positions[:, None, i:i + step, None, None]
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, None, :kv_len]
        probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
        ctx[:, i:i + step] = torch.einsum("bksgm,bmkd->bskgd", probs, vf)
    return ctx.reshape(b, s, nh, dh).to(q.dtype)


# the configs of tests/test_torch_decoder.py, and the int8 K/V cache
CONFIGS = {
    "f32": dict(dtype=torch.float32),
    "f32_tied": dict(dtype=torch.float32, tie_embeddings=True),
    "f32_int8": dict(dtype=torch.float32, quantize_weights=True),
    "bf16": dict(),
    "bf16_tied": dict(tie_embeddings=True),
    "bf16_params": dict(param_dtype=torch.bfloat16),
    "bf16_int8_tied": dict(quantize_weights=True, tie_embeddings=True),
    "bf16_int8_head": dict(quantize_weights=True),
    "f32_kv8": dict(dtype=torch.float32, quantize_kv=True),
    "bf16_int8_kv8": dict(quantize_weights=True, tie_embeddings=True,
                          quantize_kv=True),
}


def _runs(model, cfg):
    """Logits of every path that reaches the attention: a full forward, a
    padded cached prefill, a suffix from a cached prefix, decode steps, and
    a key mask."""
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(3, 512, (2, 40))).long()
    out = [model(ids)]
    caches = DecoderModel.init_cache(cfg, 2, 64)
    pos = torch.arange(24).expand(2, 24)
    valid = pos < torch.tensor([24, 17])[:, None]
    lg, caches = model(ids[:, :24], pos, caches, write_mask=valid,
                       last_index=torch.tensor([23, 16]), kv_len=24)
    out.append(lg)
    start = torch.tensor([24, 17])
    pos2 = start[:, None] + torch.arange(12)[None]
    lg, caches = model(ids[:, 24:36], pos2, caches,
                       write_mask=torch.ones(2, 12, dtype=torch.bool),
                       kv_len=36)
    out.append(lg)
    for t in range(3):
        step, caches = model(ids[:, 36 + t:37 + t], (pos2[:, -1:] + 1 + t),
                             caches, kv_len=37 + t)
        out.append(step)
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, :5] = False
    out.append(model(ids, attn_mask=mask))
    return [x.float() for x in out]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gqattention_on_the_cpu_is_the_pre_kernel_path(name, monkeypatch):
    cfg = DecoderConfig.tiny(**CONFIGS[name])
    model = init_random_(build_decoder(cfg, "cpu"), 3)
    before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    with torch.no_grad():
        got = _runs(model, cfg)
        monkeypatch.setattr(decoder, "causal_attention",
                            _pre_kernel_attention)
        want = _runs(model, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)) == before


def _qkv(b, s, nh, nkv, dh, dtype, kv_len=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    kv_len = kv_len or s
    q = torch.randn((b, s, nh, dh), generator=gen).to(dtype)
    k, v = (torch.randn((b, kv_len, nkv, dh), generator=gen).to(dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("s,nh,nkv,dh,dtype,fits", [
    # the 12B's decode step: 1 + k rows of 4 heads a KV head
    *[(s, 32, 8, 128, torch.bfloat16, False) for s in (1, 2, 5, 15)],
    # its prefills: 16 positions of 4 heads fill a tile
    *[(s, 32, 8, 128, torch.bfloat16, True) for s in (16, 64, 2049)],
    # a TP rank's heads, the tiny decoder's groups of 2, MHA, f32
    (16, 8, 2, 128, torch.bfloat16, True),
    (31, 4, 2, 16, torch.float32, False),
    (32, 4, 2, 16, torch.float32, True),
    (63, 4, 4, 64, torch.float32, False),
    (64, 4, 4, 64, torch.float32, True),
    # heads past the widest instance, and dtypes it has none for
    (256, 32, 8, 256, torch.bfloat16, False),
    (256, 32, 8, 128, torch.float16, False),
])
def test_kernel_fits_by_shape_and_dtype(s, nh, nkv, dh, dtype, fits):
    q, k, _ = _qkv(1, s, nh, nkv, dh, dtype, kv_len=1)
    assert kernel_fits(q, k) is fits
    assert (s * nh // nkv >= TILE_ROWS) or not fits


def test_kernel_fits_wants_one_dtype():
    q, k, _ = _qkv(1, 64, 4, 2, 32, torch.bfloat16)
    assert not kernel_fits(q, k.float())
    assert not kernel_fits(q.float(), k)


def test_the_cpu_takes_the_plain_twin_at_any_size():
    q, k, v = _qkv(1, 64, 8, 2, 32, torch.float32)
    pos = torch.arange(64)[None]
    assert kernel_fits(q, k)
    before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    assert torch.equal(causal_attention(q, k, v, pos),
                       causal_attention_plain(q, k, v, pos))
    assert (dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)) == before


@pytest.mark.parametrize("b,s,nh,nkv,dh,start,lens,dtype", [
    (1, 64, 8, 2, 16, [0], [37], torch.float32),
    (2, 48, 6, 2, 32, [0, 0], [48, 1], torch.bfloat16),
    # a suffix after a cached prefix: positions from start, kv_len start + s
    (2, 32, 4, 1, 16, [20, 9], [32, 13], torch.float32),
])
def test_plain_twin_valid_rows_ignore_the_padding_rows(b, s, nh, nkv, dh,
                                                      start, lens, dtype):
    """Rows past a row's length: their queries, and their K/V (which a
    write_mask would zero before the cache write), change nothing in the
    valid rows' outputs."""
    start, lens = torch.tensor(start), torch.tensor(lens)
    kv_len = int(start.max()) + s
    q, k, v = _qkv(b, s, nh, nkv, dh, dtype, kv_len)
    pos = start[:, None] + torch.arange(s)[None]
    want = causal_attention_plain(q, k, v, pos)
    pad = torch.arange(s)[None] >= lens[:, None]            # [b, s]
    gen = torch.Generator().manual_seed(1)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[pad] = (1e4 * torch.randn(q2[pad].shape, generator=gen)).to(dtype)
    for x in (k2, v2):
        for r in range(b):
            rows = slice(int(start[r] + lens[r]), kv_len)
            x[r, rows] = (1e4 * torch.randn(x[r, rows].shape,
                                            generator=gen)).to(dtype)
    got = causal_attention_plain(q2, k2, v2, pos)
    valid = ~pad
    assert torch.equal(got[valid], want[valid])
