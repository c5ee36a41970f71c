"""The port's CUDA kernels against their plain twins, on an NVIDIA card.

Every test here is marked `cuda` and skips without a card. The file imports
no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` skips `tests/conftest.py`, which sets up the JAX CPU mesh.)
"""

import numpy as np
import pytest
import torch

from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from rag_dpo_tpu_torch.ops.flash_attention_bwd import (
    _row_delta,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fused,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
)
from rag_dpo_tpu_torch.ops.maxsim import maxsim, maxsim_plain
from rag_dpo_tpu_torch.ops.sparse import ell_topk, ell_topk_plain

pytestmark = pytest.mark.cuda

# f32: the backward kernels sum in tiles of 8 to 64 rows on the tensor cores
# as 3xTF32 (~2^-21 a product) and the twins in one block, both with f32
# accumulators; bf16 rounds the outputs.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the forward's products keep f32 accuracy on the tensor cores (3xTF32,
# ~2^-21 a product): within 1e-5 of the twin on unit Gaussian inputs, where
# one TF32 product (~1e-3) is not
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,s,dh,dtype,lens", [
    (2, 4, 200, 64, torch.float32, [200, 0]),
    (3, 2, 65, 16, torch.float32, [65, 1, 64]),
    (2, 2, 130, 32, torch.float32, None),
    (2, 2, 96, 128, torch.float32, [96, 33]),
    (4, 16, 512, 64, torch.float32, None),
    (4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]),
    (1, 1, 1, 64, torch.float32, [1]),
    # the training shape, 16 ragged rows as a batch of pairs gives them
    (16, 16, 192, 64, torch.float32,
     [192, 0, 1, 63, 64, 65, 127, 128, 129, 191, 5, 17, 100, 150, 33, 2]),
    # any head width (C-20): zero-filled columns past Dh, several output
    # passes past 128; S off the 64-row tiles, lengths 0, 1 and S
    *[(3, 2, s, dh, dtype, [s, 0, 1])
      for dh in (8, 24, 40, 80, 96, 160, 200, 256, 320, 512)
      for dtype in (torch.float32, torch.bfloat16)
      for s in ((63, 513) if dh in (80, 320) else (65,))],
    (2, 3, 1, 40, torch.float32, [1, 0]),
    (2, 3, 100, 33, torch.float32, [100, 64]),   # not whole 16-byte chunks
    (2, 3, 100, 12, torch.bfloat16, [7, 100]),
])
def test_flash_kernel_matches_plain(dev, b, h, s, dh, dtype, lens):
    gen = torch.Generator(device=dev)
    gen.manual_seed(s * dh)
    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    lengths = None if lens is None else torch.tensor(
        lens, dtype=torch.int32, device=dev)
    before = _kernels.LAUNCHES["flash_fwd"]
    out, lse = flash_attention(q, k, v, lengths, return_lse=True)
    assert _kernels.LAUNCHES["flash_fwd"] == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, lengths, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.shape == (b, h, s, 1)
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    if lens is not None and 0 in lens:
        z = lens.index(0)
        assert (out[z] == 0).all() and (lse[z] == -1e20).all()
    # the no-lse variant is the same kernel, and no atomics: the same bits
    assert torch.equal(flash_attention(q, k, v, lengths), out)
    out2, lse2 = flash_attention(q, k, v, lengths, return_lse=True)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert _kernels.LAUNCHES["flash_fwd"] == before + 3


@pytest.mark.parametrize("b,h,s,dh,dtype,lens", [
    (16, 16, 192, 64, torch.float32, None),       # the training shape
    (64, 16, 512, 64, torch.float32, None),
    (8, 16, 300, 64, torch.float32, [300, 0, 1, 17, 64, 65, 299, 128]),
    (4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]),
    (4, 8, 200, 16, torch.float32, [200, 0, 64, 199]),
    (4, 8, 130, 128, torch.float32, [130, 64, 0, 1]),
    (2, 2, 96, 32, torch.float32, [96, 33]),
    (1, 1, 1, 64, torch.float32, [1]),
    # other head widths go in padded with zero columns (C-20)
    (3, 4, 150, 80, torch.float32, [150, 0, 77]),
    (2, 2, 70, 320, torch.float32, [70, 1]),
    (2, 2, 70, 200, torch.bfloat16, [70, 33]),
    (2, 2, 40, 8, torch.float32, [40, 39]),
    # the edges of the 64-row tiles (and of the 16- and 8-row walked tiles
    # of the wide instances), each batch with a row whose keys are all
    # masked (length 0)
    *[(2, 2, s, dh, torch.float32, [s, 0])
      for s in (1, 63, 65, 127, 129, 193, 513) for dh in (64, 128)],
    (3, 2, 129, 320, torch.float32, [129, 0, 64]),
    (3, 2, 193, 256, torch.bfloat16, [193, 0, 100]),
    # bf16 at the widths the encoders use
    (4, 4, 192, 64, torch.bfloat16, [192, 0, 63, 65]),
    (4, 4, 192, 128, torch.bfloat16, [192, 0, 127, 129]),
    # the other instances, each with its own walked rows and column passes:
    # f32 at width 256, bf16 at 16, 32 and 512 (Dh 320 padded)
    (3, 2, 129, 256, torch.float32, [129, 0, 64]),
    (3, 2, 70, 200, torch.float32, [70, 0, 33]),
    (3, 2, 65, 16, torch.bfloat16, [65, 0, 33]),
    (3, 2, 97, 32, torch.bfloat16, [97, 0, 50]),
    (3, 2, 129, 320, torch.bfloat16, [129, 0, 64]),
])
def test_flash_bwd_kernels_match_plain(dev, b, h, s, dh, dtype, lens):
    gen = torch.Generator(device=dev)
    gen.manual_seed(s * dh + b)
    q, k, v, g = (torch.randn((b, h, s, dh), generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    lengths = (torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32) if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=dev))
    out, lse = flash_attention(q, k, v, lengths, return_lse=True)
    args = (q, k, v, lengths, lse, _row_delta(out, g), g, dh ** -0.5)
    before = dict(_kernels.LAUNCHES)
    dq, (dk, dv) = flash_bwd_dq(*args), flash_bwd_dkv(*args)
    assert _kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    rq, (rk, rv) = flash_bwd_dq_plain(*args), flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")
    if lens is not None and 0 in lens:
        z = lens.index(0)
        assert not dq[z].any() and not dk[z].any() and not dv[z].any()
    # the pair of kernels is what the wrapper runs
    for got, ref in zip(flash_attention_bwd(q, k, v, lengths, out, lse, g),
                        flash_attention_bwd_plain(q, k, v, lengths, out, lse,
                                                  g)):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dh,dtype", [(64, torch.float32),
                                      (64, torch.bfloat16),
                                      (320, torch.float32)])
def test_flash_bwd_kernels_give_the_same_bits_twice(dev, dh, dtype):
    """No atomics: each output element is summed in one fixed order."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(dh)
    q, k, v, g = (torch.randn((16, 4, 192, dh), generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    lengths = torch.randint(1, 193, (16,), generator=gen, device=dev,
                            dtype=torch.int32)
    out, lse = flash_attention(q, k, v, lengths, return_lse=True)
    args = (q, k, v, lengths, lse, _row_delta(out, g), g, dh ** -0.5)
    first = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    second = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_encoder_backward_on_the_card_matches_the_cpu(dev):
    """The fault this slice repaired: on the card the flash forward is a
    kernel, so before the fused backward, q, k and v (and everything below
    attention) got no gradient. Now they get the CPU twin's."""
    from rag_dpo_tpu_torch.models import BgeM3Config, BgeM3Model
    from rag_dpo_tpu_torch.models.encoder import init_random_

    model = init_random_(BgeM3Model(BgeM3Config.tiny()),
                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    lengths = torch.tensor([40, 17, 5], dtype=torch.int32)
    ids = torch.full((3, 40), 1, dtype=torch.long)
    for i, n in enumerate(lengths.tolist()):
        ids[i, :n] = torch.from_numpy(rng.integers(4, 1024, size=n))
    grads = {}
    for device in ("cpu", dev):
        m = model.to(device)
        m.zero_grad(set_to_none=True)
        before = _kernels.LAUNCHES["flash_bwd_dkv"]
        out = m(ids.to(device), lengths.to(device))
        loss = (out.dense[:, :8].sum() + out.sparse.mean()
                + out.colbert.square().mean())
        loss.backward()
        if device != "cpu":
            assert _kernels.LAUNCHES["flash_bwd_dkv"] > before
        grads[str(device)] = {n: p.grad.detach().cpu()
                              for n, p in m.named_parameters()}
    cpu, card = grads["cpu"], grads[str(dev)]
    for part in ("query", "key", "value"):
        name = f"encoder.layer_0.attention.{part}.weight"
        assert card[name].abs().sum() > 0, name
    for name, g in cpu.items():
        torch.testing.assert_close(card[name], g, atol=1e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")


def test_flash_fused_gradients_on_the_card(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q, k, v = (torch.randn((2, 4, 70, 64), generator=gen, device=dev)
               .requires_grad_() for _ in range(3))
    lengths = torch.tensor([70, 0], dtype=torch.int32, device=dev)
    out = flash_attention_fused(q, k, v, lengths)
    assert out.grad_fn is not None
    w = torch.randn(out.shape, generator=gen, device=dev)
    (out * w).sum().backward()
    ref_out, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                         lengths, return_lse=True)
    refs = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                     lengths, ref_out, lse, w)
    for t, ref in zip((q, k, v), refs):
        torch.testing.assert_close(t.grad, ref, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        before = _kernels.LAUNCHES["flash_fwd"]
        assert flash_attention_fused(q, k, v, lengths).grad_fn is None
        assert _kernels.LAUNCHES["flash_fwd"] == before + 1


def test_flash_kernel_rejects_unsupported(dev):
    for x in (torch.zeros((1, 1, 8, 513), device=dev),       # past 512
              torch.zeros((1, 1, 8, 64), device=dev).half()):  # dtype
        with pytest.raises(ValueError):
            flash_attention(x, x, x)
        with pytest.raises(ValueError):
            flash_bwd_dq(x, x, x, torch.ones(1, device=dev),
                         torch.zeros((1, 1, 8, 1), device=dev),
                         torch.zeros((1, 1, 8, 1), device=dev), x, 1.0)


def test_ell_kernel_rejects_mismatched_shapes(dev):
    terms = torch.full((8, 4), -1, dtype=torch.int32, device=dev)
    qt = torch.full((1, 2), -2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ell_topk(terms, torch.zeros((8, 3), device=dev), qt,
                 torch.zeros((1, 2), device=dev), k=4)


def _ell_case(rng, n, l, q, t, vocab):
    terms = np.full((n, l), -1, np.int32)
    imps = np.zeros((n, l), np.float32)
    for i in range(n):
        w = rng.integers(0, l + 1)
        terms[i, :w] = rng.choice(vocab, size=w, replace=False)
        imps[i, :w] = rng.uniform(0.1, 2.5, size=w)
    qt = np.full((q, t), -2, np.int32)
    qw = np.zeros((q, t), np.float32)
    for i in range(q):
        w = rng.integers(1, t + 1)
        qt[i, :w] = rng.choice(vocab, size=w, replace=False)
        qw[i, :w] = rng.uniform(0.2, 3.0, size=w)
    return terms, imps, qt, qw


@pytest.mark.parametrize("n,l,q,t,vocab,k", [
    (3000, 8, 3, 6, 50, 40),     # many ties, several blocks
    (2048, 32, 4, 32, 5000, 40),  # the sparse arm's widths
    (30, 4, 2, 3, 10, 10),        # one partial block
    (5000, 16, 1, 1, 100, 1024),  # k = block
    (3000, 24, 1, 100, 400, 40),  # 100 terms: four chunks of the t loop
    (2048, 32, 1, 128, 5000, 40),  # the most the store sends to ELL
    (5000, 16, 2, 8, 100, 2048),  # k > 1024: every row of a block kept
    (99_000, 8, 1, 8, 2000, 1024),  # 97 blocks × 1024 candidates to merge
    (17_408, 32, 4, 32, 4000, 40),  # the serve shape
    (1024, 48, 1, 32, 1500, 40),  # the hermetic replay's: one launch
    (5000, 16, 2, 1, 50, 40),     # T 1: the chain's w0·h0
    (5000, 16, 2, 33, 300, 40),   # T 33: a second chunk of one term
    (3000, 24, 1, 64, 400, 40),   # T 64: two whole chunks
    (3000, 24, 1, 65, 400, 40),
    (3000, 8, 3, 6, 50, 1),       # k 1
    (5000, 16, 1, 8, 100, 1025),  # k past a block
    (3000, 8, 2, 6, 50, 3000),    # k = N, N off 1024
    (1000, 8, 2, 6, 50, 1000),    # k = N, one block, N off 128
    (17_408, 32, 1, 32, 4000, 17_408),  # k = N at the serve width
    (3000, 6, 2, 4, 50, 40),      # L off 4: the slots read one by one
    (2000, 7, 1, 5, 30, 300),
])
def test_ell_kernel_matches_plain_ids_exact(dev, n, l, q, t, vocab, k):
    rng = np.random.default_rng(n + k)
    args = [torch.from_numpy(x).to(dev)
            for x in _ell_case(rng, n, l, q, t, vocab)]
    before = _kernels.LAUNCHES["ell_topk"]
    ks, ki = ell_topk(*args, k=k)
    assert _kernels.LAUNCHES["ell_topk"] == before + 1
    ps, pi = ell_topk_plain(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    ks2, ki2 = ell_topk(*args, k=k)
    assert torch.equal(ki2, ki) and torch.equal(ks2, ks)


@pytest.mark.parametrize("n,k", [(5000, 40), (5000, 1025), (1024, 1024),
                                 (2900, 2900)])
def test_ell_kernel_keeps_the_tie_order(dev, n, k):
    """Scores of few values (two slots of three terms, unit impacts): ties
    across blocks, rounds and segments everywhere; all-zero rows; the
    reference's order (block, round, segment) exactly."""
    rng = np.random.default_rng(n + k)
    terms = rng.integers(-1, 3, (n, 2)).astype(np.int32)
    terms[:, 1] = np.where(terms[:, 1] == terms[:, 0], -1, terms[:, 1])
    terms[rng.random(n) < 0.3] = -1          # all-zero rows
    imps = np.where(terms >= 0, 1.0, 0.0).astype(np.float32)
    qt = np.asarray([[0, 1, 2], [2, -2, -2]], np.int32)
    qw = np.asarray([[1.0, 0.5, 0.5], [2.0, 0.0, 0.0]], np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (terms, imps, qt, qw)]
    ks, ki = ell_topk(*args, k=k)
    ps, pi = ell_topk_plain(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))


def test_ell_kernel_ranks_minus_zero_as_zero(dev):
    """Negative weights: a row that matches no term scores fma(w0, 0, w1·0)
    = −0.0; it ties with +0.0 rows, and comes out +0.0, the twin's bits."""
    from rag_dpo_tpu_torch.ops.sparse import ell_scores

    rng = np.random.default_rng(11)
    terms, imps, qt, qw = _ell_case(rng, 3000, 8, 2, 6, 200)
    qw = -np.abs(qw)
    qw[1, 3:] = np.abs(qw[1, 3:])            # signs mixed in query 1
    args = [torch.from_numpy(x).to(dev) for x in (terms, imps, qt, qw)]
    scores = ell_scores(*args)
    assert bool((scores.view(torch.int32) == -2**31).any())  # −0.0 rows
    ks, ki = ell_topk(*args, k=2000)
    ps, pi = ell_topk_plain(*args, 2000)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))


def test_ell_kernel_tie_probes(dev):
    terms = torch.full((300, 4), -1, dtype=torch.int32, device=dev)
    imps = torch.zeros((300, 4), device=dev)
    qt = torch.tensor([[7, -2]], dtype=torch.int32, device=dev)
    qw = torch.tensor([[1.5, 0.0]], device=dev)
    _, ids = ell_topk(terms, imps, qt, qw, k=40)
    assert ids[0, :6].tolist() == [0, 128, 256, 1, 129, 257]
    _, pids = ell_topk_plain(terms, imps, qt, qw, 40)
    assert torch.equal(ids, pids)
    # k beyond the corpus pads with (-1e30, -1)
    s, ids = ell_topk(terms[:5], imps[:5], qt, qw, k=8)
    assert ids[0, 5:].eq(-1).all() and s[0, 5:].eq(-1e30).all()


def _maxsim_case(gen, dev, q, lq, c, ld, d, dtype):
    qv = torch.randn((q, lq, d), generator=gen, device=dev)
    dv = torch.randn((c, ld, d), generator=gen, device=dev).to(dtype)
    q_mask = torch.rand((q, lq), generator=gen, device=dev) > 0.2
    d_mask = torch.rand((c, ld), generator=gen, device=dev) > 0.2
    q_mask[:, 0] = True
    d_mask[:, 0] = True
    d_mask[c // 2] = False            # a candidate with no valid token
    if c > 2:
        # valid rows that are no prefix, none in the first 64-row tiles
        d_mask[-1] = torch.arange(ld, device=dev) % 3 == ld % 3
        d_mask[-1, : ld * 3 // 4] = False
        d_mask[-1, -1] = True
    if q > 1:
        q_mask[-1] = False            # a query with no valid token
    return qv, q_mask, dv, d_mask


# K7: the kernel's products run on the tensor cores at f32 accuracy (the
# query split into two TF32 parts, f32 rows into three: 3xTF32, ~2^-21 a
# product) and sum in mma order, the twin in cuBLAS's, both in f32; maxima
# are exact, so the scores agree to f32 rounding.
MAXSIM_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("q,lq,c,ld,d,dtype", [
    (1, 32, 40, 128, 1024, torch.float16),   # the rerank at full width
    (1, 27, 40, 96, 32, torch.float16),      # the hermetic replay's
    (1, 27, 40, 96, 32, torch.float32),
    (2, 8, 20, 16, 64, torch.float32),
    (1, 16, 100, 32, 128, torch.bfloat16),
    (3, 13, 37, 50, 96, torch.float16),      # Q > 1, odd sizes
    (2, 1, 1, 1, 8, torch.float32),
    (1, 300, 5, 600, 1024, torch.float16),   # more tokens than threads
    (1, 20, 7, 40, 2048, torch.float16),     # over 48 KB of shared memory
    (1, 32, 40, 256, 1024, torch.float16),   # the stored rows' full length
    (1, 4, 3, 8, 16_384, torch.float16),     # C-22: D past the old staging
    (1, 4, 3, 8, 16_384, torch.float32),
    (2, 9, 11, 70, 100, torch.float16),      # D % 8: rows not 16-byte
    (2, 9, 11, 70, 100, torch.bfloat16),     # aligned, loaded by element
    (1, 7, 5, 33, 99, torch.float32),        # D % 4: the query too
    (1, 129, 6, 90, 256, torch.float32),     # LQ past four query tiles
    (5, 16, 12, 80, 128, torch.bfloat16),    # Q 5
])
def test_maxsim_kernel_matches_plain(dev, q, lq, c, ld, d, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(q * c + d)
    args = _maxsim_case(gen, dev, q, lq, c, ld, d, dtype)
    before = _kernels.LAUNCHES["maxsim"]
    got = maxsim(*args)
    assert _kernels.LAUNCHES["maxsim"] == before + 1
    ref = maxsim_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (q, c)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, **MAXSIM_TOL)
    dead = ~args[3].any(dim=1)
    n_valid = args[1].sum(dim=1, dtype=torch.float32)
    torch.testing.assert_close(got[:, dead],
                               (-1e30 * n_valid)[:, None].expand(q, 1),
                               rtol=1e-6, atol=0)
    # no atomics: the same inputs give the same bits
    assert torch.equal(maxsim(*args), got)


def test_maxsim_kernel_rejects_what_it_does_not_take(dev):
    qv = torch.zeros((1, 4, 32), device=dev)
    qm = torch.ones((1, 4), dtype=torch.bool, device=dev)
    dv = torch.zeros((3, 8, 32), dtype=torch.float16, device=dev)
    dm = torch.ones((3, 8), dtype=torch.bool, device=dev)
    for bad in ((qv.half(), qm, dv, dm),            # qv must be f32
                (qv, qm, dv.double(), dm),          # dv f32/f16/bf16
                (qv, qm.int(), dv, dm),             # bool masks
                (qv, qm, dv[:, :, :16], dm[:, :8]),  # D differs
                (qv, qm, dv, dm[:2]),               # mask shape
                (qv, qm, dv.transpose(0, 1), dm.T),  # not contiguous
                (qv.cpu(), qm.cpu(), dv, dm)):      # devices differ
        with pytest.raises(ValueError):
            maxsim(*bad)
    # D = 16,384, past what a block's shared memory holds whole (C-22)
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    wide = (torch.randn((1, 4, 16_384), generator=gen, device=dev), qm,
            torch.randn((3, 8, 16_384), generator=gen,
                        device=dev).half(), dm)
    torch.testing.assert_close(maxsim(*wide), maxsim_plain(*wide),
                               **MAXSIM_TOL)
    assert torch.equal(maxsim(qv, qm, dv, dm), torch.zeros((1, 3),
                                                           device=dev))


def test_maxsim_plan_matches_the_kernels_shared_memory(dev):
    """ops/maxsim.py plans K7 on the CPU; the library computes the shared
    bytes again from the same plan (`maxsim_smem`) and counts one launch a
    call (`maxsim_launches`)."""
    import ctypes

    from rag_dpo_tpu_torch.ops.maxsim import _DV_DTYPES, maxsim_plan

    lib = _kernels.load("maxsim")
    lib.maxsim_smem.restype = ctypes.c_int
    lib.maxsim_smem.argtypes = [ctypes.c_int] * 2
    lib.maxsim_launches.restype = ctypes.c_int
    assert lib.maxsim_launches() == 1
    for dtype, code in _DV_DTYPES.items():
        for q, lq, c, ld, d in ((1, 32, 40, 256, 1024), (1, 27, 40, 96, 32),
                                (1, 4, 3, 8, 16_384), (5, 300, 7, 1, 8),
                                (2, 1, 1, 1, 1)):
            p = maxsim_plan(dtype, q, lq, c, ld, d)
            assert lib.maxsim_smem(code, p.stages) == p.smem, (dtype, q, d)
            assert p.smem <= 232_448


def test_maxsim_rerank_on_the_card_matches_the_cpu(dev):
    """The rerank path on a CUDA index launches K7, runs no twin, and
    reranks the same candidates as the CPU does."""
    import json

    from rag_dpo_tpu_torch.evals.synthetic import build_synthetic_corpus
    from rag_dpo_tpu_torch.evals.train_encoder import QA_DATASET
    from rag_dpo_tpu_torch.ingest import CorpusIndexer
    from rag_dpo_tpu_torch.models import BgeM3Config
    from rag_dpo_tpu_torch.models.convert import state_dict_to_flax
    from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
    from rag_dpo_tpu_torch.retrieval import HybridRetriever
    from rag_dpo_tpu_torch.retrieval.reranker import MaxSimReranker

    dataset = json.loads(QA_DATASET.read_text())[:6]
    chunks = build_synthetic_corpus(dataset)[:60]
    cfg = EmbedderConfig(model=BgeM3Config.tiny())
    params = state_dict_to_flax(Embedder(cfg, device="cpu").load())
    rerankers, candidates = {}, None
    for device in ("cpu", dev):
        emb = Embedder(cfg, params=params, device=device)
        index, stats, _ = CorpusIndexer(
            emb, with_colbert=True, colbert_len=96).build(chunks)
        rerankers[device] = MaxSimReranker(index, emb)
        if candidates is None:
            ret = HybridRetriever(index, emb, bm25_stats=stats)
            candidates = [ret.retrieve_candidates(it["question"],
                                                  n_candidates=40)
                          for it in dataset]
    before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    for item, cands in zip(dataset, candidates):
        want = rerankers["cpu"].rerank(item["question"], cands)
        got = rerankers[dev].rerank(item["question"], cands)
        assert [c.chunk_id for c in got] == [c.chunk_id for c in want]
        np.testing.assert_allclose([c.rerank_score for c in got],
                                   [c.rerank_score for c in want],
                                   rtol=1e-4, atol=1e-4)
    assert _kernels.LAUNCHES["maxsim"] == before[0]["maxsim"] + len(dataset)
    assert _kernels.PLAIN_ON_CUDA == before[1]


# K4 and K6: the kernels sum each dot in d order, the twins in cuBLAS's, both
# in f32. Scores agree within 1e-5; ids agree except where two rows' twin
# scores lie within 1e-5 of each other (near-ties).
NEAR_TIE = 1e-5


def _topk_case(gen, dev, q, n, d, dtype, pen):
    queries = torch.randn((q, d), generator=gen, device=dev)
    embs = torch.randn((n, d), generator=gen, device=dev)
    embs = embs / embs.norm(dim=1, keepdim=True)
    embs[n // 2:n // 2 + 5] = embs[7]           # exact ties
    queries[0] = embs[7]
    penalty = None
    if pen is not None:
        penalty = torch.zeros(n if pen == "full" else n - n // 7, device=dev)
        penalty[torch.rand(penalty.shape, generator=gen, device=dev)
                < 0.1] = -1e4
    return queries.to(dtype), embs.to(dtype), penalty


def _full_scores(queries, embs, penalty):
    s = queries.float() @ embs.float().T
    if penalty is not None:
        pen = torch.full((embs.shape[0],), -5e29, device=embs.device)
        pen[:penalty.shape[0]] = penalty[:embs.shape[0]]
        s = s + pen
    return s


@pytest.mark.parametrize("q,n,d,k,dtype,pen", [
    (4, 17_408, 1024, 40, torch.bfloat16, "full"),   # the serve shape
    (1, 5000, 64, 40, torch.float32, None),
    (20, 3001, 72, 160, torch.bfloat16, "short"),    # 64-query tiles
    (3, 30, 16, 40, torch.float32, None),            # k > N
    (70, 1000, 8, 256, torch.float32, "full"),
    (1, 200_000, 1024, 40, torch.bfloat16, "full"),
])
def test_fused_topk_kernel_matches_plain(dev, q, n, d, k, dtype, pen):
    gen = torch.Generator(device=dev)
    gen.manual_seed(q * n + k)
    _check_fused_topk(*_topk_case(gen, dev, q, n, d, dtype, pen), k)


# ROADMAP C-17: shapes past the former limits (Q 7 and 300, D 1000 padded and
# 1536, k 512, 1024 and 4096 with the lists in the candidate scratch), with
# unit queries as the store sends them, so 1e-5 stays an absolute bound on
# scores of at most 1 at any D.
@pytest.mark.parametrize("q,n,d,k,dtype,pen", [
    (7, 20_000, 1000, 40, torch.bfloat16, "full"),
    (300, 30_000, 1536, 40, torch.bfloat16, "short"),
    (5, 40_000, 1024, 512, torch.bfloat16, "full"),
    (64, 50_000, 256, 1024, torch.bfloat16, None),
    (2, 9000, 128, 4096, torch.bfloat16, None),
    (129, 3000, 8, 40, torch.bfloat16, None),
    (7, 20_000, 1000, 512, torch.float32, "full"),
    (3, 8000, 1536, 1024, torch.float32, None),
    (300, 5000, 64, 40, torch.float32, "full"),
])
def test_fused_topk_kernel_past_former_limits(dev, q, n, d, k, dtype, pen):
    gen = torch.Generator(device=dev)
    gen.manual_seed(q * n + k)
    queries, embs, penalty = _topk_case(gen, dev, q, n, d, torch.float32,
                                        pen)
    queries = queries / queries.norm(dim=1, keepdim=True)
    _check_fused_topk(queries.to(dtype), embs.to(dtype), penalty, k)


def _check_fused_topk(queries, embs, penalty, k):
    from rag_dpo_tpu_torch.ops.topk import fused_topk, fused_topk_plain

    (q, _), n = queries.shape, embs.shape[0]
    before = _kernels.LAUNCHES["fused_topk"]
    ks, ki = fused_topk(queries, embs, k, penalty=penalty)
    assert _kernels.LAUNCHES["fused_topk"] == before + 1
    ps, pi = fused_topk_plain(queries, embs, k, penalty=penalty)
    torch.cuda.synchronize()
    assert ks.shape == (q, k) and ki.dtype == torch.int32
    valid = pi >= 0
    assert torch.equal(ki >= 0, valid)
    assert float((ks - ps).abs().max()) <= NEAR_TIE
    # every id the kernel returns carries the twin's score of its slot
    full = _full_scores(queries, embs, penalty)
    got = torch.gather(full, 1, ki.clamp_min(0).long())
    assert float((got - ps)[valid].abs().max()) <= NEAR_TIE
    assert (ki[~valid] == -1).all() and (ks[~valid] == -1e30).all()
    if k <= n:
        assert ki[0, :6].tolist() == [7, n // 2, n // 2 + 1, n // 2 + 2,
                                      n // 2 + 3, n // 2 + 4] \
            or penalty is not None
    # no atomics: the same inputs give the same bits
    ks2, ki2 = fused_topk(queries, embs, k, penalty=penalty)
    assert torch.equal(ks2, ks) and torch.equal(ki2, ki)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plans_match_the_kernels_shared_memory(dev, dtype):
    """topk_plan and candidates_plan size shared memory on the CPU; the
    kernels lay it out themselves. Over the grid of the CPU plan tests
    (tests/test_torch_limits.py) both give the same bytes."""
    import ctypes

    from rag_dpo_tpu_torch.ops.topk import candidates_plan, topk_plan

    k4 = _kernels.load("fused_topk")
    k5 = _kernels.load("fused_candidates")
    for fn, n_args in ((k4.fused_topk_smem, 5), (k4.fused_topk_merge_smem, 2),
                       (k5.fused_candidates_smem, 4)):
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * n_args
    code = 1 if dtype == torch.bfloat16 else 0
    for q in (1, 7, 9, 64, 300, 1024):
        for k in (1, 40, 512, 4096):
            p = topk_plan(q, max(k, 50_000), k, dtype)
            assert p["smem_bytes"] == k4.fused_topk_smem(
                code, p["tile_q"], p["stages"], k, int(p["lists_in_smem"]))
            assert p["merge_smem_bytes"] == k4.fused_topk_merge_smem(
                k, int(p["merge_in_smem"]))
        for seg, block_n in ((32, 2048), (128, 2048), (384, 768),
                             (512, 8192), (8, 2048), (80, 1280),
                             (1024, 2048), (1000, 2000)):
            p = candidates_plan(q, 1_000_448, dtype, block_n=block_n, seg=seg)
            assert p["smem_bytes"] == k5.fused_candidates_smem(
                code, p["tile_q"], p["stages"], p["span"])


def test_dense_selectors_on_the_card_match_the_cpu(dev):
    """approx_topk and blocked_topk go through K4 on the card and return
    what their CPU code returns, fill slots included."""
    from rag_dpo_tpu_torch.ops.topk import approx_topk, blocked_topk

    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((900, 64)).astype(np.float32))
    pen = torch.zeros(900)
    pen[::5] = -1e4
    for fn in (approx_topk, blocked_topk):
        for n in (900, 10):              # k > N: the fill slots
            before = _kernels.LAUNCHES["fused_topk"]
            cs, ci = fn(q, e[:n], 40, penalty=pen[:n])
            gs, gi = fn(q.to(dev), e[:n].to(dev), 40, penalty=pen[:n].to(dev))
            assert _kernels.LAUNCHES["fused_topk"] == before + 1
            assert torch.equal(gi.cpu(), ci)
            torch.testing.assert_close(gs.cpu(), cs, atol=1e-5, rtol=0)


def test_fused_topk_kernel_rejects_what_it_does_not_take(dev):
    """Only what JAX refuses too: a mismatched D, an empty axis, mixed or
    other dtypes; k and D past the former limits, strides and D % 8 now run."""
    from rag_dpo_tpu_torch.ops.topk import fused_topk, fused_topk_plain

    q = torch.zeros((2, 64), device=dev)
    e = torch.zeros((100, 64), device=dev)
    for bad_q, bad_e, k in ((q, e, 0),                           # k
                            (q[:, :60], e, 10),                  # D differs
                            (q[:0], e, 10),                      # empty
                            (q.bfloat16(), e, 10),               # dtypes
                            (q.double(), e.double(), 10),
                            (q.cpu(), e, 10)):                   # devices
        with pytest.raises(ValueError):
            fused_topk(bad_q, bad_e, k)
    # the card keeps running after a refused shape
    s, i = fused_topk(q, e, 4)
    assert i[0].tolist() == [0, 1, 2, 3] and (s == 0).all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    qr = torch.randn((3, 1032), generator=gen, device=dev)
    er = torch.randn((500, 1032), generator=gen, device=dev)
    qr, er = (x / x.norm(dim=1, keepdim=True) for x in (qr, er))
    for qq, ee, k in ((qr[:, :60], er[:, :60], 10),        # D % 8
                      (qr, er, 257),                        # k past 256
                      (qr, er.T.contiguous().T, 10)):       # strides
        ks, ki = fused_topk(qq, ee, k)
        ps, _ = fused_topk_plain(qq, ee, k)
        got = torch.gather(qq @ ee.T, 1, ki.long())   # ids carry their scores
        assert float((ks - ps).abs().max()) <= 1e-4
        assert float((got - ps).abs().max()) <= 1e-4


def _pooled_case(gen, dev, q, n, d, pen):
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows

    e = torch.randn((n, d), generator=gen, device=dev)
    e = e / e.norm(dim=1, keepdim=True)
    e_i8, e_scale = quantize_rows(e)
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries = (queries / queries.norm(dim=1, keepdim=True)).bfloat16()
    penalty = None
    if pen is not None:
        penalty = torch.zeros(n if pen == "full" else n - n // 9, device=dev)
        penalty[torch.rand(penalty.shape, generator=gen, device=dev)
                < 0.1] = -1e4
    return queries, e_i8, e_scale, penalty


def assert_pooled_close(kv, ki, pv, pi, queries, e_i8, e_scale, penalty,
                        block_n, group):
    """Values within one bf16 ulp; ids equal but where the group's two
    best f32 scores (the twin's arithmetic) lie within 1e-5. Returns the
    number of such near-tie groups whose id differs."""
    assert kv.dtype == torch.bfloat16 and ki.dtype == torch.int32
    assert kv.shape == pv.shape and ki.shape == pi.shape
    ulp = torch.ldexp(torch.ones_like(pv.float()),
                      torch.frexp(pv.float()).exponent - 8)
    assert bool(((kv.float() - pv.float()).abs() <= ulp).all())
    q, n = queries.shape[0], e_i8.shape[0]
    nb = -(-n // block_n)
    s = (queries.float() @ e_i8.float().T) * e_scale
    if penalty is not None:
        pen = torch.full((n,), -5e29, device=s.device)
        pen[:penalty.shape[0]] = penalty[:n]
        s = s + pen
    full = torch.full((q, nb * block_n), -1e30, device=s.device)
    full[:, :n] = s
    top2 = full.reshape(q, nb, group, block_n // group).topk(2, dim=2).values
    near = (top2[:, :, 0] - top2[:, :, 1] <= NEAR_TIE).reshape(q, -1)
    differ = ki != pi
    assert not bool((differ & ~near).any())
    return int(differ.sum())


@pytest.mark.parametrize("q,n,d,block_n,group,pen", [
    (4, 20_000, 1024, 8192, 64, "full"),
    (1, 9000, 64, 8192, 64, None),
    (70, 5000, 128, 1024, 8, "short"),      # 64-query tiles
    (3, 700, 32, 256, 2, "full"),
    (2, 1000, 16, 96, 4, None),             # 24 groups a block
    (256, 100_000, 1024, 8192, 64, "full"),
    (4, 20_000, 1536, 8192, 64, "full"),    # past the former D limit (C-17)
    (3, 5000, 1000, 1024, 8, None),          # D padded to 1008
])
def test_pooled_kernel_matches_plain(dev, q, n, d, block_n, group, pen):
    from rag_dpo_tpu_torch.ops.pooled import (
        pooled_group_max,
        pooled_group_max_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(q + n + group)
    args = _pooled_case(gen, dev, q, n, d, pen)
    before = _kernels.LAUNCHES["pooled_max"]
    kv, ki = pooled_group_max(*args, block_n=block_n, group=group)
    assert _kernels.LAUNCHES["pooled_max"] == before + 1
    pv, pi = pooled_group_max_plain(*args, block_n=block_n, group=group)
    torch.cuda.synchronize()
    assert_pooled_close(kv, ki, pv, pi, *args, block_n, group)
    kv2, ki2 = pooled_group_max(*args, block_n=block_n, group=group)
    assert torch.equal(kv2, kv) and torch.equal(ki2, ki)


# K6 on the widening product: every plan (1, 2 and 4 warpgroups of queries,
# resident and streamed queries), N off the block and off a tile's 128
# rows, D from one 16-column piece to past 1024, groups past ng in a tile
# (ng 24, ng 200), a last tile with layers past the group (group 7)
@pytest.mark.parametrize("q,n,d,block_n,group,pen", [
    (1, 20_037, 128, 8192, 64, None),
    (16, 20_037, 128, 8192, 64, "short"),
    (17, 20_037, 1024, 8192, 64, "full"),
    (64, 20_037, 1024, 8192, 64, "short"),   # resident queries, D 1024
    (65, 20_037, 256, 8192, 64, None),        # two warpgroups
    (128, 9001, 512, 1024, 8, "full"),
    (129, 9001, 1536, 8192, 64, "short"),     # four warpgroups
    (256, 30_011, 1024, 8192, 64, "full"),
    (300, 9001, 48, 2048, 16, None),          # two query tiles
    (5, 3001, 16, 2048, 16, "full"),
    (70, 5000, 1000, 2048, 16, "short"),      # D padded to 1008
    (3, 4000, 1536, 1024, 8, None),           # one warpgroup, D 1536
    (33, 2000, 64, 48, 2, "full"),            # ng 24
    (2, 999, 32, 896, 7, "short"),            # group 7: a partial last tile
    (40, 5000, 128, 600, 3, None),            # ng 200: a partial group tile
])
def test_pooled_kernel_plans_match_plain(dev, q, n, d, block_n, group, pen):
    test_pooled_kernel_matches_plain(dev, q, n, d, block_n, group, pen)


def test_pooled_kernel_every_row_penalised(dev):
    """A penalty of length 0: every row lies past it (-5e29), so no group
    has a max above -5e29 and every id is -1."""
    from rag_dpo_tpu_torch.ops.pooled import (
        pooled_group_max,
        pooled_group_max_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    queries, e_i8, e_scale, _ = _pooled_case(gen, dev, 70, 9000, 256, None)
    args = (queries, e_i8, e_scale, torch.zeros(0, device=dev))
    kv, ki = pooled_group_max(*args, block_n=2048, group=16)
    pv, pi = pooled_group_max_plain(*args, block_n=2048, group=16)
    torch.cuda.synchronize()
    assert bool((ki == -1).all()) and bool((pi == -1).all())
    assert_pooled_close(kv, ki, pv, pi, *args, 2048, 16)


@pytest.mark.parametrize("q", [1, 64, 200])
def test_pooled_kernel_ties_go_to_the_lowest_row(dev, q):
    """Equal rows planted in one group (layers 3, 10, 40 of group 5 in
    block 1) under a query equal to them: the max is theirs and its id the
    lowest row's, as in the twin."""
    from rag_dpo_tpu_torch.ops.pooled import (
        pooled_group_max,
        pooled_group_max_plain,
    )
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(q)
    block_n, group, n, d = 8192, 64, 20_000, 256
    ng = block_n // group
    e = torch.randn((n, d), generator=gen, device=dev)
    e = e / e.norm(dim=1, keepdim=True)
    planted = [block_n + a * ng + 5 for a in (40, 3, 10)]
    e[planted] = e[planted[0]].clone()
    e_i8, e_scale = quantize_rows(e)
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries[0] = e[planted[0]] * 3
    queries = (queries / queries.norm(dim=1, keepdim=True)).bfloat16()
    kv, ki = pooled_group_max(queries, e_i8, e_scale, block_n=block_n,
                              group=group)
    pv, pi = pooled_group_max_plain(queries, e_i8, e_scale, block_n=block_n,
                                    group=group)
    torch.cuda.synchronize()
    assert int(ki[0, ng + 5]) == int(pi[0, ng + 5]) == block_n + 3 * ng + 5
    assert_pooled_close(kv, ki, pv, pi, queries, e_i8, e_scale, None,
                        block_n, group)


def test_widen_plans_match_the_kernels_shared_memory(dev):
    """ops/widen_product.py sizes the product's shared memory on the CPU;
    both libraries that run it (K6's, K10's) count the same bytes."""
    import ctypes

    from rag_dpo_tpu_torch.ops.widen_product import widen_plan

    for name in ("pooled_max", "int8_block_max_bf16"):
        fn = _kernels.load(name).widen_sweep_smem
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 4
        for q in (1, 64, 65, 128, 129, 256, 300):
            for d in (16, 48, 1000, 1024, 1536, 4096):
                for int8_queries in (False, True):
                    p = widen_plan(q, d, int8_queries=int8_queries)
                    assert p.smem == fn(p.nq, p.stages, int(p.resident),
                                        p.chunks)


def test_pooled_kernel_rejects_what_it_does_not_take(dev):
    from rag_dpo_tpu_torch.ops.pooled import pooled_group_max

    q = torch.zeros((2, 64), dtype=torch.bfloat16, device=dev)
    e = torch.zeros((100, 64), dtype=torch.int8, device=dev)
    sc = torch.ones(100, device=dev)
    for args, kw in (((q.float(), e, sc), {}),                 # bf16 queries
                     ((q, e.float(), sc), {}),                 # int8 rows
                     ((q, e, sc[:50]), {}),                    # scale shape
                     ((q, e, sc), {"block_n": 100, "group": 64}),
                     ((q.cpu(), e, sc), {})):
        with pytest.raises(ValueError):
            pooled_group_max(*args, **kw)
    v, i = pooled_group_max(q, e, sc, block_n=64, group=8)
    assert v.shape == (2, 16) and (i >= 0).all() and (v == 0).all()


def test_int8_store_on_the_card_matches_the_cpu(dev):
    """The default int8 arm on the card ranks by int8 × int8 as the CPU does
    (ROADMAP C-14): it launches no kernel of the port (the product is
    `torch._int_mm`), runs no twin, and returns the CPU's ids and exactly
    refined scores."""
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig

    rng = np.random.default_rng(6)
    dense = rng.standard_normal((40_000, 64)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    terms = rng.integers(0, 500, (40_000, 8)).astype(np.int32)
    imps = np.abs(rng.standard_normal((40_000, 8))).astype(np.float32)
    ids = [f"r{i}" for i in range(40_000)]
    q = rng.standard_normal((16, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt, qw = terms[:16], np.ones((16, 8), np.float32)
    out = {}
    for device in ("cpu", dev):
        idx = DeviceIndex(IndexConfig(dim=64, ell_width=8,
                                      quantize_int8=True,
                                      postings_threshold=1000), device=device)
        idx.add(ids, dense, terms=terms, impacts=imps)
        idx.delete(ids[::50])
        before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
        dense_out = idx.search_dense(q, 40)
        after = dict(_kernels.LAUNCHES)
        out[str(device)] = (dense_out, idx.search_sparse(qt, qw, 40))
    assert after == before[0]
    assert _kernels.PLAIN_ON_CUDA == before[1]
    (cs, ci), (css, csi) = out["cpu"]
    (gs, gi), (gss, gsi) = out[str(dev)]
    # integer products, then the same f32 scale and penalty passes: the same
    # candidates on both devices, refined by the same host code
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_array_equal(gs, cs)
    # the postings engine adds in float64: the same bits on both devices
    np.testing.assert_array_equal(gsi, csi)
    np.testing.assert_array_equal(gss, css)


# K5: the kernel sums each dot in d order, the twin in cuBLAS's, both in f32.
# Strip and output scores agree within 1e-5 (relative past 1: a row under a
# -1e4 penalty rounds to 2^-10); ids agree except where the twin's scores of
# the two rows lie that close (near-ties).
def assert_candidates_close(ks, ki, ps, pi, queries, embs, penalty):
    assert ks.shape == ps.shape and ki.dtype == pi.dtype == torch.int32
    tol = NEAR_TIE * ps.abs().clamp_min(1.0)
    assert bool(((ks - ps).abs() <= tol).all())
    valid = pi >= 0
    assert torch.equal(ki >= 0, valid)
    full = _full_scores(queries, embs, penalty)
    got = torch.gather(full, 1, ki.clamp_min(0).long())
    assert bool(((got - ps).abs() <= tol)[valid].all())
    assert (ks[~valid] <= -5e29).all()


@pytest.mark.parametrize("q,n,d,k,dtype,pen,block_n,seg,per_seg", [
    (16, 10_000, 256, 20, torch.float32, None, 2048, 128, 2),  # hw_smoke
    (3, 212, 16, 40, torch.float32, None, 2048, 128, 2),       # 4 valid ids
    (1, 5000, 64, 40, torch.float32, "full", 1024, 64, 3),
    (20, 3001, 72, 40, torch.bfloat16, "short", 2048, 128, 1),  # 64-q tiles
    (70, 9000, 32, 50, torch.bfloat16, "full", 768, 96, 2),    # 384-row span
    (5, 4000, 1024, 40, torch.bfloat16, "full", 512, 256, 4),
    (2, 300, 8, 20, torch.float32, None, 256, 64, 1),          # k > strip
    (64, 200_000, 1024, 40, torch.bfloat16, "full", 2048, 128, 2),
    # every seg dividing block_n (C-19): narrower than a warp, spans cut
    # short of a 128-row tile, segments cut into 512-row pieces and merged
    (9, 5000, 64, 40, torch.float32, "full", 2048, 8, 3),
    (9, 5000, 64, 40, torch.bfloat16, "short", 2048, 16, 2),
    (5, 7000, 64, 40, torch.bfloat16, "full", 768, 24, 2),
    (70, 9000, 64, 40, torch.bfloat16, None, 1536, 48, 2),
    (3, 9000, 64, 40, torch.float32, "full", 1280, 80, 2),
    (20, 9000, 64, 40, torch.bfloat16, "full", 1280, 80, 80),
    (3, 20_000, 64, 40, torch.float32, "short", 1280, 640, 3),
    (70, 30_000, 64, 40, torch.bfloat16, "full", 2048, 1024, 2),
    (4, 30_000, 64, 100, torch.bfloat16, None, 2048, 2048, 600),
    (2, 3000, 16, 40, torch.float32, None, 2000, 1000, 1),
])
def test_fused_candidates_kernel_matches_plain(dev, q, n, d, k, dtype, pen,
                                               block_n, seg, per_seg):
    gen = torch.Generator(device=dev)
    gen.manual_seed(q * n + seg)
    _check_fused_candidates(*_topk_case(gen, dev, q, n, d, dtype, pen), k,
                            block_n, seg, per_seg)


# ROADMAP C-17 for K5: Q 7, 130 and 300, D 1000 (padded) and 1536, unit
# queries as in the K4 test above
@pytest.mark.parametrize("q,n,d,k,dtype,pen,block_n,seg,per_seg", [
    (7, 20_000, 1000, 40, torch.bfloat16, "full", 2048, 128, 2),
    (300, 30_000, 1536, 512, torch.bfloat16, "short", 2048, 128, 2),
    (130, 9000, 64, 40, torch.bfloat16, None, 768, 384, 2),
    (3, 8000, 1536, 1024, torch.float32, None, 1024, 512, 3),
])
def test_fused_candidates_kernel_past_former_limits(dev, q, n, d, k, dtype,
                                                    pen, block_n, seg,
                                                    per_seg):
    gen = torch.Generator(device=dev)
    gen.manual_seed(q * n + seg)
    queries, embs, penalty = _topk_case(gen, dev, q, n, d, torch.float32,
                                        pen)
    queries = queries / queries.norm(dim=1, keepdim=True)
    _check_fused_candidates(queries.to(dtype), embs.to(dtype), penalty, k,
                            block_n, seg, per_seg)


def _check_fused_candidates(queries, embs, penalty, k, block_n, seg,
                            per_seg):
    from rag_dpo_tpu_torch.ops.topk import (
        fused_candidates_topk,
        fused_candidates_topk_plain,
        seg_candidates,
        seg_candidates_plain,
    )

    (q, _), n = queries.shape, embs.shape[0]
    kw = dict(penalty=penalty, block_n=block_n, seg=seg, per_seg=per_seg)
    before = _kernels.LAUNCHES["fused_candidates"]
    strip = seg_candidates(queries, embs, **kw)
    out = fused_candidates_topk(queries, embs, k, **kw)
    assert _kernels.LAUNCHES["fused_candidates"] == before + 2
    plain_strip = seg_candidates_plain(queries, embs, **kw)
    plain_out = fused_candidates_topk_plain(queries, embs, k, **kw)
    torch.cuda.synchronize()
    width = -(-n // block_n) * (block_n // seg) * per_seg
    assert strip[0].shape == (q, width) and out[0].shape == (q, k)
    assert_candidates_close(*strip, *plain_strip, queries, embs, penalty)
    assert_candidates_close(*out, *plain_out, queries, embs, penalty)
    if n == 212:
        assert ((out[1] >= 0).sum(1) == 4).all()
    # no atomics: the same inputs give the same bits
    strip2 = seg_candidates(queries, embs, **kw)
    out2 = fused_candidates_topk(queries, embs, k, **kw)
    for a, b in zip(strip + out, strip2 + out2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,block_n,seg,per_seg", [
    (20_000, 2048, 128, 2),
    (300_000, 2048, 128, 2),    # a strip 4,704 wide
    (300_000, 1024, 64, 1),     # 4,688 wide
])
def test_fused_candidates_kernel_keeps_the_tie_order(dev, n, block_n, seg,
                                                     per_seg):
    """Rows of eighths under a constant query: every sum is exact in any
    order, the top 60 hold a few distinct scores, and the kernel's strip
    and output equal the twin's bit for bit (first lane in a segment, the
    lowest strip position in phase 2)."""
    from rag_dpo_tpu_torch.ops.topk import (
        fused_candidates_topk,
        fused_candidates_topk_plain,
        seg_candidates,
        seg_candidates_plain,
    )

    rng = np.random.default_rng(n + seg)
    rows = (rng.integers(-8, 9, (n, 16)) / 8).astype(np.float32)
    for blk in (9, 3):  # equal best rows two to a segment
        rows[blk * block_n + np.array([5, 6, 130, 131, 260, 261])] = 1.0
    embs = torch.from_numpy(rows).to(dev)
    queries = torch.full((3, 16), 0.5, device=dev)
    queries[1] = -0.25
    penalty = torch.zeros(n, device=dev)
    penalty[::7] = -1e4
    kw = dict(penalty=penalty, block_n=block_n, seg=seg, per_seg=per_seg)
    for fn, plain in ((seg_candidates, seg_candidates_plain),
                      (lambda *a, **k: fused_candidates_topk(*a, 60, **k),
                       lambda *a, **k: fused_candidates_topk_plain(*a, 60,
                                                                   **k))):
        got, want = fn(queries, embs, **kw), plain(queries, embs, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_candidates_kernel_rejects_what_it_does_not_take(dev):
    from rag_dpo_tpu_torch.ops.topk import fused_candidates_topk

    q = torch.zeros((2, 64), device=dev)
    e = torch.zeros((300, 64), device=dev)
    for bad_q, bad_e, kw in ((q, e, {"seg": 0, "block_n": 96}),
                             (q, e, {"seg": 64, "block_n": 1000}),  # divides
                             (q, e, {"per_seg": 0}),
                             (q, e, {"seg": 32, "per_seg": 33,
                                     "block_n": 256}),
                             (q, e, {"tile_q": 0}),
                             (q[:, :60], e, {}),                     # D
                             (q.bfloat16(), e, {}),                  # dtypes
                             (q.double(), e.double(), {}),
                             (q.cpu(), e, {})):                      # devices
        with pytest.raises(ValueError):
            fused_candidates_topk(bad_q, bad_e, 10, **kw)
    # the card keeps running after a refused shape: all-equal rows come in
    # strip order (round 0 of segments 0, 1, 2, then round 1)
    s, i = fused_candidates_topk(q, e, 5)
    assert i[0].tolist() == [0, 128, 256, 1, 129] and (s == 0).all()


@pytest.mark.parametrize("dim,int8", [(1536, False), (1000, False),
                                      (1536, True)])
def test_store_past_former_limits_on_the_card_matches_the_cpu(dev, dim,
                                                              int8):
    """ROADMAP C-17 at the store: dim 1536 and 1000 (zero columns padded
    into the image), search_dense at k 512 and search_sparse with 100
    terms go through K4 (bf16; the int8 arm's product is torch._int_mm)
    and K3 on the card, no twin, and agree with the CPU store (bf16: scores
    within 1e-5 and ids but near-ties; int8 and ELL: ids and scores
    exact)."""
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig

    rng = np.random.default_rng(dim)
    n = 20_000
    dense = rng.standard_normal((n, dim)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    terms = rng.integers(0, 300, (n, 8)).astype(np.int32)
    imps = np.abs(rng.standard_normal((n, 8))).astype(np.float32)
    ids = [f"r{i}" for i in range(n)]
    q = rng.standard_normal((3, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = rng.choice(300, (1, 100), replace=False).astype(np.int32)
    qw = rng.uniform(0.2, 3.0, (1, 100)).astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        idx = DeviceIndex(IndexConfig(dim=dim, ell_width=8,
                                      quantize_int8=int8), device=device)
        idx.add(ids, dense, terms=terms, impacts=imps)
        before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
        out[str(device)] = (idx.search_dense(q, 512),
                            idx.search_sparse(qt, qw, 40))
    assert (_kernels.LAUNCHES["fused_topk"]
            == before[0]["fused_topk"] + (not int8))
    assert _kernels.LAUNCHES["pooled_max"] == before[0]["pooled_max"]
    assert _kernels.LAUNCHES["ell_topk"] == before[0]["ell_topk"] + 1
    assert _kernels.PLAIN_ON_CUDA == before[1]
    (cs, ci), (css, csi) = out["cpu"]
    (gs, gi), (gss, gsi) = out[str(dev)]
    np.testing.assert_array_equal(gsi, csi)
    np.testing.assert_array_equal(gss, css)
    if int8:  # integer products, the same f32 passes and host refine
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_array_equal(gs, cs)
        return
    assert np.abs(gs - cs).max() <= NEAR_TIE
    differ = gi != ci
    near = np.abs(np.diff(cs, axis=1)) <= NEAR_TIE
    near = np.pad(near, ((0, 0), (0, 1))) | np.pad(near, ((0, 0), (1, 0)))
    assert not (differ & ~near).any()


# K10 and K11: exact integer arithmetic in both kernels (every partial sum
# below 2^24 at D ≤ 1024, and in int32 past it), so the strips equal the
# twin's bit for bit.
def _uniform_int8(gen, dev, shape):
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("upcast", ["bf16", "int8"])
@pytest.mark.parametrize("q,n,d,block", [
    (64, 3 * 2048 + 100, 1024, 2048),    # the recipe's Q, D, block; a tail
    (64, 3 * 2048 + 100, 256, 2048),
    (1, 5000, 256, 256),
    (7, 4096 + 77, 1024, 128),
    (300, 8192 + 5, 1024, 2048),          # several query tiles
    (1, 4096, 1000, 2048),                # D padded to 1008
    (300, 2 * 2048, 1000, 256),
    (17, 2048, 48, 2048),                 # one chunk, short of 64 bytes
    (64, 100_000, 1024, 2048),
    (1, 2 * 2048 + 5, 1024, 2048),
    (17, 4096, 512, 256),
    (65, 2 * 2048, 1024, 2048),           # two query tiles, resident
    (256, 3 * 2048, 1024, 2048),
    (300, 2048 + 9, 1536, 2048),          # K10's queries streamed
])
def test_int8_block_max_kernels_match_plain(dev, upcast, q, n, d, block):
    from rag_dpo_tpu_torch.ops.int8_matmul import (
        UPCASTS,
        int8_block_max,
        int8_block_max_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(q + n + d)
    q_i8, e_i8 = (_uniform_int8(gen, dev, s) for s in ((q, d), (n, d)))
    name = UPCASTS[upcast]
    before = _kernels.LAUNCHES[name]
    got = int8_block_max(q_i8, e_i8, block=block, upcast=upcast)
    assert _kernels.LAUNCHES[name] == before + 1
    want = int8_block_max_plain(q_i8, e_i8, block=block, upcast=upcast)
    torch.cuda.synchronize()
    assert got.shape == (q, n // block * 128) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(int8_block_max(q_i8, e_i8, block=block,
                                      upcast=upcast), got)


def test_int8_block_max_bf16_equals_i8_at_the_extremes(dev):
    """−128 and 127 at D 1024: the sums reach 2^24, still exact in f32."""
    from rag_dpo_tpu_torch.ops.int8_matmul import int8_block_max

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    sign = (torch.rand((80, 1024), generator=gen, device=dev) < 0.5)
    vals = torch.where(sign, -128, 127).to(torch.int8)
    q_i8, e_i8 = vals[:16].clone(), vals.repeat(100, 1)[:4096 + 30]
    q_i8[0] = -128
    e_i8[0] = -128
    bf16 = int8_block_max(q_i8, e_i8, block=256, upcast="bf16")
    i8 = int8_block_max(q_i8, e_i8, block=256, upcast="int8")
    want = (q_i8.double() @ e_i8[:4096].double().T).view(16, 16, 2, 128)
    assert float(bf16[0, 0]) == 2.0 ** 24
    assert torch.equal(bf16, i8)
    assert torch.equal(i8, want.amax(2).reshape(16, 2048).float())


@pytest.mark.parametrize("q", [1, 8, 17, 64, 65, 128, 129, 256, 300])
@pytest.mark.parametrize("d", [16, 48, 1000, 1024, 1536, 8192])
def test_k11_matches_plain_at_every_width(dev, q, d):
    """K11 over N off the block at blocks of 128, 2048 and 4096 (in turn by
    D): every query width and tile count, resident and streamed queries,
    blocks shared by walkers (the strip's atomic max) and not; bit for bit,
    the same bits twice."""
    from rag_dpo_tpu_torch.ops.int8_matmul import (
        int8_block_max,
        int8_block_max_plain,
    )

    block = (128, 2048, 4096)[d % 3]
    gen = torch.Generator(device=dev)
    gen.manual_seed(q * 7 + d)
    q_i8 = _uniform_int8(gen, dev, (q, d))
    e_i8 = _uniform_int8(gen, dev, (3 * block + 77, d))
    before = _kernels.LAUNCHES["int8_block_max_i8"]
    got = int8_block_max(q_i8, e_i8, block=block, upcast="int8")
    assert _kernels.LAUNCHES["int8_block_max_i8"] == before + 1
    want = int8_block_max_plain(q_i8, e_i8, block=block, upcast="int8")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(int8_block_max(q_i8, e_i8, block=block,
                                      upcast="int8"), got)


@pytest.mark.parametrize("q,d", [(1, 8192), (64, 1024), (256, 1024),
                                 (300, 1536)])
def test_k11_at_the_extremes(dev, q, d):
    """±127 and −128 only: the largest sums K11 meets (past 2^24 at D >
    1024, exact in int32, the same f32 cast as the twin's)."""
    from rag_dpo_tpu_torch.ops.int8_matmul import (
        int8_block_max,
        int8_block_max_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(q + d)
    pick = torch.randint(0, 3, (q + 4096 + 50, d), generator=gen, device=dev)
    vals = torch.tensor([-128, -127, 127], dtype=torch.int8, device=dev)[pick]
    q_i8, e_i8 = vals[:q].clone(), vals[q:].clone()
    e_i8[5] = q_i8[0]                 # a product at its largest
    got = int8_block_max(q_i8, e_i8, block=2048, upcast="int8")
    want = int8_block_max_plain(q_i8, e_i8, block=2048, upcast="int8")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_i8_plans_match_the_kernels_shared_memory(dev):
    """ops/int8_matmul.py sizes K11's shared memory on the CPU; the library
    computes it again from the same plan (`i8_sweep_smem`)."""
    import ctypes

    from rag_dpo_tpu_torch.ops.int8_matmul import i8_plan

    lib = _kernels.load("int8_block_max_i8")
    lib.i8_sweep_smem.restype = ctypes.c_int
    lib.i8_sweep_smem.argtypes = [ctypes.c_int] * 4
    for q in (1, 8, 17, 64, 65, 128, 256, 300):
        for d in (16, 48, 1000, 1024, 1536, 3072, 8192):
            p = i8_plan(q, d)
            assert lib.i8_sweep_smem(p.nq, p.stages, int(p.resident),
                                     p.chunks) == p.smem, (q, d)


def test_int8_block_max_rejects_what_it_does_not_take(dev):
    from rag_dpo_tpu_torch.ops.int8_matmul import int8_block_max

    q = torch.zeros((2, 64), dtype=torch.int8, device=dev)
    e = torch.zeros((1000, 64), dtype=torch.int8, device=dev)
    for args, kw in (((q, e), {"block": 200}),             # block off 128
                     ((q.float(), e), {}),                 # int8 queries
                     ((q, e[:, :32]), {}),                 # D differs
                     ((q.cpu(), e), {})):                  # devices
        with pytest.raises(ValueError):
            int8_block_max(*args, upcast="int8", **{"block": 256, **kw})
    out = int8_block_max(q, e, block=256, upcast="bf16")
    assert out.shape == (2, 384) and (out == 0).all()


def test_quantize_rows_on_the_card_gives_the_cpus_bits(dev):
    """The int8 image and its scales, bit for bit on both devices (a scale
    divided by the scalar 127 on CUDA is a reciprocal multiply, one ulp
    off in some rows, which moved int8 values across rounding
    boundaries)."""
    from rag_dpo_tpu_torch.ops.quantize import quantize_rows

    rng = np.random.default_rng(11)
    x = rng.standard_normal((20_000, 1024)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cq, cs = quantize_rows(torch.from_numpy(x))
    gq, gs = quantize_rows(torch.from_numpy(x).to(dev))
    assert torch.equal(gq.cpu(), cq)
    assert torch.equal(gs.cpu().view(torch.int32), cs.view(torch.int32))


def test_quantize_searches_on_the_card_match_the_cpu(dev):
    """The six int8 functions of `ops.quantize` on CUDA tensors (the int8
    product by `torch._int_mm`, Q 5 padded past 16 rows) against the same
    calls on the CPU: the same ids, scores within f32 rounding of the
    refine's sums; no kernel launches and no twin runs."""
    from rag_dpo_tpu_torch.ops import quantize as qz

    rng = np.random.default_rng(9)
    e = rng.standard_normal((3001, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pen = np.where(np.arange(3001) % 3 == 0, -1e4, 0.0).astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        e_t, q_t, p_t = (torch.from_numpy(x).to(device) for x in (e, q, pen))
        e_i8, e_s = qz.quantize_rows(e_t)
        q_i8, q_s = qz.quantize_rows(q_t)
        before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
        cs, ci = qz.int8_blockscan_candidates(q_i8, q_s, e_i8, e_s, 40, 512,
                                              penalty=p_t)
        out[str(device)] = [
            qz.approx_topk_int8(q_i8, q_s, e_i8, e_s, 10, penalty=p_t),
            qz.approx_topk_int8_refined(q_t, e_i8, e_s, e_t, 10, 8, p_t),
            qz.approx_topk_int8_selfrefined(q_t, e_i8, e_s, 10, 8, p_t),
            (cs, ci),
            qz.approx_topk_int8_blockscan(q_t, e_i8, e_s, 10, 8, 512, p_t),
            qz.approx_topk_int8_blockscan(q_t, e_i8, e_s, 10, 8, 512, p_t,
                                          e_ref=e_t),
            qz.dequant_refine(q_t, e_i8, e_s, cs, ci, 10),
        ]
        assert (dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)) \
            == before
    for (cs, ci), (gs, gi) in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(gi.cpu(), ci)
        assert float((gs.cpu() - cs).abs().max()) <= 1e-6


@pytest.mark.parametrize("sweep_block_rows", [0, 1024])
def test_device_refine_store_on_the_card_matches_the_cpu(dev,
                                                         sweep_block_rows):
    """`IndexConfig(device_refine=True)` on the card (selfrefined, and
    blockscan at 1024-row blocks) against the CPU store: the same ids, with
    and without a filter and after a delete; no kernel, no twin."""
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig

    rng = np.random.default_rng(10)
    n = 20_000
    dense = rng.standard_normal((n, 64)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    ids = [f"r{i}" for i in range(n)]
    metas = [{"nature": "GUIDE" if i % 2 else "DOCTRINE"} for i in range(n)]
    q = rng.standard_normal((64, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cfg = IndexConfig(dim=64, ell_width=4, quantize_int8=True,
                      device_refine=True, sweep_block_rows=sweep_block_rows)
    out = {}
    for device in ("cpu", dev):
        idx = DeviceIndex(cfg, device=device)
        idx.add(ids, dense, metas)
        idx.delete(ids[::97])
        before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
        out[str(device)] = (idx.search_dense(q, 10),
                            idx.search_dense(q[:3], 10,
                                             where={"nature": "DOCTRINE"}))
        assert (dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)) \
            == before
    for (cs, ci), (gs, gi) in zip(out["cpu"], out[str(dev)]):
        np.testing.assert_array_equal(gi, ci)
        assert np.abs(gs - cs).max() <= 1e-6


# tests/test_ingest_e2e.py's four pages (that module imports jax; a test of
# tests/test_torch_ingest.py holds this copy equal to them)
E2E_PAGES = {
    "https://site.test/fr/": """
      <html><head><title>Accueil</title></head><body>
      <div class="region-content">
      <p>Portail de la protection des données RGPD.</p>
      <a href="/fr/violation">Violations</a>
      <a href="/fr/aipd">AIPD</a>
      <a href="/fr/presse/com1">Presse</a>
      </div></body></html>""",
    "https://site.test/fr/violation": """
      <html><head><title>Notifier une violation</title></head><body>
      <div class="region-content">
      <h2>Notification à la CNIL</h2>
      <p>En cas de violation de données personnelles, le responsable de
      traitement notifie la CNIL dans les 72 heures conformément à
      l'article 33 du RGPD. Le registre des traitements doit être tenu à
      jour et le sous-traitant informe sans délai le responsable.</p>
      <h2>Communication aux personnes</h2>
      <p>Si la violation engendre un risque élevé pour les droits des
      personnes, la communication aux personnes concernées est requise par
      l'article 34. Le consentement ne couvre pas cette obligation de
      sécurité des données.</p>
      </div></body></html>""",
    "https://site.test/fr/aipd": """
      <html><head><title>Réaliser une AIPD</title></head><body>
      <div class="region-content">
      <h2>Champ d'application</h2>
      <p>L'analyse d'impact relative à la protection des données est
      obligatoire pour tout traitement susceptible d'engendrer un risque
      élevé. La CNIL publie la liste des traitements concernés et le
      registre mentionne chaque analyse conduite sur les données
      personnelles.</p>
      <h2>Étapes</h2>
      <p>Étape 1 : décrire le traitement de données. Étape 2 : évaluer la
      nécessité et la proportionnalité du traitement. Étape 3 : gérer les
      risques pour la sécurité des données personnelles.</p>
      </div></body></html>""",
    "https://site.test/fr/presse/com1": """
      <html><head><title>Communiqué</title></head><body>
      <div class="region-content"><p>Communiqué de presse.</p>
      </div></body></html>""",
}


def test_ingest_pipeline_on_the_card_matches_the_cpu(dev, tmp_path):
    """The four pages through the nine steps on the card and on the CPU,
    one tiny encoder's weights on both: the same reports but for seconds,
    the same index ids and BM25 arrays, dense rows within 1e-3; K1 (every
    encode) and K4 (the self-check's search) launch on the card, no twin."""
    from rag_dpo_tpu_torch.ingest.pipeline import (
        IngestPipeline,
        PipelineContext,
    )
    from rag_dpo_tpu_torch.ingest.scraper import (
        FetchResult,
        Scraper,
        ScraperConfig,
    )
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.models.convert import state_dict_to_flax
    from rag_dpo_tpu_torch.providers import (
        Embedder,
        EmbedderConfig,
        FakeLLMProvider,
    )
    from rag_dpo_tpu_torch.utils.paths import default_paths

    def fetch(url, if_modified_since="", **kw):
        html = E2E_PAGES.get(url)
        if html is None:
            return FetchResult(url=url, status=404)
        return FetchResult(url=url, status=200, content=html.encode(),
                           content_type="text/html",
                           last_modified="Mon, 01 Jan 2026 00:00:00 GMT")

    config = EmbedderConfig(model=BgeM3Config(
        encoder=EncoderConfig.tiny(), colbert_dim=32), batch_size=8)
    cpu = Embedder(config, device="cpu")
    params = {"params": state_dict_to_flax(cpu.load())}
    runs = {}
    for device in ("cpu", dev):
        paths = default_paths(tmp_path / str(device)).ensure()
        Scraper(paths.raw, ScraperConfig(scope_prefix="https://site.test/fr",
                                         delay_s=0.0),
                fetch=fetch).crawl(["https://site.test/fr/"])
        emb = cpu if device == "cpu" else Embedder(config, params=params,
                                                   device=device)
        ctx = PipelineContext(paths=paths, llm=FakeLLMProvider(),
                              embedder=emb)
        _kernels.reset_counts()
        reports = IngestPipeline(ctx).run()
        runs[str(device)] = (reports, ctx.index, dict(_kernels.LAUNCHES),
                             dict(_kernels.PLAIN_ON_CUDA))
    (creports, cindex, _, _), (greports, gindex, launches, plain) = \
        runs["cpu"], runs[str(dev)]

    def without_seconds(r):
        return {k: {f: v for f, v in s.items()
                    if f not in ("seconds", "build_seconds")}
                for k, s in r.items()}

    assert without_seconds(greports) == without_seconds(creports)
    assert greports["index"]["verification"]["self_retrieval_ok"]
    assert gindex.ids == cindex.ids and str(gindex.device).startswith("cuda")
    np.testing.assert_array_equal(gindex._terms, cindex._terms)
    np.testing.assert_array_equal(gindex._impacts, cindex._impacts)
    np.testing.assert_allclose(gindex._dense.astype(np.float32),
                               cindex._dense.astype(np.float32), atol=1e-3)
    assert launches["flash_fwd"] > 0 and launches["fused_topk"] > 0
    assert not any(plain.values()), plain


# ------------------------------------------------- the decoder (slice 16)
def _decoder_pair(dev, **kw):
    """One tiny decoder's seeded weights on the CPU and on the card."""
    from rag_dpo_tpu_torch.models.decoder import (
        DecoderConfig,
        build_decoder,
        init_random_,
    )

    cfg = DecoderConfig.tiny(num_heads=4, num_kv_heads=2, **kw)
    cpu = init_random_(build_decoder(cfg, "cpu"),
                       torch.Generator().manual_seed(0))
    card = build_decoder(cfg, dev)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


# f32 logits of magnitude ~4: the card's GEMMs sum in another order
# (TF32 off); bf16: three bf16 ulps at that magnitude
DECODER_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.1}


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float32),
    dict(dtype=torch.float32, quantize_kv=True),
    dict(),
    dict(quantize_weights=True, tie_embeddings=True),
    dict(quantize_weights=True, tie_embeddings=True, quantize_kv=True),
])
def test_decoder_on_the_card_matches_the_cpu(dev, kw):
    """Full forward, and a cached prefill + decode, on the card against the
    same weights on the CPU; the int8 kernels stay int8 on the card. An
    int8 K/V value may round the other way on the card: 0.05 more."""
    from rag_dpo_tpu_torch.models.decoder import DecoderModel, QuantDense

    cfg, cpu, card = _decoder_pair(dev, **kw)
    tol = DECODER_TOL[cfg.dtype] + (0.05 if cfg.quantize_kv else 0.0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        3, 512, (2, 12))).long()

    def cached(model, device):
        caches = DecoderModel.init_cache(cfg, 2, device=device)
        pos = torch.arange(12, device=device).expand(2, 12)
        x = ids.to(device)
        lg, caches = model(x[:, :8], pos[:, :8], caches, kv_len=8)
        steps = [lg]
        for t in range(8, 12):
            step, caches = model(x[:, t:t + 1], pos[:, t:t + 1], caches,
                                 kv_len=t + 1)
            steps.append(step)
        return torch.cat(steps, dim=1).float().cpu()

    with torch.no_grad():
        np.testing.assert_allclose(card(ids.to(dev)).float().cpu().numpy(),
                                   cpu(ids).float().numpy(), rtol=0,
                                   atol=DECODER_TOL[cfg.dtype])
        np.testing.assert_allclose(cached(card, dev).numpy(),
                                   cached(cpu, "cpu").numpy(), rtol=0,
                                   atol=tol)
    for m in card.modules():
        if isinstance(m, QuantDense):
            assert m.weight_q.dtype == torch.int8 and m.weight_q.is_cuda


@pytest.mark.parametrize("kw", [dict(dtype=torch.float32),
                                dict(quantize_weights=True,
                                     tie_embeddings=True),
                                dict(dtype=torch.float32, quantize_kv=True)])
def test_greedy_and_speculative_decode_on_the_card(dev, kw):
    """The cached greedy decode on the card is the argmax chain of its own
    full forwards (up to ties within the dtype's tolerance), and the
    speculative decode gives the same tokens bit for bit."""
    from rag_dpo_tpu_torch.models.generate import (
        SamplingConfig,
        TextGenerator,
    )
    from rag_dpo_tpu_torch.models.speculative import SpeculativeGenerator

    cfg, _, card = _decoder_pair(dev, **kw)
    gen = TextGenerator(cfg, device=dev)
    gen.model = card
    ids = np.random.default_rng(2).integers(3, 512, (3, 10)).astype(
        np.int32)
    lengths = np.asarray([10, 7, 4], np.int32)
    greedy = SamplingConfig(temperature=0.0, max_new_tokens=16, eos_id=-1)
    out = gen.generate_ids(ids, lengths, greedy)
    tol = DECODER_TOL[cfg.dtype]
    with torch.no_grad():
        for r in range(3):
            row = list(ids[r, :lengths[r]])
            for t in out[r]:
                lg = card(torch.tensor([row], device=dev))[0, -1].float()
                assert lg[int(t)] >= lg.max() - tol, (r, len(row))
                row.append(int(t))
    spec, stats = SpeculativeGenerator(gen, draft_len=4).generate_ids(
        ids, lengths, greedy)
    np.testing.assert_array_equal(spec, out)
    assert stats.tokens == 3 * 16
    sampled = SamplingConfig(temperature=0.9, max_new_tokens=12, eos_id=-1)
    want = gen.generate_ids(ids, lengths, sampled, rng_seed=3)
    got = np.concatenate(list(gen.generate_stream(ids, lengths, sampled,
                                                  rng_seed=3, chunk=5)), 1)
    np.testing.assert_array_equal(got, want)


def test_tpu_provider_defaults_to_the_card(dev):
    from rag_dpo_tpu_torch.providers.factory import create_llm

    llm = create_llm("tpu", arch="tiny", speculative=True)
    assert llm.generator.device.type == "cuda"
    r = llm.generate("Quel est le délai de notification ?", max_tokens=8)
    assert r.ok and r.text
    assert llm.generator.model.embed_tokens.weight.is_cuda
    _, scores = llm.choose("Intention :", ["oui", "non"])
    cpu = create_llm("tpu", arch="tiny", device="cpu")
    cpu.generator.load().load_state_dict(
        {k: v.cpu() for k, v in llm.generator.model.state_dict().items()})
    _, want = cpu.choose("Intention :", ["oui", "non"])
    # mean log-probs from bf16 logits (int8 weights, bf16 activations)
    np.testing.assert_allclose(scores, want, rtol=0, atol=0.25)


def test_batch_scheduler_on_the_card(dev):
    """The "batch" scheduler on the card: concurrent calls coalesce into
    one decode and answer as the direct scheduler does."""
    import threading

    from rag_dpo_tpu_torch.models.decoder import DecoderConfig
    from rag_dpo_tpu_torch.providers.tpu_llm import TPULLMProvider

    cfg = DecoderConfig.tiny(dtype=torch.float32)
    direct = TPULLMProvider(cfg, max_new_tokens=6, device=dev)
    batched = TPULLMProvider(cfg, max_new_tokens=6, batch_concurrent=True,
                             max_batch=4, max_wait_ms=2000.0, device=dev)
    batched.generator.load().load_state_dict(
        direct.generator.load().state_dict())
    prompts = [f"Délai numéro {i} ?" for i in range(4)]
    want = [direct.generate(p).text for p in prompts]
    got = [None] * 4
    gate = threading.Barrier(4)

    def run(i):
        gate.wait()
        got[i] = batched.generate(prompts[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [g.text for g in got] == want and all(g.ok for g in got)
    assert batched._batcher.stats.n_device_calls < 4
    batched._batcher.close()


def _pool_solo(gen, ids, max_new, temperature, seed):
    from rag_dpo_tpu_torch.models.generate import SamplingConfig

    out = gen.generate_ids(ids[None], np.asarray([len(ids)], np.int32),
                           SamplingConfig(temperature=temperature, eos_id=2,
                                          pad_id=1, max_new_tokens=max_new),
                           rng_seeds=[seed])[0]
    toks = []
    for t in out:
        if int(t) in (1, 2):
            break
        toks.append(int(t))
    return toks


@pytest.mark.parametrize("kw,host", [
    (dict(dtype=torch.float32), False),
    (dict(quantize_weights=True, tie_embeddings=True, quantize_kv=True),
     True),
])
def test_continuous_pool_on_the_card_matches_solo(dev, kw, host):
    """The slot pool on the card (speculation, chunked prefill, a prefix
    cache on the card or pinned in host memory, a preemption): each greedy
    or sampled request equals its solo run on the card, or first differs
    at a near-tie of that run's logits (ROADMAP C-29)."""
    from rag_dpo_tpu_torch.models.generate import (
        SamplingConfig,
        TextGenerator,
    )
    from rag_dpo_tpu_torch.serving import ContinuousEngine
    from rag_dpo_tpu_torch.serving.continuous import divergence_gap

    cfg, _, card = _decoder_pair(dev, **kw)
    gen = TextGenerator(cfg, device=dev)
    gen.model = card
    sampling = SamplingConfig(temperature=0.0, eos_id=2, pad_id=1)
    eng = ContinuousEngine(gen, slots=2, sampling=sampling, chunk=3,
                           speculative=True, draft_len=3, prefill_chunk=16,
                           prefix_cache=2, prefix_block=8,
                           prefix_cache_host=host, preemption=True)
    rng = np.random.default_rng(4)
    shared = rng.integers(4, 512, 16)
    reqs = []
    for i in range(6):
        ids = np.concatenate([shared, rng.integers(4, 512, 3 + 5 * i)])
        temp = 0.7 if i % 2 else 0.0
        if i == 5:                   # a priority-0 arrival preempts
            for _ in range(2):
                eng.step()
        reqs.append((eng.submit(ids, len(ids), 10, temperature=temp,
                                seed=i, priority=1 if i < 5 else 0),
                     ids, temp, i))
    eng.run()
    assert eng.stats["prefix_hits"] > 0 and eng.stats["preempted"] > 0
    for rid, ids, temp, seed in reqs:
        got = eng.result(rid).tokens
        want = _pool_solo(gen, ids, 10, temp, seed)
        assert divergence_gap(gen, ids, want, got, sampling, temp, seed) \
            <= DECODER_TOL[cfg.dtype], (rid, got, want)
    assert all(t.is_cuda for layer in eng._carry.caches
               for t in layer.values())
    for entry in eng._pentries.values():
        for layer in entry["kv_host" if host else "kv_dev"]:
            for t in layer.values():
                assert t.is_pinned() if host else t.is_cuda


def test_continuous_provider_defaults_to_the_card(dev):
    """`create_llm("tpu", scheduler="continuous")` builds its pool on the
    card and serves logprobs and `logit_bias` there."""
    from rag_dpo_tpu_torch.providers.factory import create_llm

    llm = create_llm("tpu", arch="tiny", scheduler="continuous",
                     max_batch=2, prefix_cache=2)
    try:
        engine = llm._driver.engine
        assert engine.device.type == "cuda" and engine._counts.is_cuda
        r = llm.generate("Quel est le délai de notification ?",
                         max_tokens=4, logprobs=2, logit_bias={5: 100.0})
        assert r.ok and [e["id"] for e in r.logprobs] == [5] * 4, r
        assert "".join(llm.generate_stream("Base légale ?", max_tokens=4))
    finally:
        llm._driver.close()


def _llava_pair(dev, vdt, **kw):
    """The tiny LLaVA on the card (seeded) and the same weights on the
    CPU."""
    from rag_dpo_tpu_torch.models.decoder import DecoderConfig
    from rag_dpo_tpu_torch.models.llava import LlavaConfig, LlavaGenerator
    from rag_dpo_tpu_torch.models.vit import ViTConfig

    cfg = LlavaConfig(vision=ViTConfig.tiny(dtype=vdt),
                      text=DecoderConfig.tiny(**kw))
    card = LlavaGenerator(cfg, rng_seed=3, device=dev)
    cpu = LlavaGenerator(cfg, device="cpu")
    cpu.generator.load().load_state_dict(card.generator.load().state_dict())
    for name, m in cpu.load().items():
        m.load_state_dict(card.load()[name].state_dict())
    return cfg, cpu, card


def _ulps(want, n):
    """n bf16 ulps of the largest value of `want`."""
    return n * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)


@pytest.mark.parametrize("vdt,kw", [
    (torch.float32, dict(dtype=torch.float32)),
    (torch.bfloat16, dict(quantize_weights=True, tie_embeddings=True)),
])
def test_tiny_llava_on_the_card_matches_the_cpu(dev, vdt, kw):
    """Projected patches (f32 and raw uint8 pixels) and the spliced prefix
    on the card against the same weights on the CPU: f32 within 1e-4 (the
    order of sums), bf16 within 8 bf16 ulps of the largest value (each GEMM
    rounds after summing in its own order); greedy tokens with an image
    within the decoder's tolerance of the full forward's maximum."""
    from rag_dpo_tpu_torch.models.generate import SamplingConfig
    from rag_dpo_tpu_torch.models.vit import (
        preprocess_image,
        preprocess_image_raw,
    )

    cfg, cpu, card = _llava_pair(dev, vdt, **kw)
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    f32 = preprocess_image(img, 28)[None]
    raw = preprocess_image_raw(img, 28)[None]
    pre, post = np.asarray([5, 6], np.int32), np.asarray([7, 8, 9], np.int32)
    want = cpu.encode_image(f32, fetch=False).float()
    e, n = card.compose(pre, post, img)
    ec, _ = cpu.compose(pre, post, img)
    assert e.is_cuda and e.dtype == cfg.text.dtype
    for got, ref in ((card.encode_image(f32, fetch=False), want),
                     (card.encode_image(raw, fetch=False), want),
                     (e, ec)):
        ref = ref.float()
        tol = 1e-4 if vdt == torch.float32 else _ulps(ref, 8)
        assert float((got.float().cpu() - ref).abs().max()) <= tol
    greedy = SamplingConfig(temperature=0.0, max_new_tokens=12, eos_id=-1,
                            pad_id=0)
    toks = torch.as_tensor(card.generate(pre, post, img, greedy)[0],
                           device=dev).long()
    model = card.generator.load()
    with torch.no_grad():
        seq = torch.cat([e[0, :n], model.embed_tokens(toks)])[None]
        logits = model(None, inputs_embeds=seq)[0, n - 1:-1].float()
    gap = logits.max(-1).values - logits.gather(1, toks[:, None])[:, 0]
    assert float(gap.max()) <= DECODER_TOL[cfg.text.dtype]


def test_vision_provider_pool_on_the_card(dev):
    """`attach_vision` on a continuous provider on the card: an image
    request beside a text one answers, streams, and hits the patch cache
    the second time."""
    import io

    from PIL import Image

    from rag_dpo_tpu_torch.models.vit import ViTConfig
    from rag_dpo_tpu_torch.providers.factory import create_llm

    llm = create_llm("tpu", arch="tiny", scheduler="continuous",
                     max_batch=2)
    try:
        lg = llm.attach_vision(ViTConfig.tiny())
        assert all(t.is_cuda for m in lg.load().values()
                   for t in m.state_dict().values())
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(2).integers(
            0, 256, (40, 40, 3), dtype=np.uint8)).save(buf, format="PNG")
        r = llm.generate_with_image("Décris cette image.", buf.getvalue(),
                                    max_tokens=6)
        assert r.ok and r.text, r.error
        text = llm.generate("Base légale ?", max_tokens=4)
        assert text.ok
        deltas = list(llm.generate_with_image_stream(
            "Décris cette image.", buf.getvalue(), max_tokens=6))
        assert "".join(deltas) == r.text
        assert lg.cache_stats["hits"] >= 1
    finally:
        llm._driver.close()


# ------------------------------------------- the mesh at world size 1
@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1, 1) mesh over NCCL: the card's process group of one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import torch.distributed as dist

    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh

    yield create_mesh(MeshSpec())
    dist.destroy_process_group()


def _mesh_corpus(n=3000, d=64, ell=8):
    rng = np.random.default_rng(6)
    dense = rng.standard_normal((n, d)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    terms = rng.integers(0, 90, (n, ell)).astype(np.int32)
    impacts = np.abs(rng.standard_normal((n, ell))).astype(np.float32)
    metas = [{"nature": ["A", "B", "C"][i % 3]} for i in range(n)]
    return dense, terms, impacts, metas


@pytest.mark.parametrize("kw", [dict(), dict(quantize_int8=True),
                                dict(quantize_int8=True, device_refine=True),
                                dict(postings_threshold=64)],
                         ids=["bf16", "int8", "int8-refine", "postings"])
def test_sharded_store_on_the_card_matches_the_cpu(dev, nccl_mesh, kw):
    """The row-sharded store at world size 1 (NCCL) on the card: the
    unsharded store's ids on the CPU, scores within 1e-5; K4 launches for
    the bf16 dense arm."""
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig

    dense, terms, impacts, metas = _mesh_corpus()
    ids = [f"c{i}" for i in range(len(dense))]
    cfg = IndexConfig(dim=64, ell_width=8, row_block=256, **kw)
    card = DeviceIndex(cfg, mesh=nccl_mesh)
    cpu = DeviceIndex(cfg, device="cpu")
    for idx in (card, cpu):
        idx.add(ids, dense, metas, terms, impacts)
        idx.delete(ids[5:9])
    assert card.device_image()["embs" if not kw.get("quantize_int8")
                               else "embs_i8"].is_cuda
    q = dense[[3, 700, 2999]]
    qt = np.random.default_rng(1).integers(0, 90, (3, 6)).astype(np.int32)
    qw = np.ones((3, 6), np.float32)
    before = _kernels.LAUNCHES["fused_topk"]
    for search in (lambda i: i.search_dense(q, 10),
                   lambda i: i.search_dense(q, 10, where={"nature": "B"}),
                   lambda i: i.search_sparse(qt, qw, 10)):
        (gs, gi), (cs, ci) = search(card), search(cpu)
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_allclose(gs, cs, atol=1e-5, rtol=0)
    if not kw.get("quantize_int8"):
        assert _kernels.LAUNCHES["fused_topk"] >= before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_on_the_card_matches_the_cpu_ring(dev, nccl_mesh, dtype):
    """4 logical shards by K1 + the lse merge on the card against JAX's
    online softmax on the CPU (a length-0 row: the mean of the values);
    the NCCL ring of one equals one K1 call."""
    from rag_dpo_tpu_torch.ops.flash_attention import flash_attention
    from rag_dpo_tpu_torch.ops.ring_attention import (
        make_ring_attention,
        ring_attention_blocks,
    )

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (3, 2, 512, 64)).astype(np.float32)).to(dtype) for _ in range(3))
    lens = torch.tensor([512, 300, 0])
    want = ring_attention_blocks(q, k, v, lens, 4).float()
    before = _kernels.LAUNCHES["flash_fwd"]
    got = ring_attention_blocks(q.to(dev), k.to(dev), v.to(dev),
                                lens.to(dev), 4).float().cpu()
    assert _kernels.LAUNCHES["flash_fwd"] == before + 16
    torch.testing.assert_close(got, want, atol=FWD_TOL[dtype], rtol=0)
    full = torch.tensor([512, 300, 17], device=dev)
    one = make_ring_attention(nccl_mesh)(q.to(dev), k.to(dev), v.to(dev),
                                         full)
    ref = flash_attention(q.to(dev), k.to(dev), v.to(dev), full)
    torch.testing.assert_close(one.float(), ref.float(),
                               atol=FWD_TOL[dtype], rtol=0)


def test_dp_embedder_and_tp_decoder_at_world_one(dev, nccl_mesh):
    """`Embedder(mesh=)` gives the plain embedder's vectors on the card
    within 1e-5; a TP decoder of one (`shard_params`) the unsharded
    greedy tokens."""
    from rag_dpo_tpu_torch.models.convert import state_dict_to_flax
    from rag_dpo_tpu_torch.models.decoder import (
        DecoderConfig,
        decoder_flax_tree,
    )
    from rag_dpo_tpu_torch.models.generate import (
        SamplingConfig,
        TextGenerator,
    )
    from rag_dpo_tpu_torch.models.sharding import shard_params
    from rag_dpo_tpu_torch.providers import Embedder

    plain = Embedder(device=dev)
    dp = Embedder(params=state_dict_to_flax(plain.load()), mesh=nccl_mesh)
    texts = [f"la donnée {i} du registre des traitements" for i in range(9)]
    np.testing.assert_allclose(dp.embed(texts)["dense"],
                               plain.embed(texts)["dense"], atol=1e-5)
    cfg = DecoderConfig.tiny(num_heads=4, num_kv_heads=2)
    gen = TextGenerator(cfg, device=dev)
    tp = TextGenerator(cfg, params=shard_params(
        decoder_flax_tree(gen.load()), nccl_mesh))
    ids = np.random.default_rng(2).integers(3, 512, (2, 9)).astype(np.int32)
    lens = np.asarray([9, 6], np.int32)
    s = SamplingConfig(temperature=0.0, max_new_tokens=8, eos_id=-1)
    np.testing.assert_array_equal(tp.generate_ids(ids, lens, s),
                                  gen.generate_ids(ids, lens, s))


def test_sharded_train_step_at_world_one(dev, nccl_mesh):
    """`make_sharded_train_step` on the NCCL mesh of one: two steps with
    hard negatives equal `make_train_step`'s on the card from the same
    seeded weights (losses rtol 1e-5; parameters within 1% of Σ lr, the
    key bias within Σ lr); K1, K8 and K9 launch, no twin runs."""
    from rag_dpo_tpu_torch.models import BgeM3Config
    from rag_dpo_tpu_torch.train import (
        TrainConfig,
        create_train_state,
        make_sharded_train_step,
        make_train_step,
    )
    from rag_dpo_tpu_torch.train.contrastive import learning_rate_at

    cfg = TrainConfig(model=BgeM3Config.tiny(), warmup_steps=1,
                      learning_rate=1e-3)
    rng = np.random.default_rng(8)
    batch = {}
    for name in ("query", "passage", "negative"):
        batch[f"{name}_ids"] = torch.from_numpy(
            rng.integers(4, 1024, (4, 40))).long()
        batch[f"{name}_lengths"] = torch.tensor([40, 23, 7, 31])
    batch["negative_valid"] = torch.tensor([True, True, False, True])
    plain = create_train_state(cfg, rng_seed=3, device=dev)
    step = make_train_step(cfg, plain)
    sh_step, sharded = make_sharded_train_step(
        cfg, nccl_mesh, create_train_state(cfg, rng_seed=3, device=dev))
    before = {n: _kernels.LAUNCHES[n] for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    twins = dict(_kernels.PLAIN_ON_CUDA)
    for _ in range(2):
        plain, want = step(plain, batch)
        sharded, got = sh_step(sharded, batch)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   rel=1e-5)
    assert all(_kernels.LAUNCHES[n] > c for n, c in before.items())
    assert dict(_kernels.PLAIN_ON_CUDA) == twins
    lr_sum = sum(learning_rate_at(cfg, c) for c in range(2))
    ref = plain.model.state_dict()
    for name, value in sharded.model.state_dict().items():
        atol = lr_sum if name.endswith("key.bias") else 0.01 * lr_sum
        torch.testing.assert_close(value, ref[name], atol=atol, rtol=1e-5)


def test_bf16_encoder_on_the_card_matches_the_cpu(dev):
    """`EncoderConfig.dtype=torch.bfloat16` on the card (bf16 K1 and
    GEMMs) against the bf16 model on the CPU, within 2e-2 (C-5)."""
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.models.bge_m3 import build_bge_m3

    cfg = BgeM3Config(encoder=EncoderConfig.tiny(dtype=torch.bfloat16),
                      colbert_dim=32)
    cpu = build_bge_m3(cfg, device="cpu").eval()
    card = build_bge_m3(cfg, device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        4, 1024, (3, 40))).long()
    lens = torch.tensor([40, 17, 5])
    before = _kernels.LAUNCHES["flash_fwd"]
    with torch.no_grad():
        want, got = cpu(ids, lens), card(ids.to(dev), lens.to(dev))
    assert _kernels.LAUNCHES["flash_fwd"] > before
    assert got.dense.dtype == torch.bfloat16
    for a, b in ((got.dense, want.dense), (got.sparse, want.sparse),
                 (got.colbert, want.colbert)):
        torch.testing.assert_close(a.float().cpu(), b.float(), atol=2e-2,
                                   rtol=0)
