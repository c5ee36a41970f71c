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
from rag_dpo_tpu_torch.ops.sparse import ell_topk, ell_topk_plain

pytestmark = pytest.mark.cuda

# f32: the kernels sum in 64-row tiles (the forward's online softmax, the
# backward's tile loops) and the twins in one block, both with f32
# accumulators; bf16 rounds the outputs.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    if lens is not None and 0 in lens:
        z = lens.index(0)
        assert (out[z] == 0).all() and (lse[z] == -1e20).all()
    # the no-lse variant is the same kernel
    torch.testing.assert_close(flash_attention(q, k, v, lengths), out)


@pytest.mark.parametrize("b,h,s,dh,dtype,lens", [
    (16, 16, 192, 64, torch.float32, None),       # the training shape
    (64, 16, 512, 64, torch.float32, None),
    (8, 16, 300, 64, torch.float32, [300, 0, 1, 17, 64, 65, 299, 128]),
    (4, 16, 256, 64, torch.bfloat16, [256, 100, 0, 3]),
    (4, 8, 200, 16, torch.float32, [200, 0, 64, 199]),
    (4, 8, 130, 128, torch.float32, [130, 64, 0, 1]),
    (2, 2, 96, 32, torch.float32, [96, 33]),
    (1, 1, 1, 64, torch.float32, [1]),
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
    x = torch.zeros((1, 1, 8, 48), device=dev)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)


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
    assert torch.equal(ks, ps)


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
