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
from rag_dpo_tpu_torch.ops.sparse import ell_topk, ell_topk_plain

pytestmark = pytest.mark.cuda

# f32: the kernel's 64-key online softmax and the twin's single block sum
# in different orders, both with f32 accumulators; bf16 rounds the output.
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
