"""K10 and K11 (`int8_block_max`) of the port against the JAX package's
Pallas kernel bodies, on the CPU.

The JAX side is `benchmarks/bench_pallas_int8_matmul.py`'s `kernel_bf16`
and `kernel_int8` under `pl.pallas_call` with the specs of its `make`
(`:62-76`) and `interpret=True`: `make` itself fixes the module's N, D, Q and
BLOCK and cannot run on a CPU. Importing the module sets JAX's persistent
compilation cache options (`:25-26`); the fixture restores them at once.

The port's wrapper takes its plain twin here (exact integer arithmetic);
the CUDA kernels are held to that twin on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`. Every product of int8
values is exact and every partial sum stays below 2^24 at D ≤ 1024, so both
JAX kernels, and the twin, must agree bit for bit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops.int8_matmul import (
    int8_block_max,
    int8_block_max_plain,
)

BENCH = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
         / "bench_pallas_int8_matmul.py")
CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    saved = {name: getattr(jax.config, name) for name in CACHE_OPTIONS}
    spec = importlib.util.spec_from_file_location("bench_int8_floor", BENCH)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
    return module


def jax_block_max(kernel, q_i8, e_i8, block):
    """The TPU kernel body under `make`'s grid and specs, interpreted."""
    (q, d), n = q_i8.shape, e_i8.shape[0]
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(n // block,),
        in_specs=[pl.BlockSpec((q, d), lambda j: (0, 0)),
                  pl.BlockSpec((block, d), lambda j: (j, 0))],
        out_specs=pl.BlockSpec((q, 128), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((q, (n // block) * 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(q_i8), jnp.asarray(e_i8)))


def uniform_int8(rng, shape):
    """The benchmark's recipe: uniform int8 in [−127, 127]."""
    return rng.integers(-127, 128, shape).astype(np.int8)


def port(q_i8, e_i8, block, upcast):
    return int8_block_max(torch.from_numpy(q_i8), torch.from_numpy(e_i8),
                          block=block, upcast=upcast).numpy()


@pytest.mark.parametrize("upcast", ["bf16", "int8"])
@pytest.mark.parametrize("q,d,block", [
    (64, 256, 2048),      # the recipe's Q and block, N off the block
    (64, 1024, 2048),     # the recipe's D
    (1, 256, 256),
    (7, 256, 128),        # one 128-row slice a block
    (7, 1024, 256),
])
def test_twin_matches_the_tpu_kernels_bit_for_bit(bench, upcast, q, d,
                                                  block):
    rng = np.random.default_rng(q * d + block)
    n = 3 * 2048 + 100                   # the last 100 rows: no whole block
    q_i8, e_i8 = uniform_int8(rng, (q, d)), uniform_int8(rng, (n, d))
    kernel = bench.kernel_bf16 if upcast == "bf16" else bench.kernel_int8
    want = jax_block_max(kernel, q_i8, e_i8, block)
    got = port(q_i8, e_i8, block, upcast)
    assert got.dtype == np.float32 and got.shape == (q, (n // block) * 128)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_tail_rows_are_not_read(bench):
    """Rows past the last whole block change nothing, on either side."""
    rng = np.random.default_rng(3)
    q_i8 = uniform_int8(rng, (8, 128))
    e_i8 = uniform_int8(rng, (2 * 256 + 200, 128))
    loud = e_i8.copy()
    loud[512:] = 127
    for kernel, upcast in ((bench.kernel_bf16, "bf16"),
                           (bench.kernel_int8, "int8")):
        base = port(q_i8, e_i8, 256, upcast)
        np.testing.assert_array_equal(port(q_i8, loud, 256, upcast), base)
        np.testing.assert_array_equal(
            jax_block_max(kernel, q_i8, loud, 256), base)


def test_extremes_give_the_same_bits_in_bf16_and_int8(bench):
    """−128 and 127 at D 1024: sums reach 2^24, still exact in f32, so K10's
    bf16 path and K11's int32 path agree bit for bit, as do JAX's."""
    rng = np.random.default_rng(4)
    q_i8 = rng.choice(np.array([-128, 127], np.int8), (16, 1024))
    e_i8 = rng.choice(np.array([-128, 127], np.int8), (2 * 256, 1024))
    q_i8[0] = -128                        # row 0 of block 0: (−128)² · 1024
    e_i8[0] = -128
    bf16 = port(q_i8, e_i8, 256, "bf16")
    i8 = port(q_i8, e_i8, 256, "int8")
    assert bf16[0, 0] == 2.0 ** 24
    np.testing.assert_array_equal(bf16.view(np.int32), i8.view(np.int32))
    for kernel in (bench.kernel_bf16, bench.kernel_int8):
        np.testing.assert_array_equal(
            jax_block_max(kernel, q_i8, e_i8, 256).view(np.int32),
            bf16.view(np.int32))


@pytest.mark.parametrize("block", [0, 100, 2000, -128])
def test_block_off_128_raises(block):
    q = torch.zeros((2, 32), dtype=torch.int8)
    e = torch.zeros((4096, 32), dtype=torch.int8)
    for fn in (int8_block_max, int8_block_max_plain):
        for upcast in ("bf16", "int8"):
            with pytest.raises(ValueError, match="multiple of 128"):
                fn(q, e, block=block, upcast=upcast)
    with pytest.raises(ValueError, match="upcast"):
        int8_block_max(q, e, block=128, upcast="f32")


def test_wrapper_takes_the_twin_on_cpu_tensors():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(uniform_int8(rng, (5, 48)))    # D off the 16
    e = torch.from_numpy(uniform_int8(rng, (700, 48)))
    before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    for upcast in ("bf16", "int8"):
        got = int8_block_max(q, e, block=256, upcast=upcast)
        want = (q.long() @ e[:512].long().T).reshape(5, 2, 2, 128).amax(2)
        assert torch.equal(got, want.reshape(5, 256).float())
    assert (dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)) == before
    # fewer rows than a block: an empty strip, nothing read
    empty = int8_block_max(q, e[:100], block=128, upcast="int8")
    assert empty.shape == (5, 0) and empty.dtype == torch.float32


# (Q, D) of every K10 case of tests/test_torch_cuda.py, chip_smoke.py and
# evals/bench_int8_matmul.py
K10_CUDA_SHAPES = [
    (64, 1024), (64, 256), (1, 256), (7, 1024), (300, 1024), (1, 1000),
    (300, 1000), (17, 48), (1, 1024), (17, 512), (65, 1024), (256, 1024),
    (300, 1536), (16, 1024), (2, 64),
]


@pytest.mark.parametrize("q,d", K10_CUDA_SHAPES)
def test_k10_plan_of_every_shape(q, d):
    """K10's query tile (16 queries up to Q 16, else 64) is widened once a
    block and stays in shared memory for the whole sweep; the ring takes
    what is left, at least two stages."""
    from rag_dpo_tpu_torch.ops import widen_product as wp

    p = wp.widen_plan(q, d, int8_queries=True)
    assert p.resident and p.nq == (16 if q <= 16 else 64)
    assert 2 <= p.stages <= wp.MAX_STAGES and p.smem <= wp.MAX_SMEM
    assert p.stages == wp.MAX_STAGES or wp.smem_bytes(
        p.nq, p.stages + 1, True, p.chunks) > wp.MAX_SMEM


# (Q, D) of every K11 case of tests/test_torch_cuda.py, chip_smoke.py and
# evals/bench_int8_matmul.py
K11_CUDA_SHAPES = [
    (q, d) for q in (1, 8, 17, 64, 65, 128, 129, 256, 300)
    for d in (16, 48, 1000, 1024, 1536, 8192)]


@pytest.mark.parametrize("q,d", K11_CUDA_SHAPES)
def test_k11_plan_of_every_shape(q, d):
    """K11's query tile: the narrowest wgmma width of 8, 16, 32, 64 or 128
    that holds Q (past 128, tiles of 128), resident in shared memory where
    it fits beside a ring of four stages, else streamed beside the rows;
    the ring as deep as what is left allows, 2 to 8 stages, within the
    block's shared memory."""
    from rag_dpo_tpu_torch.ops import int8_matmul as im

    p = im.i8_plan(q, d)
    assert p.nq == min(n for n in im.I8_WIDTHS if n >= min(q, 128))
    assert p.chunks == -(-(-(-d // 16) * 16) // 128)
    assert 2 <= p.stages <= 8 and p.smem <= 232_448
    deeper = im.i8_smem(p.nq, p.stages + 1, p.resident, p.chunks)
    assert p.stages == 8 or deeper > 232_448
    fits = im.i8_smem(p.nq, im.I8_MIN_RESIDENT_STAGES, True, p.chunks)
    assert p.resident == (fits <= 232_448)
    if p.resident:
        assert p.stages >= im.I8_MIN_RESIDENT_STAGES


def test_k11_plan_rejects_an_empty_shape():
    from rag_dpo_tpu_torch.ops.int8_matmul import i8_plan

    for q, d in ((0, 64), (4, 0)):
        with pytest.raises(ValueError):
            i8_plan(q, d)
