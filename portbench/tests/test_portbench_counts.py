"""The operation and byte counts, counted once from shapes."""

import pytest

from portbench import peaks, spec, trace
from portbench.counts import attention, decoder, xlmr

NEMO = spec.load_config(spec.load_benchmark(), "mistral-nemo-12b-int8")


def test_decoder_counts_by_brute_force():
    m = dict(hidden_size=8, intermediate_size=12, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=2,
             vocab_size=10)
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 12
    assert decoder.layer_params(m) == per_layer
    n = 5
    attn = sum(4 * 2 * 4 * (i + 1) for i in range(n))   # QK and PV, causal
    assert decoder.prefill_flops(m, n) == \
        2 * (2 * n * per_layer + attn) + 2 * 10 * 8
    assert decoder.decode_flops(m, 6) == \
        2 * (2 * per_layer + 4 * 2 * 4 * 7) + 2 * 10 * 8


def test_nemo_sizes():
    # 40 layers of 272.6M projection weights, the head: 23.2 GFLOP a token
    assert decoder.layer_params(NEMO) == 272_629_760
    assert decoder.decode_flops(NEMO, 0) == 23_153_213_440


def test_k1_count_does_not_depend_on_the_implementation():
    lengths = [512, 300, 1, 40]
    # the padded width S and the kernel's tiles do not enter the count
    flops, nbytes = attention.k1_work(16, 64, lengths, 4)
    assert flops == 4 * 64 * 16 * sum(n * n for n in lengths)
    assert nbytes == 4 * 16 * 64 * sum(lengths) * 4 + 4 * len(lengths)
    f32 = attention.k1_bound_s(16, 64, lengths, 4)
    bf16 = attention.k1_bound_s(16, 64, lengths, 2)
    assert f32 == max(flops / peaks.TF32_FLOPS,
                      nbytes / peaks.HBM_BYTES_PER_S)
    assert bf16 < f32


def test_encoder_layer_flops():
    assert xlmr.layer_flops([3], 4, 8) == \
        2 * 3 * (4 * 16 + 2 * 4 * 8) + 4 * 9 * 4
    assert xlmr.layer_flops([3, 0], 4, 8) == xlmr.layer_flops([3], 4, 8)


def test_trace_summary_takes_the_union_of_device_intervals():
    kernels = [("a", 10, 10), ("b", 15, 10), ("a", 40, 5), ("c", 90, 30)]
    host = [("aten::mm", 0, 100), ("decode", 26, 39)]
    s = trace.summarize(kernels, host, 0, 100)
    assert s["busy_s"] == pytest.approx((15 + 5 + 10) / 1e9)
    assert s["window_s"] == pytest.approx(100 / 1e9)
    assert s["device_ops"][0][0] == "a"
    gaps = dict((round(v * 1e9), k) for k, v in s["idle_gaps"])
    assert gaps[45] == "aten::mm" and gaps[15] == "decode"


def test_attention_work_counts_the_window_and_fails_when_the_hook_is_lost():
    tr = {"start_ns": 100, "end_ns": 200,
          "kernels": [("flash_fwd_kernel<float, 64>", 120, 50),
                      ("gemm", 130, 10)]}
    calls = [(110, 16, 64, [30, 20], 4), (250, 16, 64, [30], 4)]
    bound, flops, device_s = attention.attention_work(calls, tr, 1024, 4096)
    assert bound == attention.k1_bound_s(16, 64, [30, 20], 4)
    assert flops == xlmr.layer_flops([30, 20], 1024, 4096)
    assert device_s == pytest.approx(50 / 1e9)
    with pytest.raises(RuntimeError, match="no attention call"):
        attention.attention_work(calls[1:], tr, 1024, 4096)
    quiet = dict(tr, kernels=[("gemm", 130, 10)])
    assert attention.attention_work([], quiet, 1024, 4096) == (0.0, 0.0, 0.0)
