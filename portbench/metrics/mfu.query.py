"""Model products of the encoder layers that ran in the traced window (one
layer a K1 call, from its rows' lengths: `counts/xlmr.py`) over the
device's busy seconds there, as a share of the TF32 peak (f32 inputs)."""

from portbench import peaks, readers
from portbench.counts.attention import attention_work


def read(obs):
    tr = obs.get("trace")
    if not tr:
        return None
    _, flops, _ = attention_work(obs["attention_calls"], tr, obs["hidden"],
                                 obs["intermediate"])
    return readers.share(flops, peaks.TF32_FLOPS, tr["busy_s"])
