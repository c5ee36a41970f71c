"""K1's share of its roofline in the traced window: the least time the
card needs for the attention calls launched in it (`counts/attention.py`:
products at the TF32 rate for f32 inputs, bytes at HBM's) over the device
time of K1's kernels (`flash_fwd_kernel`) there."""

from portbench.counts.attention import attention_work


def read(obs):
    tr = obs.get("trace")
    if not tr:
        return None
    bound_s, _, device_s = attention_work(
        obs["attention_calls"], tr, obs["hidden"], obs["intermediate"])
    if not bound_s or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
