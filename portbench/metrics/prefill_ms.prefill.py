"""Mean device time of a batch-1 prefill (Δ`prefill_device_ns` /
Δ`prefills` of the engine's counters over the window: CUDA event pairs
around each prefill), in ms."""

from portbench import spans


def read(obs):
    r = spans.engine_ratio(obs, "prefill_device_ns", "prefills")
    return None if r is None else r / 1e6
