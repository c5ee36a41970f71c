"""Model products the window's tokens needed (each prefill whose first
token arrived in it, each later token at its position; `counts/decoder.py`)
over the window, as a share of the card's bf16 peak."""

from portbench import peaks, readers


def read(obs):
    return readers.share(obs["model_flops"], peaks.BF16_FLOPS,
                         obs["window_s"])
