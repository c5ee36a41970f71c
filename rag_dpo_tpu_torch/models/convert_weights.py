"""Convert HF torch checkpoints into the npz both packages load.

    python -m rag_dpo_tpu_torch.models.convert_weights bge-m3   SNAPSHOT OUT.npz
    python -m rag_dpo_tpu_torch.models.convert_weights reranker SNAPSHOT OUT.npz
    python -m rag_dpo_tpu_torch.models.convert_weights decoder  SNAPSHOT OUT.npz \
        [--quantize-int8]
    python -m rag_dpo_tpu_torch.models.convert_weights llava    SNAPSHOT OUT.npz \
        [--quantize-int8]

Port of `scripts/convert_weights.py` with the same arguments and printouts.
Snapshot = a local HF model directory (config.json + *.safetensors or
pytorch_model*.bin, e.g. from `huggingface-cli download BAAI/bge-m3`, plus
FlagEmbedding's `sparse_linear.pt` / `colbert_linear.pt` heads; for
`decoder` a `LlamaForCausalLM` / `MistralForCausalLM` directory, for `llava`
a `LlavaForConditionalGeneration` one, in either key layout of
transformers). Output is a flat npz of the Flax param tree ('/'-joined
keys) that `load_params_npz` reads, array for array what the JAX script
writes (`--quantize-int8`: the decoder's projections as int8 `kernel_q` +
f32 `scale`; for `llava` the `decoder/` subtree's). `llava` writes the
`vision/`, `projector/` and `decoder/` trees that
`TPULLMProvider.attach_vision(params=...)` installs. This is a host job: it
touches no device, and needs neither jax nor transformers nor safetensors
(`*.safetensors` files are mapped by `load_safetensors`).

BF16 snapshots (Mistral-Nemo-12B is published in BF16) convert without
ml_dtypes: each tensor is widened to f32 exactly where it is consumed, and
`--quantize-int8` quantizes each widened kernel and drops it before the
next, so the host holds the int8 output, one f32 kernel and the f32
embedding, never the widened model. The npz holds f32 wherever the JAX
script writes bf16 (its `|V2` entries, which `np.load` cannot turn into
numbers without ml_dtypes); its int8 kernels and scales are the JAX
script's bits.
"""

from __future__ import annotations

import argparse
import json
import mmap
import os
import pathlib
import struct
import sys

import numpy as np

from .convert import (
    BF16_BITS,
    convert_bge_m3_state_dict,
    convert_cross_encoder_state_dict,
    convert_llama_state_dict,
    convert_llava_state_dict,
    flatten_params,
    float32_leaf,
)

# the numpy dtype of each safetensors dtype, as `safetensors.numpy` names
# it, but BF16: numpy has no bfloat16 unless a package (ml_dtypes, which
# jax loads) registers one, so its tensors are read as their raw words
# (`BF16_BITS`) and widened to f32 exactly where the converter consumes
# them (`convert.float32_leaf`); the npz this writes holds f32 there
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "U64": "<u8", "I32": "<i4", "U32": "<u4",
    "I16": "<i2", "U16": "<u2", "I8": "i1", "U8": "u1",
    "BOOL": "?", "C64": "<c8", "BF16": BF16_BITS,
}


def load_safetensors(path) -> dict[str, np.ndarray]:
    """One `*.safetensors` file → {name: ndarray}, as
    `safetensors.numpy.load_file` gives it: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then
    the tensors' bytes. The file is mapped, not read: each tensor is a
    read-only view of the mapping, paged in when it is used. BF16 tensors
    come as `BF16_BITS` words; F8 ones are refused."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes past the file's "
                             "end")
        header = json.loads(f.read(n))
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype.startswith("F8"):
            raise TypeError(f"{path}: {name} is {dtype}; the converter "
                            "reads F64/F32/F16/BF16 floats, not 8-bit ones")
        np_dtype = np.dtype(_SAFETENSORS_DTYPES.get(dtype, dtype.lower()))
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize or 8 + n + end > size:
            raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}) "
                             f"for shape {shape} {dtype}")
        out[name] = np.frombuffer(mapped, np_dtype, count=count,
                                  offset=8 + n + begin).reshape(shape)
    return out


class _Widened:
    """A `BF16_BITS` leaf that `np.savez` widens to f32 only when it
    writes it, so the npz is written one f32 tensor at a time."""

    def __init__(self, bits):
        self.bits = bits

    def __array__(self, dtype=None, copy=None):
        return float32_leaf(self.bits)


def load_state_dict(snapshot: pathlib.Path) -> dict:
    """The snapshot's tensors as numpy arrays under their HF names
    (`scripts/convert_weights.py::load_state_dict`): every
    `*.safetensors`, else every `pytorch_model*.bin` (else `*.pt`), then
    the `sparse_linear.pt` / `colbert_linear.pt` sidecars as
    `sparse_linear.weight`, ... ."""
    import torch

    state: dict = {}
    safetensor_files = sorted(snapshot.glob("*.safetensors"))
    bin_files = sorted(snapshot.glob("pytorch_model*.bin")) or \
        sorted(snapshot.glob("*.pt"))
    if safetensor_files:
        for f in safetensor_files:
            state.update(load_safetensors(f))
    elif bin_files:
        for f in bin_files:
            part = torch.load(f, map_location="cpu", weights_only=True)
            state.update({k: v.numpy() for k, v in part.items()})
    else:
        raise FileNotFoundError(
            f"no *.safetensors or pytorch_model*.bin under {snapshot}")
    # BGE-M3 ships sparse/colbert heads as sidecar .pt files
    for head in ("sparse_linear", "colbert_linear"):
        side = snapshot / f"{head}.pt"
        if side.exists():
            part = torch.load(side, map_location="cpu", weights_only=True)
            state.update({f"{head}.{k.split('.')[-1]}": v.numpy()
                          for k, v in part.items()})
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind",
                    choices=["bge-m3", "reranker", "decoder", "llava"])
    ap.add_argument("snapshot", type=pathlib.Path)
    ap.add_argument("out", type=pathlib.Path)
    ap.add_argument("--quantize-int8", action="store_true",
                    help="decoder only: weight-only int8")
    args = ap.parse_args(argv)
    state = load_state_dict(args.snapshot)
    print(f"loaded {len(state)} tensors from {args.snapshot}")
    if args.kind == "bge-m3":
        params = convert_bge_m3_state_dict(state)
    elif args.kind == "reranker":
        params = convert_cross_encoder_state_dict(state)
    elif args.kind == "llava":
        if not any(k.endswith("multi_modal_projector.linear_1.weight")
                   for k in state):
            print(f"llava: {args.snapshot} holds no multi_modal_projector: "
                  "not a LlavaForConditionalGeneration snapshot",
                  file=sys.stderr)
            return 2
        params = convert_llava_state_dict(state)
        if args.quantize_int8:
            from .decoder import quantize_decoder_params

            params["decoder"] = quantize_decoder_params(params["decoder"])
    else:
        if not {"embed_tokens.weight", "model.embed_tokens.weight"} \
                & set(state):
            print(f"decoder: {args.snapshot} holds no embed_tokens.weight: "
                  "not a LlamaForCausalLM / MistralForCausalLM snapshot",
                  file=sys.stderr)
            return 2
        params = convert_llama_state_dict(state)
        if args.quantize_int8:
            from .decoder import quantize_decoder_params

            params = quantize_decoder_params(params)

    flat = flatten_params(params)
    np.savez(args.out, **{k: _Widened(v) if v.dtype == BF16_BITS else v
                          for k, v in flat.items()})
    total = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, "
          f"{total / 1e9:.2f}B params")
    cfg_file = args.snapshot / "config.json"
    if cfg_file.exists():
        cfg = json.loads(cfg_file.read_text())
        print("model config hints:", {
            k: cfg.get(k) for k in (
                "hidden_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads",
                "intermediate_size", "vocab_size", "rope_theta",
            ) if k in cfg
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
