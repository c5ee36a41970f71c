"""CLIP-class vision transformer (the LLaVA vision tower) in PyTorch.

Port of `rag_dpo_tpu/models/vit.py`: the tower whose patch features feed
the multimodal projector (`models/llava.py`) and then the resident decoder,
in place of the reference's Ollama LLaVA endpoint
(`classify_images.py:45-70`). Module and parameter names follow the Flax
scopes (`patch_kernel [3·P², H]`, `class_embedding`, `position_embedding`,
`pre_layernorm`, `layer_{i}.attention.q_proj`, `layer_{i}.fc1`, ...), so a
Flax tree, or `convert_clip_vision_state_dict`'s output, loads one to one
(`models.convert.load_flax_params`).

Numerics kept from the reference, in its order of casts:

* the stride-P patch conv is one [N_patches, 3·P²] × [3·P², H] product over
  each patch flattened channel-major (the converter flattens HF's conv
  [H, 3, P, P] the same way);
* Dense layers run in `config.dtype` (bf16 by default): the input and the
  f32 parameters cast to it, the product in it, then the bias added in it;
* LayerNorm statistics in f32 (Flax's fast variance), the result cast back;
* q, k and v cast to f32 for both attention products and the softmax: the
  attention is a plain f32 matmul, softmax and matmul over the 577 tokens,
  as XLA computes it without a hand-written kernel;
* `quick_gelu` in f32.

Each Dense keeps its weight and bias cast to `config.dtype` resident from
the first call (cast again only when the f32 parameter changes), which
gives the bits Flax's cast-per-call gives without the cast's traffic.

`preprocess_image` and `preprocess_image_raw` are the JAX module's numpy
functions, copied (PIL resizes bicubic where it imports; without it the
nearest-neighbour branch runs); `normalize_uint8_pixels` is the torch form
of its jnp one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .encoder import LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @classmethod
    def clip_vit_l_336(cls, **kw) -> "ViTConfig":
        """openai/clip-vit-large-patch14-336 — LLaVA-1.5's tower."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        defaults = dict(image_size=28, patch_size=7, hidden_size=32,
                        num_layers=2, num_heads=4, intermediate_size=64)
        defaults.update(kw)
        return cls(**defaults)


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def _as(x, dtype):
    return x if x.dtype == dtype else x.to(dtype)


class Dense(nn.Linear):
    """Flax `nn.Dense(use_bias=True, dtype, param_dtype)`: y = (x · W) + b,
    the input, W and b in `dtype`. The cast weight and bias stay resident
    and are made again only when the parameters change (their version
    counters move on a load or an in-place edit)."""

    def __init__(self, in_features: int, features: int, dtype,
                 param_dtype=torch.float32):
        super().__init__(in_features, features, bias=True,
                         dtype=param_dtype)
        self.dtype = dtype
        self._cast = None

    def cast_params(self):
        """(weight, bias) in `dtype`, cast once per parameter version."""
        w, b = self.weight, self.bias
        if w.dtype == self.dtype:
            return w, _as(b, self.dtype)
        key = (w._version, b._version, w.data_ptr(), b.data_ptr())
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, w.detach().to(self.dtype),
                          b.detach().to(self.dtype))
        return self._cast[1], self._cast[2]

    def forward(self, x):
        w, b = self.cast_params()
        return F.linear(_as(x, self.dtype), w) + b


class ViTAttention(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_size
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(h, h, cfg.dtype, cfg.param_dtype))

    def forward(self, x):
        cfg = self.config
        h, nh = cfg.hidden_size, cfg.num_heads
        dh = h // nh
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, nh, dh)
        k = self.k_proj(x).reshape(b, s, nh, dh)
        v = self.v_proj(x).reshape(b, s, nh, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", _as(q, torch.float32),
                              _as(k, torch.float32)) / (dh ** 0.5)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, _as(v, torch.float32))
        return self.out_proj(_as(ctx.reshape(b, s, h), cfg.dtype))


class ViTLayer(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_size
        self.layer_norm1 = LayerNorm(h, cfg.layer_norm_eps)
        self.attention = ViTAttention(cfg)
        self.layer_norm2 = LayerNorm(h, cfg.layer_norm_eps)
        self.fc1 = Dense(h, cfg.intermediate_size, cfg.dtype,
                         cfg.param_dtype)
        self.fc2 = Dense(cfg.intermediate_size, h, cfg.dtype,
                         cfg.param_dtype)

    def forward(self, x):
        dt = self.config.dtype
        x = x + self.attention(_as(self.layer_norm1(x), dt))
        y = self.fc1(_as(self.layer_norm2(x), dt))
        y = _as(quick_gelu(_as(y, torch.float32)), dt)
        return x + self.fc2(y)


class ViTModel(nn.Module):
    """pixel_values [B, 3, H, W] (HF channel-first layout, f32 already
    CLIP-normalized) → patch+CLS features [B, 1 + N, H] in `config.dtype`.

    `output_layer=None` runs all layers + the post layernorm (the CLIP
    embedding head's input). LLaVA reads the PENULTIMATE layer without
    post-LN: `output_layer = num_layers - 1`."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        h, p = cfg.hidden_size, cfg.patch_size
        pd = cfg.param_dtype
        self.patch_kernel = nn.Parameter(torch.empty(3 * p * p, h, dtype=pd))
        self.class_embedding = nn.Parameter(torch.empty(h, dtype=pd))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_patches + 1, h, dtype=pd))
        self.pre_layernorm = LayerNorm(h, cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ViTLayer(cfg))
        self.post_layernorm = LayerNorm(h, cfg.layer_norm_eps)
        self._cast = None

    def _embeddings(self):
        """(patch kernel, class and position embeddings) in `dtype`, cast
        once per parameter version."""
        dt = self.config.dtype
        ps = (self.patch_kernel, self.class_embedding,
              self.position_embedding)
        key = tuple((t._version, t.data_ptr()) for t in ps)
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, *(_as(t.detach(), dt) for t in ps))
        return self._cast[1:]

    def forward(self, pixel_values, output_layer: int | None = None):
        cfg = self.config
        dt = cfg.dtype
        b = pixel_values.shape[0]
        p, g = cfg.patch_size, cfg.grid
        kernel, cls, pos = self._embeddings()
        # stride-P conv == per-patch flatten (channel-major) + one product
        x = pixel_values.reshape(b, 3, g, p, g, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
        x = _as(x, dt) @ kernel
        x = torch.cat([cls.expand(b, 1, cfg.hidden_size), x], dim=1)
        x = x + pos[None]
        x = _as(self.pre_layernorm(x), dt)
        n = cfg.num_layers if output_layer is None else output_layer
        for i in range(n):
            x = getattr(self, f"layer_{i}")(x)
        if output_layer is None:
            x = _as(self.post_layernorm(x), dt)
        return x


def build_vit(cfg: ViTConfig, device) -> ViTModel:
    """The module with its parameters allocated on `device`, not yet
    filled: `init_vit_` or `models.convert.load_flax_params` fills them."""
    with torch.device(device):
        model = ViTModel(cfg)
    return model.requires_grad_(False).eval()


def init_vit_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init of a `ViTModel` or a module of `Dense` layers
    (the LLaVA projector) in place, on its device, as the JAX module's
    `init(jax.random.key(seed), ...)` makes it (`models.flax_init`): Dense
    kernels lecun_normal (a normal truncated at ±2σ), biases 0, the patch
    kernel and both embeddings normal(0.02) (the ViT scope's first three
    parameters), LayerNorm scales 1 and biases 0."""
    from .flax_init import init_module_

    return init_module_(model, seed)


# CLIP preprocessing constants (OPENAI_CLIP_MEAN/STD)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_image_raw(image, image_size: int):
    """PIL.Image (or [H, W, 3] uint8 array) → [S, S, 3] uint8, bicubic
    resize only — NO normalization. The companion of
    `LlavaGenerator.encode_image` on uint8 input, which normalizes on the
    device: uint8 HWC is 4x smaller to upload than normalized f32."""
    try:
        from PIL import Image
    except Exception:  # pragma: no cover - the card's machine may lack it
        Image = None
    if Image is not None and isinstance(image, np.ndarray) \
            and image.dtype == np.uint8 \
            and image.shape[:2] != (image_size, image_size):
        image = Image.fromarray(image)
    if Image is not None and not isinstance(image, np.ndarray):
        img = image.convert("RGB").resize(
            (image_size, image_size), Image.BICUBIC)
        return np.asarray(img, np.uint8)
    arr = np.asarray(image)
    if arr.shape[:2] != (image_size, image_size):
        ys = (np.arange(image_size) * arr.shape[0]
              // image_size).astype(int)
        xs = (np.arange(image_size) * arr.shape[1]
              // image_size).astype(int)
        arr = arr[ys][:, xs]
    if arr.dtype != np.uint8:
        arr = np.clip(np.asarray(arr, np.float32)
                      * (255.0 if arr.max() <= 1.5 else 1.0),
                      0, 255).astype(np.uint8)
    return arr


def normalize_uint8_pixels(pixels):
    """[B, S, S, 3] uint8 tensor → [B, 3, S, S] f32 CLIP-normalized, on
    the tensor's device (raw bytes upload; the scale, shift and transpose
    run there)."""
    x = pixels.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    return x.permute(0, 3, 1, 2)


def preprocess_image(image, image_size: int):
    """PIL.Image (or [H, W, 3] uint8 array) → [3, S, S] f32,
    CLIP-normalized, bicubic resize — matches HF CLIPImageProcessor
    with do_center_crop on a square resize (shortest-edge then crop
    degenerates to plain resize for our square target)."""
    try:
        from PIL import Image
    except Exception:  # pragma: no cover - the card's machine may lack it
        Image = None
    if Image is not None and isinstance(image, np.ndarray) \
            and image.dtype == np.uint8 \
            and image.shape[:2] != (image_size, image_size):
        # arrays resize through PIL too — bicubic, matching HF
        image = Image.fromarray(image)
    if Image is not None and not isinstance(image, np.ndarray):
        img = image.convert("RGB").resize(
            (image_size, image_size), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
    else:
        arr = np.asarray(image, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.shape[:2] != (image_size, image_size):
            # nearest-neighbor floor: PIL absent or non-uint8 input
            ys = (np.arange(image_size) * arr.shape[0]
                  // image_size).astype(int)
            xs = (np.arange(image_size) * arr.shape[1]
                  // image_size).astype(int)
            arr = arr[ys][:, xs]
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    arr = (arr - mean) / std
    return arr.transpose(2, 0, 1)
