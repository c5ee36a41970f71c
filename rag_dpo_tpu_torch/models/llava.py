"""LLaVA-class multimodal composition: ViT tower → MLP projector → the
resident decoder, in PyTorch.

Port of `rag_dpo_tpu/models/llava.py`. Every vision call the reference
makes — SCHEMA_DPO / INFOGRAPHIE / PHOTO_DECO image classification
(`classify_images.py:45-70`) and the infographic-PDF description fallback —
is a prompt + one image → text completion. Here it runs on the card: CLIP
patches (penultimate layer, CLS dropped) project through the two-layer
exact-GELU MLP into the decoder's embedding space, are spliced between the
prompt-token embeddings, and decode through the text path's own loop
(`TextGenerator.generate_with_embeds`) or the slot pool
(`ContinuousDriver.submit_embeds`).

The tower and the projector are plain PyTorch: XLA runs them without a
hand-written kernel (the attention is an f32 matmul, softmax and matmul).
Projected patches are cached on the card behind a digest-keyed LRU, so a
repeated image (ingest duplicates before dedup, multi-turn chat about one
picture) skips the tower.

Weights: `load_converted` takes `convert_llava_state_dict`'s output (HF
`LlavaForConditionalGeneration`), whose layout is the JAX package's Flax
trees, so either source loads through one path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..tokenize.base import bucket_length
from .convert import load_flax_params
from .decoder import DecoderConfig
from .generate import SamplingConfig, TextGenerator
from .vit import (
    Dense,
    ViTConfig,
    build_vit,
    init_vit_,
    normalize_uint8_pixels,
    preprocess_image_raw,
)


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    vision: ViTConfig
    text: DecoderConfig
    # -2 = penultimate ViT layer, no post-LN (LLaVA-1.5's choice)
    vision_feature_layer: int = -2
    drop_cls: bool = True

    @classmethod
    def tiny(cls, **kw) -> "LlavaConfig":
        return cls(vision=ViTConfig.tiny(), text=DecoderConfig.tiny(), **kw)

    @property
    def num_image_tokens(self) -> int:
        n = self.vision.num_patches
        return n if self.drop_cls else n + 1

    @property
    def output_layer(self) -> int:
        """The tower's `output_layer`: how many layers run (-2 → all but
        the last, no post-LN)."""
        f = self.vision_feature_layer
        return self.vision.num_layers + 1 + f if f < 0 else f


class LlavaProjector(nn.Module):
    """HF `multi_modal_projector`: linear → GELU (exact, in f32) → linear,
    the linears in `dtype` as `vit.Dense`."""

    def __init__(self, in_features: int, text_hidden: int,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = Dense(in_features, text_hidden, dtype, param_dtype)
        self.linear_2 = Dense(text_hidden, text_hidden, dtype, param_dtype)

    def forward(self, x):
        x = self.linear_1(x)
        x = F.gelu(x.float(), approximate="none").to(self.dtype)
        return self.linear_2(x)


class LlavaGenerator:
    """Drives image+text generation against a shared `TextGenerator` (the
    decoder may be the serving pool's own: vision traffic reuses its
    weights and decode path).

    `params`: {"vision": tree, "projector": tree} (Flax trees of numpy
    arrays, as `convert_llava_state_dict` or JAX's `load()` give them),
    another generator's `load()` (its modules, shared), or None for JAX's
    random init on the decoder's device: tower and projector each from
    `jax.random.key(0)`, whatever the seed, as JAX's `load()` makes them.
    `rng_seed` seeds the decoder a new `TextGenerator` draws (no
    `generator` given).
    `image_cache`: entries of the projected-patch LRU (0 = off)."""

    def __init__(self, config: LlavaConfig,
                 generator: TextGenerator | None = None,
                 params: dict | None = None, image_cache: int = 4,
                 rng_seed: int = 0, device=None):
        self.config = config
        self.generator = generator or TextGenerator(
            config.text, rng_seed=rng_seed, device=device)
        self.device = self.generator.device
        self._params = params
        self._load_lock = threading.Lock()
        # digest-keyed LRU of projected patches on the card: [n_img, H] in
        # the decoder's dtype, ~5.9 MB an image at 12B / CLIP-L
        self.image_cache = int(image_cache)
        self._patch_cache: OrderedDict = OrderedDict()
        self._patch_lock = threading.Lock()
        self.cache_stats = {"hits": 0, "misses": 0}

    def load(self) -> dict:
        """{"vision": ViTModel, "projector": LlavaProjector} on the device,
        built on the first call."""
        with self._load_lock:
            p = self._params
            if p is None or not isinstance(p.get("vision"), nn.Module):
                cfg, dev = self.config, self.device
                vision = build_vit(cfg.vision, dev)
                with torch.device(dev):
                    projector = LlavaProjector(
                        cfg.vision.hidden_size, cfg.text.hidden_size,
                        cfg.text.dtype, cfg.text.param_dtype)
                projector.requires_grad_(False).eval()
                if p is None:
                    # key 0 for both, whatever the seed, as JAX's
                    # LlavaGenerator.load initialises them
                    init_vit_(vision, 0)
                    init_vit_(projector, 0)
                else:
                    load_flax_params(vision, p["vision"])
                    load_flax_params(projector, p["projector"])
                self._params = {"vision": vision, "projector": projector}
            return self._params

    def load_converted(self, tree: dict) -> dict:
        """Output of `convert_llava_state_dict` (or the `vision/`,
        `projector/`, `decoder/` trees of its npz): installs vision and
        projector here and the decoder tree in the shared generator."""
        with self._load_lock:
            self._params = {"vision": tree["vision"],
                            "projector": tree["projector"]}
        self.generator.load_converted_tree(tree["decoder"])
        with self._patch_lock:
            self._patch_cache.clear()
        return self.load()

    @torch.no_grad()
    def _encode(self, pix):
        """[B, 3, S, S] f32 or [B, S, S, 3] uint8 pixels on the device →
        [B, n_img, text_hidden] projected patches in the decoder's dtype."""
        m = self.load()
        if pix.dtype == torch.uint8:
            pix = normalize_uint8_pixels(pix)
        feats = m["vision"](pix.float(),
                            output_layer=self.config.output_layer)
        if self.config.drop_cls:
            feats = feats[:, 1:]
        return m["projector"](feats)

    def encode_image(self, pixel_values, fetch: bool = True):
        """[B, 3, S, S] CLIP-normalized f32 pixels — or [B, S, S, 3] RAW
        uint8 (from `vit.preprocess_image_raw`), normalized on the card —
        → [B, n_image_tokens, text_hidden] projected patch embeddings: an
        f32 array on the host, or with `fetch=False` the tensor on the
        card."""
        arr = pixel_values if torch.is_tensor(pixel_values) \
            else np.array(pixel_values)
        u8 = arr.dtype in (np.uint8, torch.uint8)
        pix = torch.as_tensor(arr, device=self.device)
        if not u8:
            pix = pix.float()
        out = self._encode(pix)
        return out.float().cpu().numpy() if fetch else out

    def encode_patches(self, img_arr):
        """[3, S, S] CLIP-normalized pixels, or [S, S, 3] raw uint8 →
        [n_img, text_hidden] projected patches on the card, through the
        LRU keyed by a digest of the preprocessed pixel bytes, so every
        input form that renders the same pixels hits one entry."""
        arr = np.asarray(img_arr)
        u8 = arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[-1] == 3
        arr = np.ascontiguousarray(arr if u8 else np.asarray(arr, np.float32))
        if not arr.flags.writeable:     # torch takes no read-only buffers
            arr = arr.copy()
        digest = None
        if self.image_cache > 0:
            digest = hashlib.sha1(arr.tobytes()).hexdigest()
            with self._patch_lock:
                hit = self._patch_cache.get(digest)
                if hit is not None:
                    self._patch_cache.move_to_end(digest)
                    self.cache_stats["hits"] += 1
                    return hit
        patches = self._encode(torch.as_tensor(arr[None],
                                               device=self.device))[0]
        if digest is not None:
            with self._patch_lock:
                self.cache_stats["misses"] += 1
                self._patch_cache[digest] = patches
                while len(self._patch_cache) > self.image_cache:
                    self._patch_cache.popitem(last=False)
        return patches

    @torch.no_grad()
    def splice(self, patches, pre_ids, post_ids, s: int):
        """The multimodal prefix on the card: the pre-span's token rows,
        the `n_img` patch rows, the post-span's token rows, then zeros to
        `s` rows, all in the decoder's dtype → [1, s, H]."""
        table = self.generator.load().embed_tokens.weight
        dt = self.config.text.dtype
        dev = table.device
        rows = [table[torch.as_tensor(np.asarray(pre_ids, np.int64),
                                      device=dev)].to(dt),
                patches.to(dt),
                table[torch.as_tensor(np.asarray(post_ids, np.int64),
                                      device=dev)].to(dt)]
        n = sum(r.shape[0] for r in rows)
        rows.append(torch.zeros((s - n, table.shape[1]), dtype=dt,
                                device=dev))
        return torch.cat(rows)[None]

    def compose(self, pre_ids, post_ids, image):
        """Build the multimodal prefix on the card: one image spliced
        between two token spans (the "<s>USER: <image>\\nprompt
        ASSISTANT:" template split at the image) → (embeds [1, S, H] on
        the card, true length). Shared by the direct decode (`generate`)
        and the slot pool (`ContinuousDriver.submit_embeds`).

        `image`: PIL image / [H, W, 3] uint8 array / pre-processed
        [3, S, S] f32 CLIP-normalized array. PIL and raw uint8 inputs
        resize on the host (`preprocess_image_raw`) and normalize on the
        card."""
        cfg = self.config
        img = np.asarray(image) if not hasattr(image, "convert") else image
        if not (getattr(img, "ndim", 0) == 3 and img.shape[0] == 3
                and img.dtype != np.uint8):
            img = preprocess_image_raw(image, cfg.vision.image_size)
        pre_ids = np.asarray(pre_ids, np.int32).reshape(-1)
        post_ids = np.asarray(post_ids, np.int32).reshape(-1)
        # bucket_length CLAMPS to its last bucket: an overflowing span must
        # fail loudly here
        p = bucket_length(max(len(pre_ids), 1), buckets=(8, 32, 128))
        q = bucket_length(max(len(post_ids), 1))
        if len(pre_ids) > p or len(post_ids) > q:
            raise ValueError(
                f"vision prompt spans too long (pre {len(pre_ids)}, "
                f"post {len(post_ids)}; buckets {p}/{q})")
        n = len(pre_ids) + cfg.num_image_tokens + len(post_ids)
        patches = self.encode_patches(img)
        return self.splice(patches, pre_ids, post_ids, bucket_length(n)), n

    def generate(self, pre_ids, post_ids, image,
                 sampling: SamplingConfig | None = None,
                 rng_seed: int = 0) -> np.ndarray:
        """compose() + direct decode → generated ids [1, max_new].
        `rng_seed` is the ROW seed, as the pool takes a request's seed, so
        pool and direct decode draw the same stream."""
        embeds, n = self.compose(pre_ids, post_ids, image)
        return self.generator.generate_with_embeds(
            embeds, np.asarray([n], np.int32), sampling,
            rng_seeds=np.asarray([rng_seed], np.uint32))
