"""Flax's seeded initialisation in torch: the JAX package's random weights
from the same seed, on any device.

The counterpart of Flax's init machinery (`flax.core.scope` and
`jax.nn.initializers`), not of a file of the JAX package. `model.init(
jax.random.key(seed), ...)` draws each parameter from a key of its own:

* the key is `fold_in(key(seed), h)`, h the first four bytes (big-endian)
  of the SHA-1 of the parameter's scope path (its module names) followed by
  the scope's `params` counter (1 for the first parameter the scope makes,
  2 for the second, ...), ints as their minimal big-endian bytes
  (`flax_param_key`: Flax's `_fold_in_static`, `Scope.make_rng` and
  `Scope.push`, with `flax_fix_rng_separator` off, Flax's default);
* the bits are threefry-2x32 of each element's flat index in the Flax
  shape as (hi, lo) words, the two output words xor-ed (JAX's
  partitionable layout: `random_bits`);
* a uniform puts the top mantissa bits under the exponent of 1.0, a float
  in [1, 2), minus 1, scaled (`uniform`); `normal` is √2·erfinv(u) of u on
  [nextafter(−1, 0), 1), `truncated_normal` the same on [erf(−√2),
  erf(√2)), clipped to the open (−2, 2); `erfinv_f32` is Giles's
  single-precision polynomial, the one XLA computes.

Every step but the erfinv is exact: bits and uniforms equal JAX's bit for
bit on any device; the erfinv is within 2 ulp of XLA's (XLA's own f32
log1p and its fused multiply-adds round otherwise), a leaf within 4 (the
√2 and stddev products round once more each); an int8 kernel `round(
normal · 42)` is equal but where an ulp moves a rounding tie. The CPU and
the card run the same IEEE-rounded ops, the log1p and sqrt in f64, so
they agree but where an f64 log1p's last bit moves an f32 rounding.

`init_flax_tree_` draws each leaf of a Flax-named tree of torch views in
place, on the views' device, in chunks of rows (nothing passes through the
host); the view of a tensor-parallel slice draws its own block of the whole
tensor's counter space. `flax_views` makes that tree for the encoder family
(BGE-M3, the cross-encoder, the ViT tower, the LLaVA projector);
`models.decoder.decoder_flax_tree` makes the decoder's.

The bits of a draw on a CUDA tensor come from a Triton kernel
(`bits_triton`: threefry in uint32 registers, one pass that writes the
bits); on the CPU from the same arithmetic in int64 torch ops
(`bits_plain`), its twin. Everything after the bits is the same torch ops
on both devices.
"""

from __future__ import annotations

import hashlib
import math
import threading

import torch

from .generate import _fold_in, threefry2x32

_M32 = 0xFFFFFFFF
# elements one draw makes at once: bounds the temporaries of a large leaf
# (a few 64 MB f32 buffers) whatever its size
CHUNK = 1 << 24
# Flax's `params` counter of each drawn leaf: the order of `self.param` in
# its scope (Dense: kernel, bias; QuantDense: kernel_q, scale; Embed:
# embedding; ViTModel: patch_kernel, class_embedding, position_embedding)
COUNTERS = {"kernel": 1, "kernel_q": 1, "embedding": 1, "patch_kernel": 1,
            "class_embedding": 2, "position_embedding": 3}
# the stddev of a standard normal truncated to (−2, 2), lecun_normal's
# divisor
TRUNC_STD = 0.87962566103423978

# launches of the Triton draw, by the wrapper (`bits_triton`)
LAUNCHES = {"threefry_bits": 0}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        LAUNCHES["threefry_bits"] = 0


# ---------------------------------------------------------------- keys
def seed_key(seed: int) -> tuple[int, int]:
    """`jax.random.key(seed)` as its two uint32 words: (0, seed mod 2³²),
    as JAX makes it with 64-bit types off (its default)."""
    return 0, int(seed) & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)` of a key given as two words."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    k1, k2 = _fold_in(t(key[0]), t(key[1]), t(int(data) & _M32))
    return int(k1), int(k2)


def flax_param_key(seed: int, path, counter: int) -> tuple[int, int]:
    """The key Flax's `model.init(jax.random.key(seed), ...)` draws the
    parameter from: `path` its scope's module names (the root scope's is
    empty), `counter` the scope's `params` counter at its `self.param`."""
    m = hashlib.sha1()
    for x in (*path, counter):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            x = int(x)
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(seed_key(seed), int.from_bytes(m.digest()[:4], "big"))


# ---------------------------------------------------------------- bits
def _axes(shape, block=None, order=None):
    """The counter axes of a draw: one (start, stop, stride) per output
    axis, the output holding `block` (a slice per axis, step 1; all of it
    by default) of a tensor of `shape` in row-major order, its axes in
    `order` (a permutation of the shape's; the identity by default)."""
    strides = [math.prod(shape[a + 1:]) for a in range(len(shape))]
    block = block or [slice(0, n) for n in shape]
    order = range(len(shape)) if order is None else order
    return [(block[a].start, block[a].stop, strides[a]) for a in order]


def bits_plain(key, axes, device) -> torch.Tensor:
    """int32 [*sizes of axes]: the uint32 bits of the draw at each
    counter, as two's-complement int32; int64 torch ops, the twin of
    `bits_triton`."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for start, stop, stride in axes:
        idx = idx[..., None] + torch.arange(
            start, stop, dtype=torch.int64, device=device) * stride
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    b = b1 ^ b2
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)


def _schedule(key) -> list[int]:
    """Threefry-2x32's key injections for one key: the two initial adds,
    then (x1, x2) adds of each of the five groups of four rounds."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    out = [ks[0], ks[1]]
    for i in range(5):
        out += [ks[(i + 1) % 3], (ks[(i + 2) % 3] + i + 1) & _M32]
    return out


_TRITON = {}


def _triton_kernel():
    """The Triton draw, compiled at its first launch (nothing is imported
    at module import: the CPU has no triton). The jit body resolves `tl`
    among this module's globals, so the imports bind them there."""
    global triton, tl
    if "bits" in _TRITON:
        return _TRITON["bits"]
    import triton
    import triton.language as tl

    @triton.jit
    def threefry_bits(out_ptr, meta_ptr, n, BLOCK: tl.constexpr):
        # meta (int64): r0, row stride, c0, col stride, columns, then the
        # twelve key injections of `_schedule`
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        r0 = tl.load(meta_ptr)
        rs = tl.load(meta_ptr + 1)
        c0 = tl.load(meta_ptr + 2)
        cs = tl.load(meta_ptr + 3)
        cols = tl.load(meta_ptr + 4)
        r = offs // cols
        idx = (r0 + r) * rs + (c0 + offs - r * cols) * cs
        x1 = (idx >> 32).to(tl.uint32)
        x2 = idx.to(tl.uint32)
        x1 = x1 + tl.load(meta_ptr + 5).to(tl.uint32)
        x2 = x2 + tl.load(meta_ptr + 6).to(tl.uint32)
        for g in tl.static_range(5):
            # four rounds, rotations (13, 15, 26, 6) or (17, 29, 16, 24)
            if g % 2 == 0:
                x1 = x1 + x2
                x2 = ((x2 << 13) | (x2 >> 19)) ^ x1
                x1 = x1 + x2
                x2 = ((x2 << 15) | (x2 >> 17)) ^ x1
                x1 = x1 + x2
                x2 = ((x2 << 26) | (x2 >> 6)) ^ x1
                x1 = x1 + x2
                x2 = ((x2 << 6) | (x2 >> 26)) ^ x1
            else:
                x1 = x1 + x2
                x2 = ((x2 << 17) | (x2 >> 15)) ^ x1
                x1 = x1 + x2
                x2 = ((x2 << 29) | (x2 >> 3)) ^ x1
                x1 = x1 + x2
                x2 = ((x2 << 16) | (x2 >> 16)) ^ x1
                x1 = x1 + x2
                x2 = ((x2 << 24) | (x2 >> 8)) ^ x1
            x1 = x1 + tl.load(meta_ptr + 7 + 2 * g).to(tl.uint32)
            x2 = x2 + tl.load(meta_ptr + 8 + 2 * g).to(tl.uint32)
        tl.store(out_ptr + offs, (x1 ^ x2).to(tl.int32, bitcast=True),
                 mask=mask)

    _TRITON["bits"] = (triton, threefry_bits)
    return _TRITON["bits"]


def bits_triton(key, axes, device) -> torch.Tensor:
    """`bits_plain` by the Triton kernel on a CUDA device: one launch a
    call, of at most two counter axes."""
    sizes = [stop - start for start, stop, _ in axes]
    if len(axes) > 2:
        raise ValueError(f"the Triton draw takes ≤ 2 axes, not {len(axes)}")
    (r0, _, rs), (c0, _, cs) = [(0, 1, 0)] * (2 - len(axes)) + list(axes)
    cols = sizes[-1] if sizes else 1
    n = math.prod(sizes)
    out = torch.empty(sizes, dtype=torch.int32, device=device)
    if n:
        triton, kernel = _triton_kernel()
        meta = torch.tensor([r0, rs, c0, cs, cols, *_schedule(key)],
                            dtype=torch.int64).to(device)
        block = 1024
        kernel[(triton.cdiv(n, block),)](out, meta, n, BLOCK=block)
        with _count_lock:
            LAUNCHES["threefry_bits"] += 1
    return out


def _bits(key, axes, device) -> torch.Tensor:
    """The draw's bits on `device`: the Triton kernel on a CUDA device,
    its twin on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return bits_triton(key, axes, device)
    if device.type != "cpu":
        raise ValueError(f"no draw on {device}")
    return bits_plain(key, axes, device)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) as int64 values in [0, 2³²),
    bit for bit; `key` two words (`seed_key`, `fold_in`)."""
    return _bits(key, _axes(tuple(shape)), device).to(torch.int64) & _M32


# ------------------------------------------------------- distributions
# per float dtype of a parameter: the bits JAX draws for it (8 where the
# mantissa is shorter than 8), its mantissa bits, the bits of 1.0, the
# integer view
_MANT = {torch.float32: (32, 23, 0x3F800000, torch.int32),
         torch.bfloat16: (8, 7, 0x3F80, torch.int16)}


def _ones_to_two(bits, dtype):
    """Floats in [1, 2) of `dtype` from int32 bits, as JAX's `_uniform`
    makes them: the draw's low `rng` bits (all 32 for f32), their top
    mantissa bits under the exponent of 1.0."""
    rng, mant, one, itype = _MANT[dtype]
    if rng < 32:
        bits = bits & ((1 << rng) - 1)
    m = ((bits >> (rng - mant)) & ((1 << mant) - 1)) | one
    return m.to(itype).view(dtype)


def _in(x: float, dtype) -> float:
    """`x` rounded to `dtype`, as a Python float: a scalar operand that
    torch applies in `dtype` exactly as JAX's array of that dtype."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _uniform(bits, minval, maxval, dtype):
    """u = max(lo, (f − 1)·(hi − lo) + lo) of the [1, 2) floats f, as XLA
    computes it on the CPU: for f32 the product and sum one fused
    multiply-add, here in f64, where both are exact (f − 1 and the span
    have 24 significant bits, their product 48, and the sum stays on the
    product's 2⁻⁴⁶ grid below 2), then rounded once; 16-bit floats round
    after each op."""
    lo, hi = _in(minval, dtype), _in(maxval, dtype)
    span = float(torch.tensor(hi, dtype=dtype) - torch.tensor(lo, dtype=dtype))
    f = _ones_to_two(bits, dtype) - 1.0
    if dtype == torch.float32:
        u = (f.double() * span + lo).float()
    else:
        u = f * span + lo
    return torch.clamp_min(u, lo)


def uniform(key, shape, minval=0.0, maxval=1.0, dtype=torch.float32,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`, bit for
    bit."""
    return _uniform(_bits(key, _axes(tuple(shape)), device), minval,
                    maxval, dtype)


# Giles, "Approximating the erfinv function" (2010): single precision,
# the coefficients XLA's ErfInv uses, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _horner(coeffs, w):
    c = [_in(v, torch.float32) for v in coeffs]
    p = torch.full_like(w, c[0])
    for v in c[1:]:
        p = p * w + v
    return p


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erf⁻¹ of f32 `x` in (−1, 1), as XLA computes it: w = −log1p(−x²),
    then Giles's degree-8 polynomial in w − 2.5 (w < 5) or √w − 3, times
    x; ±1 give ±inf. Other float dtypes go through f32 and back. The
    log1p and the sqrt run in f64 and round once to f32: the card's f32
    log1p and sqrt are not the CPU's (an ulp apart), their f64 ones round
    to the same f32 (the sqrt correctly rounded, as XLA's); every other op
    is one IEEE f32 rounding on both."""
    dtype = x.dtype
    x = x.float()
    w = -torch.log1p((-(x * x)).double()).float()
    small = w < 5.0
    p = torch.where(small, _horner(_ERFINV_LT5, w - 2.5),
                    _horner(_ERFINV_GE5, torch.sqrt(w.double()).float()
                            - 3.0))
    out = torch.where(x.abs() == 1.0, x * math.inf, p * x)
    return out.to(dtype)


def _nextafter(x: float, toward: float, dtype) -> float:
    """The float of `dtype` next to (nonzero) `x` in the direction of
    `toward`, by its bits."""
    itype = _MANT[dtype][3]
    b = int(torch.tensor(x, dtype=dtype).view(itype))
    b += 1 if (toward > x) == (x > 0) else -1   # bits of the magnitude
    return float(torch.tensor(b, dtype=itype).view(dtype))


def _normal(bits, dtype):
    lo = _nextafter(-1.0, 0.0, dtype)
    u = _uniform(bits, lo, 1.0, dtype)
    return _in(math.sqrt(2.0), dtype) * erfinv_f32(u)


def normal(key, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)`: √2·erfinv(u), u uniform on
    [nextafter(−1, 0), 1)."""
    return _normal(_bits(key, _axes(tuple(shape)), device), dtype)


def _erf_bounds(lower: float, upper: float, dtype):
    """(erf(lower/√2), erf(upper/√2)) in `dtype`, each quotient and erf
    rounded to it as JAX's ops round them (erf correctly rounded)."""
    def one(v):
        q = float(torch.tensor(_in(v, dtype), dtype=dtype)
                  / torch.tensor(_in(math.sqrt(2.0), dtype), dtype=dtype))
        return _in(math.erf(q), dtype)
    return one(lower), one(upper)


def _truncated_normal(bits, lower, upper, dtype):
    a, b = _erf_bounds(lower, upper, dtype)
    u = _uniform(bits, a, b, dtype)
    out = _in(math.sqrt(2.0), dtype) * erfinv_f32(u)
    lo = _nextafter(lower, math.inf, dtype)
    hi = _nextafter(upper, -math.inf, dtype)
    return torch.clamp(out, lo, hi)


def truncated_normal(key, lower, upper, shape, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape, dtype)`."""
    return _truncated_normal(_bits(key, _axes(tuple(shape)), device),
                             lower, upper, dtype)


# -------------------------------------------------------- initialisers
def fan_in(shape, out_axis: int = -1) -> float:
    """`jax.nn.initializers._compute_fans`'s fan_in (in_axis −2), with its
    float arithmetic."""
    in_size, out_size = shape[-2], shape[out_axis]
    return in_size * (math.prod(shape) / in_size / out_size)


def variance_std(shape, dtype, out_axis: int = -1,
                 divisor: float | None = None) -> float:
    """variance_scaling(1, "fan_in")'s stddev in `dtype`, each op rounded
    to it as JAX's: √(1/fan_in), over `divisor` (lecun_normal's truncated
    stddev) where given."""
    var = torch.tensor(1.0 / fan_in(shape, out_axis), dtype=torch.float64)
    std = torch.sqrt(var.to(dtype))
    if divisor is not None:
        std = std / torch.tensor(divisor, dtype=torch.float64).to(dtype)
    return float(std)


def leaf_init(name: str, shape, dtype):
    """The draw of the leaf `name` of Flax shape `shape`: a function of
    the block's bits that gives its values in `dtype`."""
    if name == "kernel":
        std = variance_std(shape, dtype, divisor=TRUNC_STD)
        return lambda bits: _truncated_normal(bits, -2.0, 2.0, dtype) * std
    if name == "embedding":     # Flax's default_embed_init: out_axis 0
        std = variance_std(shape, dtype, out_axis=0)
        return lambda bits: _normal(bits, dtype) * std
    if name in ("patch_kernel", "class_embedding", "position_embedding"):
        std = _in(0.02, dtype)
        return lambda bits: _normal(bits, dtype) * std
    if name == "kernel_q":
        # QuantDense: clip(round(normal · 42), ±127) as int8, drawn in f32
        return lambda bits: torch.clamp(torch.round(
            _normal(bits, torch.float32) * 42.0), -127, 127).to(torch.int8)
    raise KeyError(f"no random init for a leaf named {name!r}")


# --------------------------------------------------------------- walkers
def draw_(view: torch.Tensor, key, name: str, whole_shape=None,
          offsets=None) -> torch.Tensor:
    """Fill `view` (a tensor in the Flax layout, or a view of one) in place
    with the draw of leaf `name` from `key`: `view` holds the block at
    `offsets` of a tensor of `whole_shape` (all of it by default), and
    every element draws at its flat index in `whole_shape`. A view whose
    transpose is contiguous (a Linear's `weight.T`) is filled in the
    weight's own order. Chunks of rows bound the temporaries."""
    shape = tuple(view.shape)
    whole = tuple(whole_shape or shape)
    offsets = offsets or (0,) * len(shape)
    block = [slice(o, o + n) for o, n in zip(offsets, shape)]
    make = leaf_init(name, whole, view.dtype)
    order = list(range(len(shape)))
    dst = view
    if len(shape) == 2 and not view.is_contiguous() \
            and view.T.is_contiguous():
        dst, order = view.T, [1, 0]
    axes = _axes(whole, block, order)
    if not dst.numel():
        return view
    width = math.prod(dst.shape[1:])
    rows = max(1, CHUNK // max(width, 1))
    with torch.no_grad():
        for r in range(0, dst.shape[0], rows):
            r1 = min(r + rows, dst.shape[0])
            start, _, stride = axes[0]
            part = [(start + r, start + r1, stride)] + axes[1:]
            dst[r:r1].copy_(make(_bits(key, part, dst.device)))
    return view


def _block_of(path, view, tp):
    """(whole Flax shape, offsets) of a leaf view under tensor parallelism:
    the axis the sharding rules split is `tp.size` times longer, this
    rank's block at `tp.rank` of it."""
    shape = tuple(view.shape)
    if tp is None or tp.size == 1:
        return shape, (0,) * len(shape)
    from .sharding import param_spec
    from ..parallel.mesh import AXIS_MODEL

    spec = param_spec(tuple(path))
    whole, offs = list(shape), [0] * len(shape)
    for axis, name in enumerate(spec):
        if name == AXIS_MODEL:
            whole[axis] = shape[axis] * tp.size
            offs[axis] = shape[axis] * tp.rank
    return tuple(whole), tuple(offs)


def init_flax_tree_(tree: dict, seed: int, tp=None, path=()) -> dict:
    """Fill every leaf of a Flax-named tree of torch views in place as
    `model.init(jax.random.key(seed), ...)` makes it: Dense kernels
    lecun_normal (truncated) and biases 0, Embed tables normal with std
    √(1/features), ViT's patch kernel and embeddings normal(0.02),
    LayerNorm / RMSNorm scales 1, QuantDense kernels int8 and scales 0.01.
    `tp` (a `TensorParallel`): the views are this rank's slices, each
    drawn as its block of the whole tensor."""
    if set(tree) == {"params"} and not path:
        tree = tree["params"]
    for name, node in tree.items():
        if isinstance(node, dict):
            init_flax_tree_(node, seed, tp, path + (name,))
            continue
        with torch.no_grad():
            if name == "bias":
                node.zero_()
            elif name == "scale":
                node.fill_(0.01 if "kernel_q" in tree else 1.0)
            else:
                whole, offs = _block_of(path + (name,), node, tp)
                draw_(node, flax_param_key(seed, path, COUNTERS[name]),
                      name, whole, offs)
    return tree


def flax_views(module: torch.nn.Module) -> dict:
    """The Flax tree of an encoder-family module (the names
    `models.convert` maps) with torch views for leaves, in Flax's layout:
    a Linear's `kernel` is `weight.T`, LayerNorm `scale`/`bias`, an
    Embedding's `embedding`, a ViTModel's own three parameters."""
    from .encoder import LayerNorm
    from .vit import ViTModel

    tree: dict = {}
    for scope, sub in module.named_modules():
        if isinstance(sub, torch.nn.Linear):
            leaves = {"kernel": sub.weight.T, "bias": sub.bias}
        elif isinstance(sub, LayerNorm):
            leaves = {"scale": sub.weight, "bias": sub.bias}
        elif isinstance(sub, torch.nn.Embedding):
            leaves = {"embedding": sub.weight}
        elif isinstance(sub, ViTModel):
            leaves = {"patch_kernel": sub.patch_kernel,
                      "class_embedding": sub.class_embedding,
                      "position_embedding": sub.position_embedding}
        else:
            continue
        node = tree
        for part in scope.split(".") if scope else ():
            node = node.setdefault(part, {})
        node.update({k: v.detach() for k, v in leaves.items()})
    return tree


def module_tp(module: torch.nn.Module):
    """The `TensorParallel` a module's layers were built with, or None."""
    return next((m.tp for m in module.modules()
                 if getattr(m, "tp", None) is not None), None)


def init_module_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded Flax init of an encoder-family module in place, on its
    device (`flax_views`, `init_flax_tree_`), a TP module's slices as
    their blocks of the whole tensors."""
    init_flax_tree_(flax_views(module), seed, module_tp(module))
    return module
