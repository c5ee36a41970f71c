"""ctypes bindings for the C++ ingestion runtime (native/ragdpo_native.cpp).

Port of `rag_dpo_tpu/native.py`, with its public names and C signatures:

* `tokenize_french_native(text)` — drop-in for
  `tokenize.french.tokenize_french_text`
* `build_ell_corpus_native(texts, …)` — drop-in for the Python
  tokenize + `build_bm25_stats` + `build_ell_corpus` pipeline, returning
  the same (Bm25Stats, terms, impacts).
* `invert_postings_native(terms, impacts, vocab_size, cap)` — the
  postings inversion of `ops.postings.PostingsIndex.build`.

The difference is where the library goes. g++ builds the repository's one
source with the JAX module's flags into `rag_dpo_tpu_torch/build/`, under a
name keyed by a hash of the source and the flags (an edited source builds
anew), through a temporary file that `os.replace` moves into place: no
process ever loads a half-written library. It never reads or writes
`native/ragdpo_native.so`, which the JAX module writes in place
(ROADMAP C-18).

Everything degrades to the pure-Python path when no C++ toolchain is
present (`is_available()` gates call sites). `CALLS` counts each entry
point's calls, so a run can show that it took the native path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

PKG_DIR = pathlib.Path(__file__).resolve().parent
SRC = PKG_DIR.parent / "native" / "ragdpo_native.cpp"
BUILD_DIR = PKG_DIR / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

CALLS = {"tokenize_french_native": 0, "invert_postings_native": 0,
         "build_ell_corpus_native": 0}
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def library_path(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return pathlib.Path(build_dir) / f"libragdpo_native_{digest}.so"


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile `native/ragdpo_native.cpp` into `build_dir` unless a library
    of the same hash is there; returns its path."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise OSError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's C signature on a loaded library."""
    lib.ell_create.restype = ctypes.c_void_p
    lib.ell_create.argtypes = [ctypes.c_int32, ctypes.c_float,
                               ctypes.c_float, ctypes.c_float]
    lib.ell_add_blob.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int64]
    lib.ell_finalize.argtypes = [ctypes.c_void_p]
    lib.ell_n_docs.restype = ctypes.c_int64
    lib.ell_n_docs.argtypes = [ctypes.c_void_p]
    lib.ell_vocab_size.restype = ctypes.c_int64
    lib.ell_vocab_size.argtypes = [ctypes.c_void_p]
    lib.ell_avgdl.restype = ctypes.c_double
    lib.ell_avgdl.argtypes = [ctypes.c_void_p]
    lib.ell_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.ell_fill_tf.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.ell_idf.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ell_df.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ell_vocab_blob_len.restype = ctypes.c_int64
    lib.ell_vocab_blob_len.argtypes = [ctypes.c_void_p]
    lib.ell_vocab_blob.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ell_free.argtypes = [ctypes.c_void_p]
    lib.tokenize_utf8.restype = ctypes.c_int64
    lib.tokenize_utf8.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_int64]
    lib.ell_invert.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            _lib = bind(ctypes.CDLL(str(build())))
        except (OSError, subprocess.SubprocessError) as e:
            # no toolchain / compile failure: the Python path serves
            _build_error = str(e)
        return _lib


def _count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def is_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def tokenize_french_native(text: str) -> list[str]:
    lib = _load()
    assert lib is not None, "native library unavailable"
    _count("tokenize_french_native")
    data = text.encode("utf-8")
    cap = max(4096, len(data) * 2)
    buf = ctypes.create_string_buffer(cap)
    n = lib.tokenize_utf8(data, len(data), buf, cap)
    if n < 0:
        cap = len(data) * 4 + 4096
        buf = ctypes.create_string_buffer(cap)
        n = lib.tokenize_utf8(data, len(data), buf, cap)
    out = buf.raw[:n].decode("utf-8")
    return [t for t in out.split("\n") if t]


def invert_postings_native(terms: np.ndarray, impacts: np.ndarray,
                           vocab_size: int, cap: int):
    """Dense posting-table inversion in C++ — drop-in for
    ops.postings.PostingsIndex.build's numpy path. → (docs [V, cap] i32,
    impacts [V, cap] f32)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    _count("invert_postings_native")
    terms = np.ascontiguousarray(terms, np.int32)
    impacts = np.ascontiguousarray(impacts, np.float32)
    n, l = terms.shape
    out_docs = np.empty((vocab_size, cap), np.int32)
    out_impacts = np.empty((vocab_size, cap), np.float32)
    lib.ell_invert(
        terms.ctypes.data_as(ctypes.c_void_p),
        impacts.ctypes.data_as(ctypes.c_void_p),
        n, l, vocab_size, cap,
        out_docs.ctypes.data_as(ctypes.c_void_p),
        out_impacts.ctypes.data_as(ctypes.c_void_p),
    )
    return out_docs, out_impacts


def build_ell_corpus_native(texts, ell_width: int = 32, k1: float = 1.5,
                            b: float = 0.75, epsilon: float = 0.25,
                            return_tf: bool = False):
    """→ (Bm25Stats, terms [N,L] i32, impacts [N,L] f32), matching the
    Python build path's outputs. With `return_tf`, returns
    (stats, terms, impacts, tf [N,L] i32, dl [N] i32) so impacts can be
    recomputed exactly on incremental appends."""
    from .retrieval.bm25 import Bm25Stats

    lib = _load()
    assert lib is not None, "native library unavailable"
    _count("build_ell_corpus_native")
    handle = lib.ell_create(ell_width, k1, b, epsilon)
    try:
        # '\x01' is the FFI document separator — a text containing that
        # byte would silently split into extra documents, so scrub it.
        blob = "\x01".join(
            t.replace("\x01", " ") for t in texts
        ).encode("utf-8")
        lib.ell_add_blob(handle, blob, len(blob))
        lib.ell_finalize(handle)

        n = lib.ell_n_docs(handle)
        v = lib.ell_vocab_size(handle)
        terms = np.empty((n, ell_width), np.int32)
        impacts = np.empty((n, ell_width), np.float32)
        lib.ell_fill(handle,
                     terms.ctypes.data_as(ctypes.c_void_p),
                     impacts.ctypes.data_as(ctypes.c_void_p))
        tf = dl = None
        if return_tf:
            tf = np.empty((n, ell_width), np.int32)
            dl = np.empty((n,), np.int32)
            terms2 = np.empty((n, ell_width), np.int32)
            lib.ell_fill_tf(handle,
                            terms2.ctypes.data_as(ctypes.c_void_p),
                            tf.ctypes.data_as(ctypes.c_void_p),
                            dl.ctypes.data_as(ctypes.c_void_p))
        idf = np.empty((v,), np.float32)
        df = np.empty((v,), np.int64)
        if v:
            lib.ell_idf(handle, idf.ctypes.data_as(ctypes.c_void_p))
            lib.ell_df(handle, df.ctypes.data_as(ctypes.c_void_p))
        blob_len = lib.ell_vocab_blob_len(handle)
        vb = ctypes.create_string_buffer(int(blob_len) + 1)
        lib.ell_vocab_blob(handle, vb)
        vocab_terms = vb.raw[:blob_len].decode("utf-8").split("\n")[:-1]
        vocab = {t: i for i, t in enumerate(vocab_terms)}
        avgdl = float(lib.ell_avgdl(handle))
        stats = Bm25Stats(vocab=vocab, idf=idf, avgdl=avgdl,
                          n_docs=int(n), k1=k1, b=b, epsilon=epsilon,
                          df=df, total_len=avgdl * int(n))
        if return_tf:
            return stats, terms, impacts, tf, dl
        return stats, terms, impacts
    finally:
        lib.ell_free(handle)
