"""HF checkpoints into the port without jax (slice 15).

Tiny random-init `transformers` snapshots (`XLMRobertaModel` with
FlagEmbedding's `sparse_linear.pt` / `colbert_linear.pt` sidecars, and
`XLMRobertaForSequenceClassification`, the RoBERTa two-layer head and a
bare `classifier.weight` head), saved as `*.safetensors` and as
`pytorch_model.bin`, at `tests/test_real_weights_rehearsal.py`'s widths:

* the port's converters are the JAX package's, source for source;
* `python -m rag_dpo_tpu_torch.models.convert_weights`, in a subprocess
  that refuses jax, flax, transformers, safetensors and `rag_dpo_tpu`,
  writes the npz `scripts/convert_weights.py` writes: the same keys,
  dtypes and bits, for the encoders and for tiny `MistralForCausalLM`
  (safetensors) and `LlamaForCausalLM` (.bin) snapshots as `decoder`,
  float and `--quantize-int8`, and for tiny `LlavaForConditionalGeneration`
  snapshots as `llava` in both of transformers' key layouts (the legacy one
  `save_pretrained` writes, as safetensors, and the flattened one of its
  `state_dict()` since 4.52, as .bin), float and `--quantize-int8`; `llava`
  and `decoder` on a snapshot that holds neither exit 2;
* its safetensors reader gives what `safetensors.numpy.load_file` gives;
  BF16 tensors come as raw words that numpy refuses to read as numbers
  until `convert.float32_leaf` widens them, to the bits the library gives
  where ml_dtypes is loaded (here), and in the refusing subprocess, where
  it is not; F8 tensors are refused;
* a tiny BF16 `MistralForCausalLM` snapshot converts as `decoder`, float
  and `--quantize-int8`, in that subprocess: the int8 kernels and scales
  are the JAX script's bits, every other tensor is f32 equal to the JAX
  script's bf16 widened (it writes them as `|V2` entries, which numpy
  cannot read as numbers: ROADMAP C-35); the quantizer never takes BF16
  words or an integer array as values;
* `Embedder.load_converted` (dense, sparse, ColBERT) and
  `CrossEncoderReranker.load_converted` score within 1e-5 of the JAX
  package's `load_converted`, and the port's encoder within 1e-5 of HF's
  `last_hidden_state`.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu.retrieval.reranker import (
    CrossEncoderReranker as JCrossEncoderReranker,
)
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.models.convert import (
    BF16_BITS,
    convert_xlmr_state_dict,
    float32_leaf,
    load_flax_params,
)
from rag_dpo_tpu_torch.models.convert_weights import (
    load_safetensors,
    load_state_dict,
)
from rag_dpo_tpu_torch.models.encoder import TransformerEncoder
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from rag_dpo_tpu_torch.retrieval.reranker import CrossEncoderReranker

transformers = pytest.importorskip("transformers")

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5
_XLMR_KW = dict(
    vocab_size=512, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=64,
    max_position_embeddings=130, type_vocab_size=1, pad_token_id=1,
    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    layer_norm_eps=1e-5, position_embedding_type="absolute",
)
_ENC_KW = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_position_embeddings=130,
               type_vocab_size=1, pad_token_id=1)
TEXTS = ["Le délégué à la protection des données conseille le "
         "responsable de traitement.",
         "Notifier une violation à la CNIL sous 72 heures.",
         "registre"]
PAIRS = [("délai de notification", TEXTS[1]),
         ("rôle du DPO", TEXTS[0]), ("registre", TEXTS[2])]
# the snapshots of the CLI cases: (kind, snapshot, sidecars)
CASES = [("bge-m3", "m3_safetensors", True), ("bge-m3", "m3_bin", True),
         ("bge-m3", "m3_safetensors_bare", False),
         ("bge-m3", "m3_bin_bare", False),
         ("reranker", "rr_safetensors", False), ("reranker", "rr_bin", False),
         ("reranker", "rr_bare_head", False)]
# the decoder CLI cases: (snapshot, extra arguments)
DECODER_CASES = [("mistral_safetensors", []),
                 ("mistral_safetensors", ["--quantize-int8"]),
                 ("llama_bin", []), ("llama_bin", ["--quantize-int8"])]
# the LLaVA CLI cases: (snapshot, extra arguments)
LLAVA_CASES = [("llava_safetensors", []),
               ("llava_safetensors", ["--quantize-int8"]),
               ("llava_bin_flat", [])]
# the BF16 decoder CLI cases: extra arguments
BF16_CASES = [[], ["--quantize-int8"]]
_LLAMA_KW = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 tie_word_embeddings=False)


# a few BF16 values: signs, a subnormal, the largest finite, infinity
BF16_VALUES = torch.tensor([[0.0, -1.5, 3.140625],
                            [1e-40, -3.3895e38, float("inf")]])


def _decoder_out(root, snap, extra, who):
    return root / f"{who}_{snap}{'_i8' if extra else ''}.npz"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights", REPO / "scripts" / "convert_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """The snapshots, by name, and the HF models they hold."""
    from transformers import (
        XLMRobertaConfig,
        XLMRobertaForSequenceClassification,
        XLMRobertaModel,
    )

    root = tmp_path_factory.mktemp("snapshots")
    torch.manual_seed(2)
    m3 = XLMRobertaModel(XLMRobertaConfig(**_XLMR_KW)).eval()
    torch.manual_seed(3)
    sparse = torch.nn.Linear(32, 1).eval()
    colbert = torch.nn.Linear(32, 16).eval()
    torch.manual_seed(4)
    rr = XLMRobertaForSequenceClassification(XLMRobertaConfig(
        num_labels=1, classifier_dropout=0.0, **_XLMR_KW)).eval()
    for name, model, safe, heads in (
            ("m3_safetensors", m3, True, True), ("m3_bin", m3, False, True),
            ("m3_safetensors_bare", m3, True, False),
            ("m3_bin_bare", m3, False, False),
            ("rr_safetensors", rr, True, False), ("rr_bin", rr, False, False)):
        model.save_pretrained(root / name, safe_serialization=safe)
        if heads:
            torch.save(sparse.state_dict(), root / name / "sparse_linear.pt")
            torch.save(colbert.state_dict(),
                       root / name / "colbert_linear.pt")
    # a bare scalar head on CLS: `classifier.weight` [1, H]
    torch.manual_seed(5)
    bare = {k: v for k, v in rr.state_dict().items()
            if not k.startswith("classifier.")}
    head = torch.nn.Linear(32, 1)
    bare["classifier.weight"] = head.weight.detach().clone()
    bare["classifier.bias"] = head.bias.detach().clone()
    (root / "rr_bare_head").mkdir()
    torch.save(bare, root / "rr_bare_head" / "pytorch_model.bin")
    (root / "empty").mkdir()
    from transformers import (
        LlamaConfig,
        LlamaForCausalLM,
        MistralConfig,
        MistralForCausalLM,
    )

    torch.manual_seed(6)
    MistralForCausalLM(MistralConfig(sliding_window=None, **_LLAMA_KW)
                       ).save_pretrained(root / "mistral_safetensors",
                                         safe_serialization=True)
    torch.manual_seed(7)
    LlamaForCausalLM(LlamaConfig(attention_bias=False, **_LLAMA_KW)
                     ).save_pretrained(root / "llama_bin",
                                       safe_serialization=False)
    from transformers import (
        CLIPVisionConfig,
        LlavaConfig,
        LlavaForConditionalGeneration,
    )

    torch.manual_seed(8)
    llava = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=CLIPVisionConfig(
            image_size=28, patch_size=7, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_act="quick_gelu"),
        text_config=LlamaConfig(attention_bias=False, **_LLAMA_KW),
        image_token_index=255, projector_hidden_act="gelu",
        vision_feature_layer=-2)).eval()
    # save_pretrained writes the legacy layout (language_model.model.*);
    # the model's own state_dict is the flattened one (model.*, lm_head)
    llava.save_pretrained(root / "llava_safetensors", safe_serialization=True)
    torch.manual_seed(9)
    MistralForCausalLM(MistralConfig(sliding_window=None, **_LLAMA_KW)
                       ).to(torch.bfloat16).save_pretrained(
        root / "mistral_bf16", safe_serialization=True)
    (root / "llava_bin_flat").mkdir()
    torch.save(llava.state_dict(), root / "llava_bin_flat" / "pytorch_model.bin")
    return dict(root=root, m3=m3, sparse=sparse, colbert=colbert, rr=rr,
                bare=bare)


_REFUSING_RUN = textwrap.dedent("""
    import importlib.abc, json, runpy, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "orbax", "transformers",
                                      "safetensors", "rag_dpo_tpu",
                                      "ml_dtypes"):
                raise ImportError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    cases, bf16 = sys.argv[1:]
    codes = []
    for argv in json.loads(cases):
        sys.argv = ["convert_weights", *argv]
        try:
            runpy.run_module("rag_dpo_tpu_torch.models.convert_weights",
                             run_name="__main__")
        except SystemExit as e:
            codes.append(e.code)
    from rag_dpo_tpu_torch.models.convert import float32_leaf
    from rag_dpo_tpu_torch.models.convert_weights import load_safetensors
    print("BF16\t" + json.dumps(
        float32_leaf(load_safetensors(bf16)["w"]).tolist()))
    bad = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "transformers", "safetensors", "rag_dpo_tpu",
        "ml_dtypes")]
    print("CODES\t" + json.dumps(codes) + "\t" + json.dumps(bad))
""")


@pytest.fixture(scope="module")
def port_cli(snaps):
    """Every CLI case through `python -m ...convert_weights` in one
    subprocess with jax and the HF packages refused, then `decoder` and
    `llava` on an encoder snapshot, then the decoder cases; → (exit codes,
    stdout, stderr)."""
    root = snaps["root"]
    argvs = [[kind, str(root / snap), str(root / f"port_{snap}.npz")]
             for kind, snap, _ in CASES]
    argvs += [[kind, str(root / "m3_bin"), str(root / f"{kind}.npz")]
              for kind in ("decoder", "llava")]
    argvs += [["decoder", str(root / snap),
               str(_decoder_out(root, snap, extra, "port")), *extra]
              for snap, extra in DECODER_CASES]
    argvs += [["llava", str(root / snap),
               str(_decoder_out(root, snap, extra, "port")), *extra]
              for snap, extra in LLAVA_CASES]
    argvs += [["decoder", str(root / "mistral_bf16"),
               str(_decoder_out(root, "mistral_bf16", extra, "port")),
               *extra] for extra in BF16_CASES]
    script = root / "refusing.py"
    script.write_text(_REFUSING_RUN)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    from safetensors.torch import save_file

    bf16 = root / "bf16.safetensors"
    save_file({"w": BF16_VALUES.to(torch.bfloat16)}, bf16)
    proc = subprocess.run([sys.executable, str(script), json.dumps(argvs),
                           str(bf16)],
                          capture_output=True, text=True, env=env,
                          cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("CODES"), proc.stdout[-2000:]
    _, codes, bad = line.split("\t")
    assert json.loads(bad) == []
    return json.loads(codes), proc.stdout, proc.stderr


@pytest.mark.parametrize("name", ["_set", "convert_xlmr_state_dict",
                                  "convert_bge_m3_state_dict",
                                  "convert_cross_encoder_state_dict",
                                  "convert_llama_state_dict",
                                  "convert_clip_vision_state_dict",
                                  "convert_llava_state_dict"])
def test_converters_are_the_jax_packages(name):
    def source(path):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        (fn,) = [n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == name]
        return ast.dump(fn)

    assert source(REPO / "rag_dpo_tpu_torch" / "models" / "convert.py") \
        == source(REPO / "rag_dpo_tpu" / "models" / "convert.py")


@pytest.mark.parametrize("kind,snap,sidecars", CASES)
def test_port_cli_writes_the_jax_scripts_npz(snaps, port_cli, monkeypatch,
                                             capsys, kind, snap, sidecars):
    root = snaps["root"]
    jax_out = root / f"jax_{snap}.npz"
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", kind,
                                      str(root / snap), str(jax_out)])
    assert _jax_script().main() == 0
    jax_print = capsys.readouterr().out
    codes, port_print, _ = port_cli
    assert codes[CASES.index((kind, snap, sidecars))] == 0
    # the same printouts but for the output's name
    for line in jax_print.splitlines():
        assert line.replace(f"jax_{snap}", f"port_{snap}") in port_print
    want = np.load(jax_out)
    got = np.load(root / f"port_{snap}.npz")
    assert sorted(got.files) == sorted(want.files)
    assert any(k.startswith("sparse_head/") for k in got.files) == sidecars
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_decoder_and_llava_exit_non_zero(port_cli):
    """`decoder` refuses a snapshot that holds no decoder, and `llava`
    one that holds no projector (the JAX script fails there on a
    KeyError); `llava` exited 2 for every snapshot until the vision model
    came."""
    codes, _, stderr = port_cli
    assert codes[len(CASES):len(CASES) + 2] == [2, 2]
    assert "holds no embed_tokens.weight" in stderr
    assert "holds no multi_modal_projector" in stderr


@pytest.mark.parametrize("snap,extra", LLAVA_CASES)
def test_port_cli_converts_llava_as_the_jax_script(snaps, port_cli,
                                                   monkeypatch, capsys,
                                                   snap, extra):
    root = snaps["root"]
    jax_out = _decoder_out(root, snap, extra, "jax")
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "llava",
                                      str(root / snap), str(jax_out),
                                      *extra])
    assert _jax_script().main() == 0
    jax_print = capsys.readouterr().out
    codes, port_print, _ = port_cli
    at = len(CASES) + 2 + len(DECODER_CASES) + LLAVA_CASES.index(
        (snap, extra))
    assert codes[at] == 0
    port_out = _decoder_out(root, snap, extra, "port")
    for line in jax_print.splitlines():
        assert line.replace(jax_out.name, port_out.name) in port_print
    want, got = np.load(jax_out), np.load(port_out)
    assert sorted(got.files) == sorted(want.files)
    assert {k.split("/")[0] for k in got.files} \
        == {"vision", "projector", "decoder"}
    assert any(k.endswith("kernel_q") for k in got.files) == bool(extra)
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("snap,extra", DECODER_CASES)
def test_port_cli_converts_decoders_as_the_jax_script(snaps, port_cli,
                                                      monkeypatch, capsys,
                                                      snap, extra):
    root = snaps["root"]
    jax_out = _decoder_out(root, snap, extra, "jax")
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "decoder",
                                      str(root / snap), str(jax_out),
                                      *extra])
    assert _jax_script().main() == 0
    jax_print = capsys.readouterr().out
    codes, port_print, _ = port_cli
    assert codes[len(CASES) + 2 + DECODER_CASES.index((snap, extra))] == 0
    port_out = _decoder_out(root, snap, extra, "port")
    for line in jax_print.splitlines():
        assert line.replace(str(jax_out), str(port_out)) in port_print
    want, got = np.load(jax_out), np.load(port_out)
    assert sorted(got.files) == sorted(want.files)
    assert any(k.endswith("/kernel_q") for k in got.files) == bool(extra)
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_empty_snapshot_raises_as_jax(snaps):
    with pytest.raises(FileNotFoundError):
        load_state_dict(snaps["root"] / "empty")
    with pytest.raises(FileNotFoundError):
        _jax_script().load_state_dict(snaps["root"] / "empty")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.int64, torch.int32, torch.uint8,
                                   torch.bool, torch.float64])
def test_safetensors_reader_matches_the_library(tmp_path, dtype):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"a": (torch.randn(3, 5, generator=gen) * 50).to(dtype),
               "scalar": torch.tensor(7).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    path = tmp_path / "t.safetensors"
    save_file(tensors, path, metadata={"format": "pt"})
    want, got = load_file(path), load_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


def test_safetensors_reader_takes_bf16_as_the_library(tmp_path):
    """BF16: the library gives ml_dtypes' bfloat16 where that package is
    loaded (jax loads it, as here); the port's reader gives the raw words
    whatever is loaded, which numpy will not cast or compute on, and
    `float32_leaf` widens them to the library's values bit for bit."""
    import ml_dtypes  # noqa: F401 — registers bfloat16 with numpy
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    path = tmp_path / "bf16.safetensors"
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    save_file({"w": (w * 1e3).to(torch.bfloat16),
               "v": BF16_VALUES.to(torch.bfloat16)}, path)
    want, got = load_file(path), load_safetensors(path)
    for name in ("w", "v"):
        assert want[name].dtype == np.dtype("bfloat16")
        assert got[name].dtype == BF16_BITS
        assert got[name].tobytes() == want[name].tobytes()
        wide = float32_leaf(got[name])
        assert wide.dtype == np.float32
        assert wide.tobytes() == want[name].astype(np.float32).tobytes()
        assert float32_leaf(got[name].T).tobytes() \
            == want[name].T.astype(np.float32).tobytes()
    with pytest.raises(ValueError):
        np.asarray(got["w"], np.float32)
    with pytest.raises(TypeError):
        np.abs(got["w"])


def test_safetensors_reader_refuses_bf16_without_ml_dtypes(port_cli):
    """Without ml_dtypes (the card's case, the refusing subprocess) the
    reader no longer refuses BF16: the widened values are bfloat16's."""
    _, stdout, _ = port_cli
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("BF16\t")]
    got = np.asarray(json.loads(line.split("\t")[1]), np.float32)
    want = BF16_VALUES.to(torch.bfloat16).float().numpy()
    assert got.tobytes() == want.tobytes()


def test_safetensors_reader_refuses_f8(tmp_path):
    from safetensors.torch import save_file

    path = tmp_path / "f8.safetensors"
    save_file({"w": torch.zeros(2, 3).to(torch.float8_e4m3fn)}, path)
    with pytest.raises(TypeError, match="F8_E4M3"):
        load_safetensors(path)


@pytest.mark.parametrize("extra", BF16_CASES)
def test_port_cli_converts_bf16_decoders_as_the_jax_script(
        snaps, port_cli, monkeypatch, capsys, extra):
    """The JAX script reads BF16 through ml_dtypes (jax loads it) and
    writes bf16 leaves as `|V2`; the port, with ml_dtypes refused, writes
    those as f32 equal to them widened, and the quantized kernels and
    scales bit for bit."""
    root = snaps["root"]
    jax_out = _decoder_out(root, "mistral_bf16", extra, "jax")
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "decoder",
                                      str(root / "mistral_bf16"),
                                      str(jax_out), *extra])
    assert _jax_script().main() == 0
    jax_print = capsys.readouterr().out
    codes, port_print, _ = port_cli
    assert codes[-len(BF16_CASES) + BF16_CASES.index(extra)] == 0
    port_out = _decoder_out(root, "mistral_bf16", extra, "port")
    for line in jax_print.splitlines():
        assert line.replace(str(jax_out), str(port_out)) in port_print
    want, got = np.load(jax_out), np.load(port_out)
    assert sorted(got.files) == sorted(want.files)
    assert any(k.endswith("/kernel_q") for k in got.files) == bool(extra)
    assert "lm_head/kernel_q" in got.files or not extra
    n_widened = 0
    for key in want.files:
        w, g = want[key], got[key]
        assert g.shape == w.shape, key
        if w.dtype.kind == "V":      # bf16 in the JAX script's npz
            n_widened += 1
            assert g.dtype == np.float32, key
            wide = (w.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32)
            assert g.tobytes() == wide.tobytes(), key
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), key
    # the quantized npz keeps the embedding and the norms in bf16 there;
    # the float one every tensor
    assert n_widened == (2 * 2 + 2 if extra else len(want.files))


def test_bf16_words_are_never_quantized_as_values():
    from rag_dpo_tpu_torch.models.decoder import quantize_decoder_params

    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    words = w.to(torch.bfloat16).view(torch.int16).numpy().view(BF16_BITS)
    wide = w.to(torch.bfloat16).float().numpy()

    def tree(kernel):
        return {"layer_0": {"up_proj": {"kernel": kernel}},
                "embed_tokens": {"embedding": kernel}}

    got = quantize_decoder_params(tree(words.T))
    want = quantize_decoder_params(tree(wide.T))
    for leaf in ("kernel_q", "scale"):
        assert got["layer_0"]["up_proj"][leaf].tobytes() \
            == want["layer_0"]["up_proj"][leaf].tobytes()
    assert got["embed_tokens"]["embedding"].dtype == BF16_BITS
    with pytest.raises(TypeError, match="not a float tensor"):
        quantize_decoder_params(tree(words.view(np.uint16).T))
    with pytest.raises(ValueError):
        np.asarray(words, np.float32)


def _ids():
    rng = np.random.default_rng(5)
    ids = rng.integers(4, 512, size=(2, 12)).astype(np.int64)
    ids[:, 0] = 0
    ids[1, 9:] = 1  # padding
    return ids


def test_port_encoder_matches_hf_last_hidden_state(snaps):
    state = load_state_dict(snaps["root"] / "m3_safetensors")
    enc = load_flax_params(TransformerEncoder(EncoderConfig(**_ENC_KW)),
                           convert_xlmr_state_dict(state)).eval()
    ids = _ids()
    lengths = (ids != 1).sum(1)
    with torch.no_grad():
        ref = snaps["m3"](torch.tensor(ids), attention_mask=torch.tensor(
            (ids != 1).astype(np.int64))).last_hidden_state.numpy()
        got = enc(torch.tensor(ids), torch.tensor(lengths)).numpy()
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(got[row, :n], ref[row, :n], atol=ATOL)


def _embedders(state):
    jemb = JEmbedder(JEmbedderConfig(model=JBgeM3Config(
        encoder=JEncoderConfig(use_flash_attention=False, **_ENC_KW),
        colbert_dim=16), batch_size=8))
    jemb.load_converted(state)
    emb = Embedder(EmbedderConfig(model=BgeM3Config(
        encoder=EncoderConfig(**_ENC_KW), colbert_dim=16), batch_size=8),
        device="cpu")
    emb.load()                       # seeded random, dropped by the load
    emb.load_converted(state)
    return jemb, emb


def test_embedder_load_converted_matches_jax(snaps):
    state = load_state_dict(snaps["root"] / "m3_bin")
    jemb, emb = _embedders(state)
    assert emb._params is None and emb.model is not None
    want = jemb.embed(TEXTS, return_sparse=True, return_colbert=True)
    got = emb.embed(TEXTS, return_sparse=True, return_colbert=True)
    np.testing.assert_allclose(got["dense"], np.asarray(want["dense"]),
                               atol=ATOL)
    for g, w in zip(got["sparse"], want["sparse"]):
        assert sorted(g) == sorted(w)
        np.testing.assert_allclose([g[t] for t in sorted(g)],
                                   [w[t] for t in sorted(w)], atol=ATOL)
    for g, w in zip(got["colbert"], want["colbert"]):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    np.testing.assert_allclose(emb.embed_queries(TEXTS),
                               np.asarray(jemb.embed_queries(TEXTS)),
                               atol=ATOL)
    # and the port's heads against HF's backbone + the sidecars
    enc = emb.tokenizer.encode_batch(TEXTS[:1], 32)
    n = int(enc.lengths[0])
    with torch.no_grad():
        h = snaps["m3"](torch.tensor(enc.input_ids[:, :n].astype(np.int64))
                        ).last_hidden_state
        ref_dense = torch.nn.functional.normalize(h[:, 0], dim=-1).numpy()
        ref_cb = torch.nn.functional.normalize(
            snaps["colbert"](h), dim=-1).numpy()[0]
    np.testing.assert_allclose(got["dense"][:1], ref_dense, atol=ATOL)
    np.testing.assert_allclose(got["colbert"][0], ref_cb, atol=ATOL)


def test_reranker_load_converted_matches_jax(snaps):
    state = load_state_dict(snaps["root"] / "rr_safetensors")
    jrr = JCrossEncoderReranker(model_config=JEncoderConfig(
        use_flash_attention=False, **_ENC_KW))
    jrr.load_converted(state)
    rr = CrossEncoderReranker(model_config=EncoderConfig(**_ENC_KW),
                              device="cpu")
    rr.load()
    rr.load_converted(state)
    assert rr._params is None and rr.model.with_head_dense
    np.testing.assert_allclose(rr.score_pairs(PAIRS),
                               np.asarray(jrr.score_pairs(PAIRS)),
                               atol=ATOL)


def test_reranker_bare_head_matches_hf(snaps):
    """A bare `classifier.weight` head: the port builds the model without
    the dense layer (the JAX reranker's model always has one); its scores
    are the sigmoid of HF's logit on CLS."""
    state = load_state_dict(snaps["root"] / "rr_bare_head")
    rr = CrossEncoderReranker(model_config=EncoderConfig(**_ENC_KW),
                              device="cpu")
    rr.load_converted(state)
    assert not rr.model.with_head_dense
    enc = rr.tokenizer.encode_pairs(PAIRS[:1], 64)
    n = int(enc.lengths[0])
    backbone = {k[len("roberta."):]: v for k, v in snaps["bare"].items()
                if k.startswith("roberta.")}
    from transformers import XLMRobertaConfig, XLMRobertaModel

    hf = XLMRobertaModel(XLMRobertaConfig(**_XLMR_KW),
                         add_pooling_layer=False).eval()
    hf.load_state_dict(backbone)
    with torch.no_grad():
        cls = hf(torch.tensor(enc.input_ids[:, :n].astype(np.int64))
                 ).last_hidden_state[:, 0]
        logit = cls @ snaps["bare"]["classifier.weight"].T \
            + snaps["bare"]["classifier.bias"]
    np.testing.assert_allclose(rr.score_pairs(PAIRS[:1]),
                               torch.sigmoid(logit)[:, 0].numpy(), atol=ATOL)
