"""The port's loader and format leftovers against the JAX package on the same
bytes: the native host IO library (built with g++ into build/drs_io/, and
its numpy fallback under DIFFUSION_RS_TPU_NO_NATIVE=1), the key / shape
inventories and their audit, the legacy GGML container, npy / npz and
PyTorch pickles, and ``io``'s exported names (tests/test_native.py,
tests/test_key_inventory.py and tests/test_io_formats.py, through both
packages)."""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import diffusion_rs_tpu.io as jio
import diffusion_rs_tpu_torch.io as tio
from diffusion_rs_tpu.io import audit as jaudit
from diffusion_rs_tpu.io import ggml as jggml
from diffusion_rs_tpu.io import legacy_formats as jlf
from diffusion_rs_tpu.io import native as jnative
from diffusion_rs_tpu.io.safetensors import SafeTensors as JSafeTensors
from diffusion_rs_tpu.io.varstore import VarStore as JVarStore
from diffusion_rs_tpu.models.clip import ClipTextConfig as JClipCfg
from diffusion_rs_tpu.models.flux import FluxConfig as JFluxCfg
from diffusion_rs_tpu.models.t5 import T5Config as JT5Cfg
from diffusion_rs_tpu.models.vae import VAEConfig as JVAECfg
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant import gguf_quants as jgq
from diffusion_rs_tpu_torch.io import audit as taudit
from diffusion_rs_tpu_torch.io import ggml as tggml
from diffusion_rs_tpu_torch.io import legacy_formats as tlf
from diffusion_rs_tpu_torch.io import native as tnative
from diffusion_rs_tpu_torch.io.builders import (build_clip_params, build_flux_params,
                                                build_t5_params, build_vae_params)
from diffusion_rs_tpu_torch.io.safetensors import SafeTensors as TSafeTensors
from diffusion_rs_tpu_torch.io.safetensors import save_safetensors
from diffusion_rs_tpu_torch.io.varstore import VarStore as TVarStore
from diffusion_rs_tpu_torch.models.clip import ClipTextConfig as TClipCfg
from diffusion_rs_tpu_torch.models.flux import FluxConfig as TFluxCfg
from diffusion_rs_tpu_torch.models.t5 import T5Config as TT5Cfg
from diffusion_rs_tpu_torch.models.vae import VAEConfig as TVAECfg
from diffusion_rs_tpu_torch.quant import bnb as tbnb
from diffusion_rs_tpu_torch.quant.qtensor import choose_split, pack4

FIXTURES = pathlib.Path(__file__).parent / "key_inventories"


def _reset(native):
    native._tried = False
    native._lib = None


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' native libraries off (their numpy fallbacks)."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_NO_NATIVE", "1")
    for m in (tnative, jnative):
        _reset(m)
    yield
    monkeypatch.undo()
    for m in (tnative, jnative):
        _reset(m)


# -- io/native.py --------------------------------------------------------------


def test_port_builds_its_own_library():
    """The port builds native/drs_io.cpp into build/drs_io/ under the
    source's hash and loads it; DIFFUSION_RS_TPU_NO_NATIVE is not set."""
    _reset(tnative)
    lib = tnative.get_lib()
    assert lib is not None and lib.drs_version() == 1
    path = tnative._lib_path()
    assert path.exists() and path.parent == pathlib.Path(tnative._ROOT) / "build" / "drs_io"


@pytest.mark.parametrize("dtype", [np.uint8, np.float16, np.float32, np.int64])
@pytest.mark.parametrize("native", ["built", "numpy"])
def test_transpose_matches_jax(request, dtype, native):
    if native == "numpy":
        request.getfixturevalue("no_native")
    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, size=(130, 70)).astype(dtype)
    got = tnative.transpose_2d(a)
    np.testing.assert_array_equal(got, jnative.transpose_2d(a))
    np.testing.assert_array_equal(got, a.T)


def test_bnb_repack_matches_jax():
    rng = np.random.default_rng(0)
    n_out, n_in = 48, 512
    stream = rng.integers(0, 256, size=n_out * n_in // 2, dtype=np.uint8)
    split = choose_split(n_in)
    got = tnative.bnb_repack4(stream, n_out, n_in, split)
    assert got is not None
    np.testing.assert_array_equal(got, jnative.bnb_repack4(stream, n_out, n_in, split))
    q = tbnb.unpack_bnb_nibbles(stream, n_out * n_in).reshape(n_out, n_in)
    np.testing.assert_array_equal(got, pack4(np.ascontiguousarray(q.T), split))


def test_read_spans_matches_jax(tmp_path):
    data = np.random.default_rng(0).integers(0, 256, size=4096, dtype=np.uint8).tobytes()
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    offsets, sizes = [0, 100, 4000], [50, 1024, 96]
    got = tnative.read_spans(str(p), offsets, sizes)
    want = jnative.read_spans(str(p), offsets, sizes)
    assert got is not None
    for off, size, a, b in zip(offsets, sizes, got, want):
        assert bytes(a) == bytes(b) == data[off:off + size]


@pytest.mark.parametrize("native", ["built", "numpy"])
@pytest.mark.parametrize("kind", ["nf4", "fp4"])
def test_bnb_canonical_matches_jax(request, native, kind):
    """bnb4bit_to_canonical through the native repack and through numpy
    gives JAX's planes bit for bit."""
    if native == "numpy":
        request.getfixturevalue("no_native")
        assert tnative.get_lib() is None
    else:
        assert tnative.get_lib() is not None
    w = np.random.default_rng(1).standard_normal((16, 256)).astype(np.float32)
    packed, absmax = jbnb.quantize_4bit_bnb_layout(w, 64, kind)
    t = tbnb.bnb4bit_to_canonical(packed, absmax, (16, 256), 64, kind)
    j = jbnb.bnb4bit_to_canonical(packed, absmax, (16, 256), 64, kind)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.split, t.group, t.shape) == (j.split, j.group, tuple(j.shape))


@pytest.mark.parametrize("native", ["built", "numpy"])
def test_safetensors_parallel_read_matches_jax(request, tmp_path, native):
    """``from_file(parallel_read=True)`` reads every span into owned buffers
    with the native reader (the mmap views without it), equal to JAX's."""
    if native == "numpy":
        request.getfixturevalue("no_native")
    rng = np.random.default_rng(2)
    tensors = {"a": rng.standard_normal((4, 8)).astype(np.float32),
               "b": rng.integers(0, 255, size=(16,)).astype(np.uint8),
               "c": torch.randn(3, 5, generator=torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16)}
    p = str(tmp_path / "x.safetensors")
    save_safetensors(p, tensors)
    st = TSafeTensors.from_file(p, parallel_read=True)
    js = JSafeTensors.from_file(p, parallel_read=True)
    assert bool(st._owned) == bool(js._owned) == (native == "built")
    for k in ("a", "b"):
        np.testing.assert_array_equal(st.numpy(k), js.numpy(k))
        np.testing.assert_array_equal(st.numpy(k), tensors[k])
    np.testing.assert_array_equal(st.numpy("c"), np.asarray(js.numpy("c")).view(np.uint16))
    assert torch.equal(st.tensor("c"), tensors["c"])


# -- io/audit.py ---------------------------------------------------------------

TINY_FLUX = dict(in_channels=8, pooled_projection_dim=12, joint_attention_dim=16,
                 num_attention_heads=4, hidden_size=48)
INVENTORIES = {
    "flux_dev": ("expected_flux_keys", JFluxCfg, TFluxCfg,
                 dict(num_layers=19, num_single_layers=38, **TINY_FLUX)),
    "flux_schnell": ("expected_flux_keys", JFluxCfg, TFluxCfg,
                     dict(num_layers=2, num_single_layers=3, guidance_embeds=False,
                          **TINY_FLUX)),
    "flux_bfl": ("expected_flux_keys_bfl", JFluxCfg, TFluxCfg,
                 dict(num_layers=19, num_single_layers=38, **TINY_FLUX)),
    "flux_full": ("expected_flux_keys", JFluxCfg, TFluxCfg, {}),
    "vae": ("expected_vae_keys", JVAECfg, TVAECfg,
            dict(block_out_channels=(8, 16, 32, 32), latent_channels=4)),
    "vae_quant_convs": ("expected_vae_keys", JVAECfg, TVAECfg,
                        dict(block_out_channels=(8, 16), latent_channels=4,
                             use_quant_conv=True, use_post_quant_conv=True)),
    "t5_xxl": ("expected_t5_keys", JT5Cfg, TT5Cfg, {}),
    "clip_l": ("expected_clip_keys", JClipCfg, TClipCfg, {}),
}


@pytest.mark.parametrize("name", list(INVENTORIES))
def test_inventory_matches_jax(name):
    fn, jcfg, tcfg, kw = INVENTORIES[name]
    got = getattr(taudit, fn)(tcfg(**kw))
    assert got == getattr(jaudit, fn)(jcfg(**kw))
    assert list(got) == list(getattr(jaudit, fn)(jcfg(**kw)))  # same order


@pytest.mark.parametrize("name", ["t5_xxl", "clip_l"])
def test_text_inventories_match_transformers_fixtures(name):
    fn, _, tcfg, kw = INVENTORIES[name]
    fix = json.loads((FIXTURES / f"{name}.json").read_text())
    assert {k: tuple(v) for k, v in fix.items()} == getattr(taudit, fn)(tcfg(**kw))


def test_inventory_parameter_totals():
    """The published parameter counts (tests/test_key_inventory.py)."""
    def total(inv):
        return sum(math.prod(s) for s in inv.values())

    dev = total(taudit.expected_flux_keys(TFluxCfg()))
    assert dev == 11_901_408_320
    assert total(taudit.expected_flux_keys_bfl(TFluxCfg())) == dev
    assert total(taudit.expected_vae_keys(TVAECfg())) == 83_819_683
    assert total(taudit.expected_t5_keys(TT5Cfg())) == 4_762_310_656


class _Recording(TVarStore):
    """A port VarStore that records every key read (raw_entry)."""

    def __init__(self, inv):
        super().__init__(default_dtype=torch.float32, device="cpu")
        self.read = set()
        for k, shape in inv.items():
            self.add_tensor(k, torch.zeros(shape))

    def raw_entry(self, name):
        self.read.add(name)
        return super().raw_entry(name)


@pytest.mark.parametrize("name,build", [
    ("flux_dev", build_flux_params), ("flux_bfl", build_flux_params),
    ("vae", build_vae_params), ("vae_quant_convs", build_vae_params)])
def test_port_builder_consumes_exact_inventory(name, build):
    """The port's builders read exactly the inventory's keys."""
    fn, _, tcfg, kw = INVENTORIES[name]
    cfg = tcfg(**kw)
    inv = getattr(taudit, fn)(cfg)
    store = _Recording(inv)
    build(store, cfg, torch.float32)
    assert store.read == set(inv), (sorted(set(inv) - store.read)[:5],
                                    sorted(store.read - set(inv))[:5])


@pytest.mark.parametrize("build,cfg", [
    (build_t5_params, TT5Cfg(vocab_size=100, d_model=16, d_kv=4, d_ff=32, num_layers=24,
                             num_heads=4)),
    (build_clip_params, TClipCfg(vocab_size=100, projection_dim=16, intermediate_size=32,
                                 num_hidden_layers=12, num_attention_heads=4))],
    ids=["t5", "clip"])
def test_port_text_builder_consumes_exact_inventory(build, cfg):
    inv = (taudit.expected_t5_keys(cfg) if build is build_t5_params
           else taudit.expected_clip_keys(cfg))
    store = _Recording(inv)
    build(store, cfg, torch.float32)
    assert store.read == set(inv)


def test_audit_report_matches_jax():
    cfg = dict(num_layers=1, num_single_layers=1, guidance_embeds=False, **TINY_FLUX)
    inv = taudit.expected_flux_keys(TFluxCfg(**cfg))
    present = dict(inv)
    del present["proj_out.bias"]
    present["stray.key"] = (3,)
    present["text_model.embeddings.position_ids"] = (1, 77)  # ignorable buffer
    k = "transformer_blocks.0.attn.to_q.weight"
    present[k] = (1, 2)
    rep = taudit.audit_keys(present, inv)
    jrep = jaudit.audit_keys(present, jaudit.expected_flux_keys(JFluxCfg(**cfg)))
    assert (rep.missing, rep.unexpected, rep.shape_mismatch) == (
        jrep.missing, jrep.unexpected, jrep.shape_mismatch)
    assert rep.missing == ["proj_out.bias"] and rep.unexpected == ["stray.key"]
    assert rep.shape_mismatch == [(k, inv[k], (1, 2))]
    assert not rep.ok and rep.summary() == jrep.summary()
    assert taudit.audit_keys(inv, inv).ok
    assert taudit.audit_keys(inv, inv).summary() == "checkpoint matches inventory"


def test_store_shapes_matches_jax(tmp_path):
    """store_shapes of both packages' stores over one safetensors file and
    one GGUF file (quantized entries keep their logical shape)."""
    rng = np.random.default_rng(3)
    p = str(tmp_path / "m.safetensors")
    save_safetensors(p, {"a.weight": rng.standard_normal((6, 4)).astype(np.float32),
                         "b": np.zeros((3,), np.float32)})
    w = (rng.standard_normal((8, 512)) * 0.05).astype(np.float32)
    g = str(tmp_path / "m.gguf")
    jio.write_gguf(g, {"blk.w": ("q4_0", (8, 512), jgq.ENCODERS["q4_0"](w))})
    ts = TVarStore(default_dtype=torch.float32, device="cpu")
    ts.add_safetensors(TSafeTensors.from_file(p))
    ts.add_gguf(tio.GgufFile(g))
    js = JVarStore()
    js.add_safetensors(JSafeTensors.from_file(p))
    js.add_gguf(jio.GgufFile(g))
    assert taudit.store_shapes(ts) == jaudit.store_shapes(js) == {
        "a.weight": (6, 4), "b": (3,), "blk.w": (8, 512)}


# -- io/ggml.py ------------------------------------------------------------------


def _ggml_tensors():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((8, 512)) * 0.05).astype(np.float32)
    dense = rng.standard_normal((4, 4)).astype(np.float32)
    return w, dense, {"blk.w": ("q4_0", (8, 512), jgq.ENCODERS["q4_0"](w)),
                      "norm.w": ("f32", (4, 4), dense.tobytes())}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("magic", ["ggjt", "ggmf", "ggml"])
def test_ggml_matches_jax(tmp_path, writer, magic):
    """Either package's writer, both readers: the same file bytes, header,
    vocab, tensor records (ggjt's 32-byte alignment) and payloads."""
    code = {"ggjt": (tggml.MAGIC_GGJT, 3), "ggmf": (tggml.MAGIC_GGMF, 1),
            "ggml": (tggml.MAGIC_GGML, 0)}[magic]
    _, dense, tensors = _ggml_tensors()
    vocab = [(b"<s>", 0.0), (b"hello", -1.5)]
    kw = dict(vocab=vocab, magic=code[0], version=code[1])
    paths = {}
    for name, mod in (("port", tggml), ("jax", jggml)):
        paths[name] = str(tmp_path / f"{name}.{magic}")
        mod.write_ggml(paths[name], tensors, hparams=mod.GgmlHParams(2, 64, 256, 4, 2, 16, 2),
                       **kw)
    assert pathlib.Path(paths["port"]).read_bytes() == pathlib.Path(paths["jax"]).read_bytes()
    t, j = tggml.GgmlFile(paths[writer]), jggml.GgmlFile(paths[writer])
    assert (t.magic, t.version, t.hparams.n_embd) == (j.magic, j.version, j.hparams.n_embd)
    assert t.vocab == [(tok, s if magic != "ggml" else 0.0) for tok, s in vocab] == j.vocab
    assert ({k: dataclasses.astuple(v) for k, v in t.tensors.items()}
            == {k: dataclasses.astuple(v) for k, v in j.tensors.items()})
    if magic == "ggjt":
        assert t.tensors["blk.w"].start % 32 == 0
    assert bytes(t.raw("blk.w")) == bytes(j.raw("blk.w")) == tensors["blk.w"][2]
    np.testing.assert_array_equal(t.numpy("norm.w"), j.numpy("norm.w"))
    assert torch.equal(t.tensor("norm.w"), torch.from_numpy(dense))
    with pytest.raises(ValueError, match="quantized"):
        t.numpy("blk.w")


def test_ggml_rejects_bad_magic(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a legacy GGML file"):
        tggml.GgmlFile(str(p))


# -- io/legacy_formats.py ----------------------------------------------------------


def test_npy_npz_match_jax(tmp_path):
    a = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    tlf.write_npy(str(tmp_path / "t.npy"), a)
    jlf.write_npy(str(tmp_path / "j.npy"), a)
    assert (tmp_path / "t.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    np.testing.assert_array_equal(tlf.read_npy(str(tmp_path / "j.npy")), a)
    tlf.write_npz(str(tmp_path / "z.npz"), {"x": a, "y": a * 2})
    t, j = tlf.read_npz(str(tmp_path / "z.npz")), jlf.read_npz(str(tmp_path / "z.npz"))
    assert t.keys() == j.keys() == {"x", "y"}
    np.testing.assert_array_equal(t["y"], j["y"])


def test_read_pytorch_matches_jax(tmp_path):
    gen = torch.Generator().manual_seed(0)
    sd = {"layer.weight": torch.randn(4, 4, generator=gen),
          "nested": {"bias": torch.arange(3, dtype=torch.float32), "step": 7},
          "bf16": torch.randn(2, 2, generator=gen, dtype=torch.bfloat16)}
    p = str(tmp_path / "m.pt")
    torch.save(sd, p)
    t, j = tlf.read_pytorch(p), jlf.read_pytorch(p)
    assert t.keys() == j.keys() == {"layer.weight", "nested.bias", "bf16"}
    for k in ("layer.weight", "nested.bias"):
        np.testing.assert_array_equal(t[k].numpy(), j[k])
    assert t["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["bf16"].float().numpy(), j["bf16"].astype(np.float32))

    store = TVarStore(default_dtype=torch.float32, device="cpu")
    tlf.add_pytorch_to_store(store, p, prefix="m.")
    assert set(store.keys()) == {"m.layer.weight", "m.nested.bias", "m.bf16"}
    assert torch.equal(store.get("m.layer.weight"), sd["layer.weight"])


# -- io/__init__.py ----------------------------------------------------------------


def test_io_exports_match_jax():
    public = lambda m: {n for n in dir(m) if not n.startswith("_")}  # noqa: E731
    names = {"SafeTensors", "DdufFile", "GgufFile", "write_gguf", "GgmlFile", "write_ggml",
             "VarStore", "VarStoreView", "FileLoader", "resolve_token", "build_clip_params",
             "build_flux_params", "build_t5_params", "build_vae_params", "stack_trees",
             "load_clip_bpe_tokenizer", "load_t5_tokenizer", "load_t5_tokenizer_from_bytes",
             "tokenize_and_pad"}
    assert names <= public(jio) and names <= public(tio)
    stacked = tio.stack_trees([{"w": torch.full((2, 3), float(i))} for i in range(4)])
    assert stacked["w"].shape == (4, 2, 3) and torch.equal(stacked["w"][2], torch.full((2, 3), 2.0))
