"""The port's HF loaders against the JAX package's on the same files:
models/safetensors_io against the safetensors package, merge_hf_shards and
load_hf_llama (safetensors shards in fp16 and fp32, pytorch_model.bin in
fp16, fp32 and bf16), convert_mistral (GQA) and convert_phi, load_base_llm
into mla-tiny, load_openvla on an OpenVLA-keyed directory. The trees are
held bit for bit, the vocabulary's mean rows included; the HF models are
built in-process from a config (transformers), nothing is downloaded."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
st = pytest.importorskip("safetensors.torch")

from mla_tpu.conf.models import get_model_config as jconfig  # noqa: E402
from mla_tpu.models import convert as jconvert  # noqa: E402
from mla_tpu.models import load as jload  # noqa: E402
from mla_tpu.models import prismatic as jprismatic  # noqa: E402
from mla_tpu_torch import params as P  # noqa: E402
from mla_tpu_torch.conf.models import get_model_config as tconfig  # noqa: E402
from mla_tpu_torch.models import convert as tconvert  # noqa: E402
from mla_tpu_torch.models import load as tload  # noqa: E402
from mla_tpu_torch.models import prismatic as tprismatic  # noqa: E402
from mla_tpu_torch.models import safetensors_io as sio  # noqa: E402
from mla_tpu_torch.training.strategy import as_tensors  # noqa: E402

VLM_FLAGS = dict(use_diff=False, use_pointcloud=False, use_tactile=False, use_contrastive=False, use_generation=False)
HF_VOCAB = 32000  # Llama-2's; mla-tiny pads to 32064


def assert_same_tree(got, want, dtypes=True):
    """`got` (tensors) equals `want` (numpy) leaf for leaf, bit for bit;
    with dtypes=False a bf16 leaf of `got` may stand for JAX's fp32 one."""
    items = dict(P.tree_items(got))
    want_items = dict(P.tree_items(want))
    assert sorted(items) == sorted(want_items)
    for path, w in want_items.items():
        g = items[path].detach().cpu()
        w = np.asarray(w)
        if dtypes:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (path, g.dtype, w.dtype)
        else:
            g = g.to(torch.float32) if g.dtype == torch.bfloat16 else g
        gn = g.numpy()
        assert gn.shape == w.shape, (path, gn.shape, w.shape)
        assert np.array_equal(gn.astype(w.dtype), w), path


# --------------------------------------------------------------------------- #
# safetensors_io
# --------------------------------------------------------------------------- #

DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16,
          torch.int8, torch.uint8, torch.bool]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g).bool()
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g, dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).removeprefix("torch."))
def test_safetensors_io_matches_the_package(tmp_path, dtype):
    """Each dtype both ways: the package's file read by the port, the
    port's file read by the package, and the same bytes from both writers
    (0-d, empty and odd shapes beside an fp16 and an int64 tensor)."""
    tensors = {"x": _tensor(dtype, (3, 5), 1), "scalar": _tensor(dtype, (), 2), "empty": _tensor(dtype, (0, 4), 3),
               "h": _tensor(torch.float16, (7,), 4), "i": _tensor(torch.int64, (2, 3), 5)}
    meta = {"format": "pt"}
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"), metadata=meta)
    sio.save_file(tensors, tmp_path / "port.safetensors", metadata=meta)
    assert (tmp_path / "pkg.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()
    for got in (sio.load_file(tmp_path / "pkg.safetensors"), st.load_file(str(tmp_path / "port.safetensors"))):
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape and torch.equal(got[k], t), k
    assert sio.read_header(tmp_path / "pkg.safetensors")["__metadata__"] == meta


def test_safetensors_io_round_trip_and_lazy_subset(tmp_path):
    """A non-contiguous tensor and no metadata round-trip; load_file(keys=)
    gives just those keys, mapped over the file (writable, the file
    untouched); the CPU tensors share the mapping rather than copy it."""
    big = torch.randn(64, 32)
    tensors = {"t": big.t(), "w": torch.randn(5, 6).to(torch.bfloat16), "b": torch.arange(4, dtype=torch.int32)}
    path = tmp_path / "a.safetensors"
    sio.save_file(tensors, path)
    assert "__metadata__" not in sio.read_header(path)
    before = path.read_bytes()
    got = sio.load_file(path, keys=["w", "t"])
    assert sorted(got) == ["t", "w"] and torch.equal(got["t"], big.t()) and torch.equal(got["w"], tensors["w"])
    got["w"].zero_()  # copy-on-write: the file keeps its bytes
    assert path.read_bytes() == before
    f = sio.SafetensorsFile(path)
    a, b = f.get_tensor("t"), f.get_tensor("t")
    assert a.data_ptr() == b.data_ptr()
    with pytest.raises(KeyError, match="nope"):
        sio.load_file(path, keys=["nope"])


def _raw(tmp_path, header, data: bytes, n=None) -> str:
    blob = json.dumps(header).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob) if n is None else n) + blob + data)
    return path


@pytest.mark.parametrize("case,header,data,match", [
    ("overlap", {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                 "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, bytes(12), "overlaps"),
    ("gap", {"a": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]},
             "b": {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}}, bytes(12), "gap"),
    ("past-the-end", {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, bytes(8), "cover 16 bytes"),
    ("trailing-bytes", {"a": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]}}, bytes(8), "cover 4 bytes"),
    ("size", {"a": {"dtype": "F16", "shape": [3], "data_offsets": [0, 8]}}, bytes(8), "needs 6"),
    ("dtype", {"a": {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [0, 1]}}, bytes(1), "no known dtype"),
    ("metadata", {"__metadata__": {"k": 1}}, b"", "__metadata__"),
], ids=lambda v: v if isinstance(v, str) and " " not in v and "{" not in v else None)
def test_safetensors_io_refuses_a_corrupt_header(tmp_path, case, header, data, match):
    path = _raw(tmp_path, header, data)
    with pytest.raises(ValueError, match=match):
        sio.read_header(path)
    with pytest.raises(ValueError, match=match):
        sio.load_file(path)


def test_safetensors_io_refuses_a_bad_length_or_json(tmp_path):
    path = _raw(tmp_path, {}, b"", n=1 << 40)
    with pytest.raises(ValueError, match="does not fit"):
        sio.read_header(path)
    path.write_bytes(struct.pack("<Q", 4) + b"{no}")
    with pytest.raises(ValueError, match="not JSON"):
        sio.read_header(path)
    path.write_bytes(b"abc")
    with pytest.raises(ValueError, match="too short"):
        sio.read_header(path)


# --------------------------------------------------------------------------- #
# HF Llama directories
# --------------------------------------------------------------------------- #


def hf_llama(cfg, seed: int = 0, num_kv_heads=None, cls=None):
    """A seeded LlamaForCausalLM (or `cls`) at cfg.llama's widths with
    Llama-2's 32000-token vocabulary, untied head."""
    lc = cfg.llama
    kw = dict(vocab_size=HF_VOCAB, hidden_size=lc.hidden_size, intermediate_size=lc.intermediate_size,
              num_hidden_layers=lc.num_layers, num_attention_heads=lc.num_heads,
              num_key_value_heads=num_kv_heads or lc.num_kv_heads, rms_norm_eps=lc.rms_eps,
              max_position_embeddings=lc.max_position_embeddings, rope_theta=lc.rope_theta, tie_word_embeddings=False)
    torch.manual_seed(seed)
    if cls is None:
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw)).eval()
    return cls[0](cls[1](**kw)).eval()


@pytest.fixture(scope="module")
def llama_model():
    return hf_llama(tconfig("mla-tiny"))


FORMATS = {"fp16-safetensors": (torch.float16, True), "fp32-safetensors": (torch.float32, True),
           "fp16-bin": (torch.float16, False), "fp32-bin": (torch.float32, False), "bf16-bin": (torch.bfloat16, False)}


def save_hf(model, path, dtype, safe: bool):
    model.to(dtype).save_pretrained(str(path), safe_serialization=safe, max_shard_size="1MB")
    model.to(torch.float32)
    return path


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_load_hf_llama_matches_jax(llama_model, tmp_path, fmt):
    """A save_pretrained directory, sharded at 1 MB (index file beside the
    shards): every leaf equals JAX's bit for bit, the 64 mean rows of the
    padded vocabulary included (float16 means rounded as numpy rounds
    them; a bf16 file comes out of JAX in fp32, which the port's bf16
    leaves equal)."""
    dtype, safe = FORMATS[fmt]
    d = save_hf(llama_model, tmp_path / "hf", dtype, safe)
    assert len(list(d.glob("*.safetensors" if safe else "pytorch_model*.bin"))) > 1
    cfg = tconfig("mla-tiny")
    got = tconvert.load_hf_llama(d, cfg)
    want = jconvert.load_hf_llama(d, jconfig("mla-tiny"))
    assert_same_tree(got, want, dtypes=dtype != torch.bfloat16)
    assert got["embed"]["table"].shape[0] == cfg.llama.vocab_size > HF_VOCAB
    if dtype == torch.float16:  # the trap: fp16 means, not fp32 ones
        assert got["embed"]["table"].dtype == torch.float16


def test_merge_hf_shards_reads_only_what_is_converted(llama_model, tmp_path):
    """Converting 2 of the file's 4 layers reads their tensors, the
    embedding, the final norm and the head, nothing else."""
    d = save_hf(llama_model, tmp_path / "hf", torch.float16, True)
    sd = tconvert.merge_hf_shards(d)
    assert isinstance(sd, tconvert.LazyStateDict) and sd.bytes_read == 0
    tconvert.convert_llama(sd, 2, prefix="")
    want = sum(t.numel() * 2 for k, t in llama_model.state_dict().items()
               if not k.startswith("model.layers.") or int(k.split(".")[2]) < 2)
    assert sd.bytes_read == want
    assert want < sum(t.numel() * 2 for t in llama_model.state_dict().values())


def test_convert_mistral_matches_jax():
    """GQA: k and v project to 2 of 4 heads; the trees bit for bit, padded."""
    cfg = tconfig("mla-tiny")
    model = hf_llama(cfg, seed=1, num_kv_heads=2, cls=(transformers.MistralForCausalLM, transformers.MistralConfig))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    got = tconvert.convert_mistral(sd, 4, prefix="", target_vocab=32064)
    want = jconvert.convert_mistral(sd, 4, prefix="", target_vocab=32064)
    assert_same_tree(got, want)
    assert got["layers"]["attn"]["k"]["w"].shape == (4, 64, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
def test_convert_phi_matches_jax(dtype):
    """PhiForCausalLM: biased linears, LayerNorms, the lm_head bias padded
    with its mean too; bit for bit."""
    config = transformers.PhiConfig(vocab_size=200, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                    num_attention_heads=4, tie_word_embeddings=False)
    torch.manual_seed(2)
    model = transformers.PhiForCausalLM(config).to(dtype)
    for p in model.parameters():  # non-zero biases, so their means mean something
        torch.nn.init.normal_(p, 0, 0.3)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    got = tconvert.convert_phi(sd, 3, prefix="", target_vocab=256)
    want = jconvert.convert_phi(sd, 3, prefix="", target_vocab=256)
    assert_same_tree(got, want)
    assert got["lm_head"]["b"].shape == (256,)


def test_load_base_llm_into_mla_tiny_matches_jax(llama_model, tmp_path):
    """load_base_llm into each package's own init of mla-tiny: the decoder
    trees bit for bit in the model's param dtype, and the language-only
    vlm_forward logits within rtol 1e-4 / atol 1e-5."""
    d = save_hf(llama_model, tmp_path / "hf", torch.float16, True)
    jcfg, tcfg = jconfig("mla-tiny", **VLM_FLAGS), tconfig("mla-tiny", **VLM_FLAGS)
    jparams, jstate = jprismatic.mla_model_init(jax.random.PRNGKey(0), jcfg)
    jparams = jload.load_base_llm(d, jcfg, jparams)
    tparams, tstate = P.init(tcfg, seed=0, device="cpu")
    report = {}
    tparams = tload.load_base_llm(d, tcfg, tparams, device="cpu", report=report)
    assert_same_tree(tparams["llm_backbone"], jax.device_get(jparams["llm_backbone"]))
    assert tparams["llm_backbone"]["embed"]["table"].dtype == tcfg.llama.param_dtype
    assert report["bytes_read"] > 0 and report["dir_bytes"] >= report["bytes_read"] and report["seconds"] > 0
    rng = np.random.default_rng(5)
    batch = {"input_ids": rng.integers(3, HF_VOCAB, (2, 12)).astype(np.int32),
             "attention_mask": np.array([[True] * 12, [True] * 9 + [False] * 3]),
             "labels": rng.integers(3, HF_VOCAB, (2, 12)).astype(np.int32)}
    jout, _ = jprismatic.vlm_forward(jparams, jstate, jcfg, jax.tree_util.tree_map(jnp.asarray, batch))
    with torch.no_grad():
        tout, _ = tprismatic.vlm_forward(tparams, tstate, tcfg, as_tensors(batch, "cpu"))
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tout["lm_loss"]), float(jout["lm_loss"]), rtol=1e-5)


# --------------------------------------------------------------------------- #
# OpenVLA-style directories
# --------------------------------------------------------------------------- #


def timm_vit_sd(cfg, width: int, seed: int, dtype=torch.float32):
    """A timm VisionTransformer state dict of `cfg`'s layout (tokens,
    LayerScale, norm_pre) at a toy `width`, cfg.depth blocks."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return (torch.randn(shape, generator=g) * 0.1).to(dtype)

    hidden, p = 2 * width, cfg.patch_size
    n_pos = cfg.num_patches + (0 if cfg.no_embed_class else cfg.num_prefix_tokens)
    sd = {"patch_embed.proj.weight": r(width, 3, p, p), "patch_embed.proj.bias": r(width),
          "pos_embed": r(1, n_pos, width), "norm.weight": r(width), "norm.bias": r(width)}
    if cfg.use_cls_token:
        sd["cls_token"] = r(1, 1, width)
    if cfg.num_reg_tokens:
        sd["reg_token"] = r(1, cfg.num_reg_tokens, width)
    if cfg.pre_norm:
        sd["norm_pre.weight"], sd["norm_pre.bias"] = r(width), r(width)
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for name, shape in (("norm1", (width,)), ("norm2", (width,))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = r(*shape), r(*shape)
        for name, (o, i_) in (("attn.qkv", (3 * width, width)), ("attn.proj", (width, width)),
                              ("mlp.fc1", (hidden, width)), ("mlp.fc2", (width, hidden))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = r(o, i_), r(o)
        if cfg.use_layerscale:
            sd[f"{b}.ls1.gamma"], sd[f"{b}.ls2.gamma"] = r(width), r(width)
    return sd


def test_load_openvla_matches_jax(llama_model, tmp_path):
    """An OpenVLA-keyed directory (language_model., vision_backbone.
    featurizer. / .fused_featurizer. at the dinosiglip towers' depths and
    token layouts, toy widths, projector.fc1-3) in two safetensors shards:
    (params, legacy) bit for bit, the ViTConfigs equal."""
    from mla_tpu.models import vision_backbones as jvb

    dino, siglip = (jvb.VIT_CONFIGS[n] for n in jvb.FUSED_BACKBONES["dinosiglip-vit-so-224px"])
    sd = {f"language_model.{k}": v.detach() for k, v in llama_model.state_dict().items()}
    sd.update({f"vision_backbone.featurizer.{k}": v for k, v in timm_vit_sd(dino, 16, 1).items()})
    sd.update({f"vision_backbone.fused_featurizer.{k}": v for k, v in timm_vit_sd(siglip, 8, 2).items()})
    g = torch.Generator().manual_seed(3)
    for name, (o, i) in (("fc1", (96, 24)), ("fc2", (64, 96)), ("fc3", (64, 64))):
        sd[f"projector.{name}.weight"], sd[f"projector.{name}.bias"] = torch.randn(o, i, generator=g), torch.randn(o, generator=g)
    d = tmp_path / "openvla"
    d.mkdir()
    keys = sorted(sd)
    st.save_file({k: sd[k].contiguous() for k in keys[: len(keys) // 2]}, str(d / "model-00001-of-00002.safetensors"))
    st.save_file({k: sd[k].contiguous() for k in keys[len(keys) // 2:]}, str(d / "model-00002-of-00002.safetensors"))

    jcfg, tcfg = jconfig("mla-tiny", **VLM_FLAGS), tconfig("mla-tiny", **VLM_FLAGS)
    jparams, _ = jprismatic.mla_model_init(jax.random.PRNGKey(0), jcfg)
    want_p, want_legacy = jload.load_openvla(d, jcfg, jparams)
    tparams, _ = P.init(tcfg, seed=0, device="cpu")
    got_p, got_legacy = tload.load_openvla(d, tcfg, tparams, device="cpu")
    assert sorted(got_p) == sorted(want_p)
    assert_same_tree(got_p["llm_backbone"], want_p["llm_backbone"])
    assert got_p["projector_2d"] is tparams["projector_2d"]  # the rest of the tree is the caller's
    for name in ("dino_cfg", "siglip_cfg"):
        assert got_legacy[name].__dict__ == want_legacy[name].__dict__
    assert_same_tree({k: v for k, v in got_legacy.items() if not k.endswith("_cfg")},
                     {k: v for k, v in want_legacy.items() if not k.endswith("_cfg")})
    assert len(got_legacy["dino_featurizer"]["blocks"]) == 24 and "reg_token" in got_legacy["dino_featurizer"]
