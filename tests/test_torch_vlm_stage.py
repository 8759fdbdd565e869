"""The port's VLM pretraining stage against the JAX package's: every prompt
builder's strings, the dataset registry, SplitModalitySampler's index
order, the LM collator and both datasets' items (synthetic examples and a
PNG data root; a JPEG is refused), one vlm-align and one vlm-finetune loss
and its gradients (losses within rtol 1e-5, each gradient leaf within rtol
1e-4 / atol 1e-6, fp32 mla-tiny), the stages' freezing in a train step,
and the CLI: python -m mla_tpu_torch.train --vlm_stage align|finetune, and
--hf_llama_dir in both loops."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.conf import datasets as jdatasets
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.diffusion import gaussian as jgd
from mla_tpu.models import convert as jconvert
from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.models import prompting as jprompting
from mla_tpu.vla import sampler as jsampler
from mla_tpu.vla import vlm_datasets as jvlm
from mla_tpu.vla.tokenizer import SimpleTokenizer as JTokenizer
from mla_tpu_torch import params as P
from mla_tpu_torch import train
from mla_tpu_torch.conf import datasets as tdatasets
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.models import prompting as tprompting
from mla_tpu_torch.training import optim, strategy
from mla_tpu_torch.training.strategy import as_tensors
from mla_tpu_torch.vla import sampler as tsampler
from mla_tpu_torch.vla import vlm_datasets as tvlm
from mla_tpu_torch.vla.tokenizer import SimpleTokenizer as TTokenizer

VLM_FLAGS = dict(use_diff=False, use_pointcloud=False, use_tactile=False, use_contrastive=False, use_generation=False)

# --------------------------------------------------------------------------- #
# prompts, registry, sampler
# --------------------------------------------------------------------------- #

DIALOGS = [
    [("human", "What is on the table?\n<image>"), ("gpt", "A red block."), ("human", "  And left of it? "), ("gpt", "")],
    [("human", "<image>\nDescribe the scene."), ("gpt", "A robot arm above a plate.")],
]


@pytest.mark.parametrize("system", [None, "Be brief."], ids=["default-system", "system"])
@pytest.mark.parametrize("family", list(jprompting.PROMPT_BUILDERS))
def test_prompt_builders_match_jax(family, system):
    """Every turn's wrapped string, the potential prompt before each turn
    and the final prompt, exactly."""
    assert list(tprompting.PROMPT_BUILDERS) == list(jprompting.PROMPT_BUILDERS)
    for dialog in DIALOGS:
        jb, tb = jprompting.get_prompt_builder(family, system), tprompting.get_prompt_builder(family, system)
        for role, msg in dialog:
            if role == "human":
                assert tb.get_potential_prompt(msg) == jb.get_potential_prompt(msg)
            assert tb.add_turn(role, msg) == jb.add_turn(role, msg)
            assert tb.get_prompt() == jb.get_prompt()
    with pytest.raises(AssertionError):
        tprompting.get_prompt_builder(family).add_turn("gpt", "out of turn")


def test_dataset_registry_matches_jax():
    assert tdatasets.DATASET_REGISTRY.keys() == jdatasets.DATASET_REGISTRY.keys()
    for name in tdatasets.DATASET_REGISTRY:
        t, j = tdatasets.get_dataset_config(name), jdatasets.get_dataset_config(name)
        for stage in ("align", "projector", "finetune", "full-finetune", "pretrain"):
            assert t.components_for_stage(stage) == j.components_for_stage(stage)
        assert t.dataset_root_dir == j.dataset_root_dir
    with pytest.raises(ValueError, match="unknown VLM pretraining stage"):
        tdatasets.get_dataset_config("llava-v15").components_for_stage("post")
    with pytest.raises(ValueError, match="unknown dataset"):
        tdatasets.get_dataset_config("llava-v99")
    assert tdatasets.get_dataset_config("llava-v15", dataset_root_dir="x").dataset_root_dir == "x"


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop-last", "keep-last"])
def test_split_modality_sampler_matches_jax(drop_last, replicas):
    """The indices each replica draws, over seeds and epochs, exactly: 37
    examples (23 multimodal) of mixed lengths at a global batch of 6, so
    megabatches, short batches and the cycling pad all occur."""
    rng = np.random.default_rng(0)
    lengths = [(bool(m), int(n)) for m, n in zip(rng.random(37) < 0.62, rng.integers(3, 90, 37))]
    for seed in (0, 7, 123):
        for epoch in (0, 1, 4):
            for rank in range(replicas):
                kw = dict(global_batch_size=6, num_replicas=replicas, rank=rank, seed=seed, drop_last=drop_last)
                j, t = jsampler.SplitModalitySampler(lengths, **kw), tsampler.SplitModalitySampler(lengths, **kw)
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                got = [int(i) for i in t]
                assert got == [int(i) for i in j] and len(t) == len(j) == len(got)


# --------------------------------------------------------------------------- #
# datasets and collator
# --------------------------------------------------------------------------- #


def _synthetic(pkg, image_size=32):
    examples, loader = pkg.synthetic_vlm_examples(n_multimodal=3, n_unimodal=3, image_size=image_size)
    return dict(examples=examples, image_loader=loader, image_size=image_size)


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_synthetic_items_and_collator_match_jax(stage):
    """The synthetic examples, each item (ids, labels, pixels) and the
    collated batch, exactly; lengths by modality."""
    je, _ = jvlm.synthetic_vlm_examples(seed=3)
    te, _ = tvlm.synthetic_vlm_examples(seed=3)
    assert te == je
    if stage == "align":
        jds = jvlm.VLMAlignDataset("unused.json", ".", JTokenizer(), **_synthetic(jvlm))
        tds = tvlm.VLMAlignDataset("unused.json", ".", TTokenizer(), **_synthetic(tvlm))
        assert tds.get_modality_lengths(n_image_patches=33) == jds.get_modality_lengths(n_image_patches=33)
    else:
        jds = jvlm.VLMFinetuneDataset("unused.json", ".", JTokenizer(), max_length=9, **_synthetic(jvlm))
        tds = tvlm.VLMFinetuneDataset("unused.json", ".", TTokenizer(), max_length=9, **_synthetic(tvlm))
        assert tds.get_modality_lengths() == jds.get_modality_lengths()
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])
    for rows in ([0, 1, 2], [3, 4, 5], [0, 5]):
        want = jsampler.PaddedCollatorForLanguageModeling(16)([jds[i] for i in rows])
        got = tsampler.PaddedCollatorForLanguageModeling(16)([tds[i] for i in rows])
        assert_items_equal(got, want)


def _png_root(tmp_path):
    """A LLaVA-style chat json and PNG images of each colour type Pillow
    writes: RGB, grey, grey + alpha, RGBA and palette."""
    from PIL import Image

    rng = np.random.default_rng(4)
    examples = []
    for i, mode in enumerate(("RGB", "L", "LA", "RGBA", "P")):
        rgb = rng.integers(0, 256, (30 + i, 41, 3), np.uint8)
        im = Image.fromarray(rgb).convert(mode) if mode != "P" else Image.fromarray(rgb).quantize(64)
        im.save(tmp_path / f"im{i}.png")
        examples.append({"id": str(i), "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nWhat is it?"}, {"from": "gpt", "value": f"object {i}"}]})
    examples.append({"id": "t", "conversations": [{"from": "human", "value": "Hi"}, {"from": "gpt", "value": "Hello"}]})
    (tmp_path / "chat.json").write_text(json.dumps(examples))
    return tmp_path / "chat.json"


@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_png_data_root_items_match_jax(tmp_path, stage):
    """Items read from disk (Pillow's convert("RGB") in JAX, the port's
    PNG decoder here): ids, labels and pixels exactly."""
    chat = _png_root(tmp_path)
    cls = {"align": "VLMAlignDataset", "finetune": "VLMFinetuneDataset"}[stage]
    jds = getattr(jvlm, cls)(chat, tmp_path, JTokenizer(), image_size=24)
    tds = getattr(tvlm, cls)(chat, tmp_path, TTokenizer(), image_size=24)
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])


def test_a_jpeg_is_refused(tmp_path):
    """(The name is the test's from before the port decoded JPEG.) A JPEG
    now loads as Pillow's convert("RGB") gives it, bit for bit, as JAX's
    loader reads it, and so do a GIF and a TIFF; a corrupt GIF raises, and a
    JPEG 2000 stream, which only Pillow reads, is refused citing the
    ROADMAP item."""
    from PIL import Image

    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:37, :53]
    img = np.clip(np.stack([xx * 4, yy * 6, xx + yy], -1) + rng.normal(0, 5, (37, 53, 3)), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(img[..., 0]).save(tmp_path / "grey.jpg", quality=90)
    (tmp_path / "b.gif").write_bytes(b"GIF89a" + bytes(20))
    Image.fromarray(img).convert("P").save(tmp_path / "c.gif")
    Image.fromarray(img).save(tmp_path / "d.tif")
    Image.fromarray(img).save(tmp_path / "e.jp2")
    for name in ("a.jpg", "grey.jpg", "c.gif", "d.tif"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        assert np.array_equal(tvlm._load_image(tmp_path, name), want)
        assert np.array_equal(jvlm._load_image(tmp_path, name), want)
    with pytest.raises(ValueError, match="corrupt GIF data"):
        tvlm._load_image(tmp_path, "b.gif")
    with pytest.raises(NotImplementedError, match=r"JPEG2000 images.*not decoded.*item 2"):
        tvlm._load_image(tmp_path, "e.jp2")


@pytest.mark.parametrize("stage", ["align", "finetune", "align mixed", "finetune mixed"])
def test_jpeg_data_root_items_match_jax(tmp_path, stage):
    """A LLaVA-layout data root of JPEG images (the port's encoder), and a
    mixed one whose every other image is a golden stream of a format only
    Pillow reads (TIFF, Netpbm, TGA, ICO, QOI, PCX, SGI): the stage's items
    through get_vlm_dataset_and_collator, Pillow's convert("RGB") in JAX and
    the port's decoders here: ids, labels and pixels exactly."""
    import chip_smoke

    stage, mixed = stage.split()[0], stage.endswith("mixed")
    images = 2 * len(chip_smoke.LLAVA_OTHER_FORMATS) if mixed else 5
    chip_smoke.llava_jpeg_fixture(tmp_path, images, (29, 45), 3, stage, mixed)
    kw = dict(image_size=24, max_length=40)
    tds, _ = tvlm.get_vlm_dataset_and_collator(stage, tdatasets.get_dataset_config("llava-v15"), str(tmp_path),
                                                TTokenizer(), **kw)
    jds, _ = jvlm.get_vlm_dataset_and_collator(stage, jdatasets.get_dataset_config("llava-v15"), str(tmp_path),
                                                JTokenizer(), **kw)
    assert len(tds) == len(jds) == images + 2
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])


def test_cli_vlm_stage_on_a_jpeg_data_root(tmp_path):
    """--vlm_stage finetune --data_root_dir on JPEG images: two steps,
    finite losses."""
    import chip_smoke

    chip_smoke.llava_jpeg_fixture(tmp_path / "data", 12, (40, 56), 5)
    out = train.main(vlm_argv(tmp_path, "finetune", "--data_root_dir", str(tmp_path / "data")))
    losses = out["metrics"].windows["ar_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_get_vlm_dataset_and_collator_matches_jax(tmp_path):
    """The stage's components under a data root, the synthetic fallback,
    the collator's length and pad id."""
    cfg_t, cfg_j = tdatasets.get_dataset_config("llava-v15"), jdatasets.get_dataset_config("llava-v15")
    for stage in ("align", "vlm-align", "finetune"):
        tds, tcol = tvlm.get_vlm_dataset_and_collator(stage, cfg_t, None, TTokenizer(), image_size=24, max_length=20)
        jds, jcol = jvlm.get_vlm_dataset_and_collator(stage, cfg_j, None, JTokenizer(), image_size=24, max_length=20)
        assert type(tds).__name__ == type(jds).__name__ and len(tds) == len(jds) == 12
        assert (tcol.max_length, tcol.pad_token_id) == (jcol.max_length, jcol.pad_token_id) == (20, 32000)
        assert_items_equal(tcol([tds[0], tds[11]]), jcol([jds[0], jds[11]]))
    with pytest.raises(FileNotFoundError):
        tvlm.get_vlm_dataset_and_collator("align", cfg_t, str(tmp_path), TTokenizer())


# --------------------------------------------------------------------------- #
# the VLM train step
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def vlm_model():
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(0), jconfig("mla-tiny", **VLM_FLAGS))
    return jax.device_get(params), jax.device_get(state)


def vlm_batch(stage: str, multimodal: bool):
    """Two rows of the stage's synthetic data, collated (24 ids), as the
    loop's batch: with images or language-only."""
    ds, col = tvlm.get_vlm_dataset_and_collator(stage, tdatasets.get_dataset_config("llava-v15"), None, TTokenizer(),
                                                image_size=168, max_length=24)
    rows = [0, 1] if multimodal else [7, 8]
    return train.vlm_model_batch(col([ds[i] for i in rows]))


CASES = [("align", True), ("finetune", True), ("finetune", False)]


@pytest.mark.parametrize("stage,multimodal", CASES, ids=["align", "finetune", "finetune-language-only"])
def test_vlm_loss_and_gradients_match_jax(vlm_model, stage, multimodal, record_property):
    params, state = vlm_model
    b = vlm_batch(stage, multimodal)
    jcfg, tcfg = jconfig("mla-tiny", **VLM_FLAGS), tconfig("mla-tiny", **VLM_FLAGS)
    sched = jgd.create_schedule("", diffusion_steps=100)

    def loss(p):
        return jmla.mla_train_loss(p, state, jcfg, sched, jax.tree_util.tree_map(jnp.asarray, b),
                                   jax.random.PRNGKey(1), repeated_diffusion_steps=1, remat=True)

    (jtotal, (jl, _)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tparams = P.from_jax(params)
    for _, leaf in P.tree_items(tparams):
        leaf.requires_grad_(True)
    total, (tl, _) = tmla.mla_train_loss(tparams, P.from_jax(state), tcfg, tgd.create_schedule("", diffusion_steps=100),
                                         as_tensors(b, "cpu"), repeated_diffusion_steps=1, remat=True)
    total.backward()
    for k in ("total_loss", "ar_loss"):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=1e-5, err_msg=k)
    want = dict(P.tree_items(jax.device_get(jgrads)))
    nonzero = 0
    for path, leaf in P.tree_items(tparams):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]), rtol=1e-4, atol=1e-6, err_msg=path)
        nonzero += bool(np.abs(want[path]).max() > 0)
    assert nonzero > (10 if multimodal else 5), nonzero
    record_property("loss", float(jtotal))


@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_vlm_train_step_freezes_by_stage(vlm_model, stage):
    """One train step at vlm-{stage}: align moves the projector only
    (llm_backbone and the vision tower bit for bit), finetune the decoder
    too; a language-only align batch reaches no trained leaf and steps."""
    cfg = tconfig("mla-tiny", **VLM_FLAGS)
    params = P.from_jax(vlm_model[0])
    before = P.tree_map(lambda t: t.clone(), params)
    opt, _, mask = optim.make_optimizer(params, learning_rate=1e-3, num_training_steps=4, stage=f"vlm-{stage}")
    step = strategy.make_train_step(cfg, strategy.TrainConfig(repeated_diffusion_steps=1),
                                    tgd.create_schedule("", diffusion_steps=100))
    st = strategy.init_train_state(params, opt, P.from_jax(vlm_model[1]))
    st, m = step(st, vlm_batch(stage, True))
    assert np.isfinite(float(m["total_loss"])) and float(m["grad_norm"]) > 0

    def moved(name):
        return any(not torch.equal(a, b) for (_, a), (_, b) in zip(P.tree_items(st["params"][name]),
                                                                     P.tree_items(before[name])))

    assert moved("projector_2d") and not moved("vision_tower_2d")
    assert moved("llm_backbone") == (stage == "finetune")
    if stage == "align":
        st, m = step(st, vlm_batch(stage, False))
        assert float(m["grad_norm"]) == 0 and not moved("llm_backbone")


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #


def vlm_argv(tmp_path, stage, *extra):
    return ["--device", "cpu", "--vlm_stage", stage, "--model", "mla-tiny", "--max_steps", "2",
            "--global_batch_size", "8", "--vlm_max_length", "48", "--run_root_dir", str(tmp_path),
            "--run_id", f"vlm-{stage}", *extra]


@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_cli_vlm_stage(tmp_path, stage):
    """python -m mla_tpu_torch.train --vlm_stage ...: two steps of the
    synthetic data (a multimodal and a language-only batch: 6 examples of
    each at a global batch of 8), metrics written, one checkpoint."""
    out = train.main(vlm_argv(tmp_path, stage))
    assert sorted(out["multimodal"]) == [False, True]
    losses = out["metrics"].windows["ar_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all() and min(losses) > 0
    run_dir = tmp_path / f"vlm-{stage}"
    rec = json.loads((run_dir / f"vlm-{stage}.jsonl").read_text().strip().splitlines()[-1])
    assert np.isfinite(rec["VLA Train/ar_loss"])
    assert [p.name[:11] for p in (run_dir / "checkpoints").glob("step-*")] == ["step-000002"]
    opt = out["state"]["optimizer"].state_dict()["leaves"]
    assert ("llm_backbone/layers/attn/q/w" in opt) == (stage == "finetune") and "projector_2d/layers/0/w" in opt


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An fp16 save_pretrained directory of a seeded tiny Llama, 2 shards."""
    from test_torch_hf_load import hf_llama, save_hf

    return save_hf(hf_llama(tconfig("mla-tiny")), tmp_path_factory.mktemp("hf") / "llama", torch.float16, True)


def _loaded(hf_dir, dtype):
    """JAX's load_hf_llama of the directory, cast to `dtype`, as tensors."""
    want = jconvert.load_hf_llama(hf_dir, jconfig("mla-tiny"))
    return P.tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(dtype), want)


def test_cli_hf_llama_dir_in_the_vla_loop(tmp_path, hf_dir):
    """--hf_llama_dir in the VLA loop: the built state's decoder is the
    files' (fp32 masters, the mean rows included), and it trains."""
    argv = ["--vla.type", "mla-tiny-debug", "--device", "cpu", "--run_root_dir", str(tmp_path), "--max_steps", "1",
            "--hf_llama_dir", str(hf_dir)]
    built = train.build(argv)
    assert built["hf_load"]["bytes_read"] > 0
    for (path, got), (_, want) in zip(P.tree_items(built["state"]["params"]["llm_backbone"]),
                                      P.tree_items(_loaded(hf_dir, torch.float32))):
        assert got.dtype == torch.float32 and torch.equal(got, want), path
    out = train.main(argv)
    assert np.isfinite(out["metrics"].windows["total_loss"][0])


def test_cli_hf_llama_dir_in_the_vlm_loop(tmp_path, hf_dir):
    """--vlm_stage align --hf_llama_dir: the loaded decoder (mla-tiny's
    fp32) stays the files' through two align steps."""
    out = train.main(vlm_argv(tmp_path, "align", "--hf_llama_dir", str(hf_dir)))
    for (path, got), (_, want) in zip(P.tree_items(out["state"]["params"]["llm_backbone"]),
                                      P.tree_items(_loaded(hf_dir, torch.float32))):
        assert torch.equal(got, want), path
    assert out["hf_load"]["dir_bytes"] > out["hf_load"]["bytes_read"] > 0
