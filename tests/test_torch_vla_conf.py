"""The port's run registry (conf/vla.py) and the trainer's command line
against the JAX package's: every registry entry field for field, the
fields themselves (names, defaults, types), `stage` for every combination
of its flags, and the overrides that mla_tpu_torch.train parses and coerces
from a set of command lines against scripts/train.py's parse_args and
_coerce, including the ValueError for an unknown field."""

import dataclasses
import importlib.util
import itertools
from pathlib import Path

import pytest

from mla_tpu.conf import vla as jvla
from mla_tpu_torch import train as ttrain
from mla_tpu_torch.conf import vla as tvla

ROOT = Path(__file__).resolve().parent.parent


def _jax_train():
    spec = importlib.util.spec_from_file_location("jax_scripts_train", ROOT / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fields_match_jax():
    j = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(jvla.VLATrainConfig)]
    t = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(tvla.VLATrainConfig)]
    assert t == j


@pytest.mark.parametrize("vla_id", sorted(jvla.VLA_REGISTRY))
def test_registry_entry_matches_jax(vla_id):
    assert sorted(tvla.VLA_REGISTRY) == sorted(jvla.VLA_REGISTRY)
    assert dataclasses.asdict(tvla.get_vla_config(vla_id)) == dataclasses.asdict(jvla.get_vla_config(vla_id))
    over = {"max_steps": 3, "use_diff": False, "learning_rate": 1e-4}
    assert dataclasses.asdict(tvla.get_vla_config(vla_id, **over)) == dataclasses.asdict(
        jvla.get_vla_config(vla_id, **over))


def test_unknown_ids_and_fields_raise():
    for mod in (jvla, tvla):
        with pytest.raises(ValueError, match="Unknown VLA config"):
            mod.get_vla_config("no-such-run")
        with pytest.raises(ValueError, match="Unknown config overrides"):
            mod.get_vla_config("mla-tiny-debug", no_such_field=1)


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=3)),
                         ids=lambda f: "gen{}-freezevis{}-freezellm{}".format(*map(int, f)))
def test_stage_matches_jax(flags):
    kw = dict(zip(("use_generation", "freeze_vision_tower", "freeze_llm_backbone"), flags))
    want = jvla.get_vla_config("mla-tiny-debug", **kw).stage
    assert tvla.get_vla_config("mla-tiny-debug", **kw).stage == want
    assert want == ("post-training" if kw["use_generation"] else "finetune" if kw["freeze_vision_tower"]
                    else "pretrain")


ARGVS = [
    [],
    ["--vla.type", "mla-tiny-debug", "--max_steps", "2", "--save_interval", "2", "--run_root_dir", "/tmp/r"],
    ["--vla.type", "mla-tiny-debug", "--vla.per_device_batch_size", "1", "--global_batch_size", "8",
     "--use_contrastive", "false", "--is_resume", "true", "--learning_rate", "3e-4"],
    ["--model", "mla-2b", "--dp", "1", "--tp", "1", "--use_generation", "--gen_image", "TRUE",
     "--visualize_interval", "1", "--resume_step", "None", "--run_id", "abc", "--seed", "7"],
    ["--vla.type", "prism-dinosiglip-224px+oxe+diffusion", "--warmup_ratio", "0.05",
     "--lr_scheduler_type", "linear-warmup+cosine-decay", "--trackers", "jsonl,wandb", "--use_diff", "0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_cli_overrides_match_jax(argv):
    jtrain = _jax_train()
    jargs, jover = jtrain.parse_args(argv)
    targs, tover = ttrain.parse_args(argv + ["--device", "cpu"])
    assert tover == jover
    for k in ("vla_type", "model", "data_root_dir", "dp", "tp", "hf_llama_dir", "vlm_stage"):
        assert getattr(targs, k) == getattr(jargs, k), k
    assert targs.device == "cpu" and ttrain.parse_args(argv)[0].device == "cuda"
    jc = jtrain._coerce(jvla.VLATrainConfig, jover)
    tc = ttrain._coerce(tvla.VLATrainConfig, tover)
    assert tc == jc and [type(v) for v in tc.values()] == [type(v) for v in jc.values()]
    assert dataclasses.asdict(tvla.get_vla_config(targs.vla_type, **tc)) == dataclasses.asdict(
        jvla.get_vla_config(jargs.vla_type, **jc))


def test_unknown_override_raises_like_jax():
    jtrain = _jax_train()
    argv = ["--vla.type", "mla-tiny-debug", "--max_stepz", "3"]
    with pytest.raises(ValueError) as jerr:
        jtrain._coerce(jvla.VLATrainConfig, jtrain.parse_args(argv)[1])
    with pytest.raises(ValueError) as terr:
        ttrain._coerce(tvla.VLATrainConfig, ttrain.parse_args(argv)[1])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unexpected arg"):
        ttrain.parse_args(["stray"])
