"""Map-style VLM-pretraining datasets (the LLaVA-era align and finetune
stages).

Counterpart of mla_tpu/vla/vlm_datasets.py, the port's own copy. The VLM
pretraining loop (train.train_vlm) reads a map-style dataset through
SplitModalitySampler and PaddedCollatorForLanguageModeling (vla/sampler.py).
The datasets follow the public LLaVA chat-json schema (a list of {"id",
"image"?, "conversations": [{"from": human|gpt, "value"}, ...]}), with
the two stage behaviours of the Prismatic lineage:

* **align**, the projector warm-up: the human prompt is dropped and the
  model predicts the caption from the image; the labels supervise the
  caption and EOS only (BOS is ignored, as the image block splices in
  right after it).
* **finetune**, multi-turn instruct tuning through the model family's
  PromptBuilder: human turns are ignored, gpt turns supervised. An example
  without an "image" key is language-only (pixel_values None); the
  collator and the sampler keep such examples in batches of their own.

`image_transform` defaults to the model's CLIP preprocessing (resize,
center crop, normalize, mask channel -> [4, S, S] float32), what
`prismatic.get_fused_tokens` expects. Images are read from disk by
`_load_image`, which decodes PNG, JPEG (what the LLaVA files hold), GIF,
BMP and WebP with the port's own decoders (vla/rlds/frames.py, JPEG with
Pillow's accurate IDCT), as Pillow's convert("RGB") gives them; any other
format raises (ROADMAP.md item 2). With
no data root the examples and frames are synthetic
(`synthetic_vlm_examples`), as in JAX.

Token ids come from any tokenizer on the repo's contract (`tok(text,
add_special_tokens=...)` -> {"input_ids": [...]} or an object with
.input_ids): the HF Llama tokenizer and SimpleTokenizer both qualify.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mla_tpu_torch.models.prompting import get_prompt_builder
from mla_tpu_torch.vla.datasets import add_mask_channel, clip_preprocess
from mla_tpu_torch.vla.tokenizer import EOS_ID

IGNORE_INDEX = -100


def _encode(tokenizer, text: str, add_special_tokens: bool = True) -> List[int]:
    out = tokenizer(text, add_special_tokens=add_special_tokens)
    ids = out["input_ids"] if isinstance(out, dict) else out.input_ids
    return list(ids)


def default_image_transform(image_size: int) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 [H, W, 3] -> CLIP-normalized [4, S, S] float32 (the mask
    channel all ones), the front_image format of the composed model."""

    def transform(img: np.ndarray) -> np.ndarray:
        return add_mask_channel(clip_preprocess(img, image_size))

    return transform


def _load_image(image_dir: Path, rel: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3], as Pillow's convert("RGB") gives
    it, through `vla/rlds/frames.decode`: PNG, JPEG (libjpeg-turbo's
    accurate integer IDCT, the one Pillow runs), GIF, BMP, WebP, TIFF (its
    first page; no compression, LZW, Deflate, PackBits, CCITT RLE, Group 3
    and 4, JPEG, LZMA), Netpbm, TGA, ICO, QOI, PCX and SGI. A format or TIFF
    codec that Pillow reads and the port does not (JPEG 2000, AVIF, DDS,
    PSD, EPS, TIFF's ZSTD and WebP, ...) raises NotImplementedError citing
    the ROADMAP item (frames.py's message, after the path); a stream Pillow
    refuses raises ValueError."""
    from mla_tpu_torch.vla.rlds import frames

    path = Path(image_dir) / rel
    data = path.read_bytes()
    try:
        return frames.decode(data, "pillow")
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None


class VLMAlignDataset:
    """The projector warm-up stage: predict the caption from the image."""

    def __init__(
        self,
        chat_json: Path,
        image_dir: Path,
        tokenizer,
        image_size: int = 672,
        image_transform: Optional[Callable] = None,
        examples: Optional[List[Dict[str, Any]]] = None,
        image_loader: Optional[Callable] = None,
    ) -> None:
        self.image_dir = Path(image_dir)
        self.tokenizer = tokenizer
        self.image_transform = image_transform or default_image_transform(image_size)
        self.image_loader = image_loader or _load_image
        if examples is None:
            with open(chat_json) as f:
                examples = json.load(f)
        self.examples = examples

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ex = self.examples[idx]
        conv = ex["conversations"]
        assert len(conv) == 2 and "<image>" not in conv[-1]["value"]
        caption = conv[-1]["value"].strip()
        ids = _encode(self.tokenizer, caption) + [EOS_ID]
        labels = list(ids)
        labels[0] = IGNORE_INDEX  # BOS: the image block splices in right after it
        item = {
            "input_ids": np.asarray(ids, np.int32),
            "labels": np.asarray(labels, np.int32),
            "pixel_values": None,
        }
        if "image" in ex:
            item["pixel_values"] = self.image_transform(self.image_loader(self.image_dir, ex["image"]))
        return item

    def get_modality_lengths(self, n_image_patches: int = 0) -> List[Tuple[bool, int]]:
        out = []
        for ex in self.examples:
            mm = "image" in ex
            n_words = sum(len(t["value"].replace("<image>", "").split()) for t in ex["conversations"])
            out.append((mm, n_image_patches + n_words if mm else n_words))
        return out


class VLMFinetuneDataset:
    """The instruct-tuning stage: a multi-turn dialog through the family's
    PromptBuilder; human turns ignored, gpt turns supervised; examples
    without an image are language-only."""

    def __init__(
        self,
        instruct_json: Path,
        image_dir: Path,
        tokenizer,
        model_family: str = "llama2-pure",
        image_size: int = 672,
        max_length: int = 2048,
        image_transform: Optional[Callable] = None,
        examples: Optional[List[Dict[str, Any]]] = None,
        image_loader: Optional[Callable] = None,
    ) -> None:
        self.image_dir = Path(image_dir)
        self.tokenizer = tokenizer
        self.model_family = model_family
        self.max_length = max_length
        self.image_transform = image_transform or default_image_transform(image_size)
        self.image_loader = image_loader or _load_image
        if examples is None:
            with open(instruct_json) as f:
                examples = json.load(f)
        self.examples = examples

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ex = self.examples[idx]
        builder = get_prompt_builder(self.model_family)
        ids: List[int] = []
        labels: List[int] = []
        for turn_idx, turn in enumerate(ex["conversations"]):
            msg = builder.add_turn(turn["from"], turn["value"].replace("<image>", "").strip())
            turn_ids = _encode(self.tokenizer, msg, add_special_tokens=turn_idx == 0)
            ids.extend(turn_ids)
            labels.extend([IGNORE_INDEX] * len(turn_ids) if turn_idx % 2 == 0 else turn_ids)
        ids = ids[: self.max_length]
        labels = labels[: self.max_length]
        item = {
            "input_ids": np.asarray(ids, np.int32),
            "labels": np.asarray(labels, np.int32),
            "pixel_values": None,
        }
        if "image" in ex:
            item["labels"][0] = IGNORE_INDEX
            item["pixel_values"] = self.image_transform(self.image_loader(self.image_dir, ex["image"]))
        return item

    def get_modality_lengths(self) -> List[Tuple[bool, int]]:
        return [("image" in ex, sum(len(t["value"].split()) for t in ex["conversations"])) for ex in self.examples]


def synthetic_vlm_examples(n_multimodal: int = 6, n_unimodal: int = 6, seed: int = 0, image_size: int = 672):
    """LLaVA-schema examples and an image loader for runs without data (the
    VLM pretraining path's counterpart of vla/dummy.py): the first
    `n_multimodal` examples have an image, drawn from a seeded generator
    when loaded."""
    rng = np.random.default_rng(seed)
    words = ["robot", "red", "table", "block", "move", "the", "scene", "shows"]
    examples = []
    for i in range(n_multimodal + n_unimodal):
        cap = " ".join(rng.choice(words, size=6))
        ex = {
            "id": f"dummy{i}",
            "conversations": [
                {"from": "human", "value": "Describe the image.\n<image>" if i < n_multimodal else "Say something."},
                {"from": "gpt", "value": cap},
            ],
        }
        if i < n_multimodal:
            ex["image"] = f"img{i}.jpg"
        examples.append(ex)

    def load_image(_dir, rel):
        i = int(Path(rel).stem[3:])
        r = np.random.default_rng(1000 + i)
        return r.integers(0, 255, (image_size, image_size, 3), np.uint8)

    return examples, load_image


def get_vlm_dataset_and_collator(
    stage: str,
    dataset_cfg,
    data_root_dir: Optional[str],
    tokenizer,
    model_family: str = "llama2-pure",
    image_size: int = 672,
    max_length: int = 2048,
    pad_token_id: int = 32000,
):
    """(dataset, collator) of a VLM pretraining stage from the dataset
    config's stage components under data_root_dir; data_root_dir=None
    gives the synthetic examples."""
    from mla_tpu_torch.vla.sampler import PaddedCollatorForLanguageModeling

    ann_rel, img_rel = dataset_cfg.components_for_stage("align" if stage in ("align", "vlm-align") else "finetune")
    examples = image_loader = None
    root = Path(data_root_dir) / dataset_cfg.dataset_root_dir if data_root_dir else Path(".")
    if data_root_dir is None:
        # synthetic: in-memory examples and generated frames, no disk reads
        examples, image_loader = synthetic_vlm_examples(image_size=image_size)

    kw: Dict[str, Any] = dict(tokenizer=tokenizer, image_size=image_size, examples=examples, image_loader=image_loader)
    if stage in ("align", "vlm-align"):
        ds = VLMAlignDataset(root / ann_rel, root / img_rel, **kw)
    else:
        ds = VLMFinetuneDataset(root / ann_rel, root / img_rel, model_family=model_family, max_length=max_length, **kw)
    return ds, PaddedCollatorForLanguageModeling(max_length=max_length, pad_token_id=pad_token_id)
