"""Dataset catalog: registered factories for the corpora the reference trains
on (omni/data/constants.py:44-232 — laion400m/laion-coco/blip-laion/mmc4
/obelics/llava-instruct/...), plus synthetic datasets for offline smoke runs.

Real datasets resolve shard paths under ``$DREAMLLM_DATA_ROOT`` and stream
via data/webdataset.py; registration is lazy, so missing data only fails when
a dataset is actually built.

A copy of ``dreamllm_tpu/data/catalog.py`` with its imports pointed at the port."""

from __future__ import annotations

import glob
import os

import numpy as np

from dreamllm_tpu_torch.data.dataset_types import (
    ConversationSample,
    ImageImagePair,
    ImageTextPair,
    InstructInterleavedImageText,
    InterleavedImageText,
    Message,
    VideoTextPair,
)
from dreamllm_tpu_torch.data.registry import register_dataset
from dreamllm_tpu_torch.data.webdataset import IterableAsMapStyle, ShardStream

DATA_ROOT_ENV = "DREAMLLM_DATA_ROOT"


def _stream_kw(kw: dict) -> dict:
    """Restrict mixed-run build kwargs to what ShardStream accepts: the
    DataManager hands ONE kwargs dict to every dataset in a mix, so
    kind-specific options of sibling datasets must be ignored here."""
    import inspect

    allowed = set(inspect.signature(ShardStream.__init__).parameters) - {"self"}
    return {k: v for k, v in kw.items() if k in allowed}


def _natkey(name: str):
    """Numeric-aware sort key: 'image_2' before 'image_10' (lexicographic
    order misaligns images with matched_text_index for 10+ image docs)."""
    import re

    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]


def _shards(subdir: str) -> list[str]:
    """Resolve a corpus subdir to a shard URL list. Three layouts:

      * ``{root}/{subdir}/*.tar`` — local tar shards
      * ``{root}/{subdir}/*.pkl`` — pickle shard indexes (OBELICS-style:
        records of {"url", "nsamples"}; urls may be remote — reference
        omni/data/constants.py:23-36)
      * ``{root}/{subdir}.shards`` — text file, one shard URL per line
        (file:// http:// pipe: s3:// gs:// all stream via
        webdataset.open_stream — replaces megfile/gopen object-store access)
    """
    root = os.environ.get(DATA_ROOT_ENV)
    if not root:
        raise RuntimeError(
            f"set ${DATA_ROOT_ENV} to the dataset root to use real datasets"
        )
    shards = sorted(glob.glob(os.path.join(root, subdir, "*.tar")))
    if shards:
        return shards
    indexes = sorted(glob.glob(os.path.join(root, subdir, "*.pkl")))
    if indexes:
        from dreamllm_tpu_torch.data.filters import expand_pickle_index

        shards, _ = expand_pickle_index(indexes)
        return shards
    listing = os.path.join(root, f"{subdir}.shards")
    if os.path.exists(listing):
        with open(listing) as f:
            shards = [l.strip() for l in f if l.strip() and not l.startswith("#")]
        if shards:
            return shards
    raise RuntimeError(f"no shards under {root}/{subdir}")


def _pair_wds(subdir: str, size: int):
    def factory(quality: bool = True, min_side: int = 0,
                json_caption_key: str | None = None, **kw):
        from dreamllm_tpu_torch.data.filters import has_caption_and_image, quality_filters
        from dreamllm_tpu_torch.data.webdataset import default_decoder

        filters = (
            quality_filters(min_side=min_side) if quality else [has_caption_and_image]
        )

        def decoder(raw):
            s = default_decoder(raw)
            # caption stored in a json sidecar under a configurable key
            # (reference json_caption_key, unified_it_pair_webdataset.py:89-92)
            if json_caption_key and not s.get("txt") and isinstance(s.get("json"), dict):
                s["txt"] = s["json"].get(json_caption_key, "")
            return s

        stream = ShardStream(
            _shards(subdir),
            decoder=decoder,
            map_fn=lambda s: ImageTextPair(image=s["image"], text=s.get("txt", "")),
            filters=filters,
            **_stream_kw(kw),
        )
        return IterableAsMapStyle(stream, size)

    return factory


def _interleaved_wds(subdir: str, size: int):
    def factory(**kw):
        def to_sample(s):
            meta = s["json"]
            return InterleavedImageText(
                texts=meta.get("text_list", meta.get("texts", [])),
                images=[s[k] for k in sorted(s, key=_natkey) if k.startswith("image")],
                matched_text_index=meta.get("matched_text_index", []),
                matched_sim=meta.get("matched_sim"),
            )

        stream = ShardStream(_shards(subdir), map_fn=to_sample,
                             filters=[lambda s: "json" in s], **_stream_kw(kw))
        return IterableAsMapStyle(stream, size)

    return factory


def _instruct_interleaved_wds(subdir: str, size: int):
    """SFT-format shards: interleaved doc + an ``instruction`` field
    (reference conversation_it_interleaved_dataset.py)."""

    def factory(**kw):
        def to_sample(s):
            meta = s["json"]
            return InstructInterleavedImageText(
                texts=meta.get("text_list", meta.get("texts", [])),
                images=[s[k] for k in sorted(s, key=_natkey) if k.startswith("image")],
                matched_text_index=meta.get("matched_text_index", []),
                matched_sim=meta.get("matched_sim"),
                instruction=meta.get("instruction", ""),
            )

        stream = ShardStream(_shards(subdir), map_fn=to_sample,
                             filters=[lambda s: "json" in s], **_stream_kw(kw))
        return IterableAsMapStyle(stream, size)

    return factory


def _ii_pair_wds(subdir: str, size: int):
    """Image→image shards (reference unified_ii_pair_webdataset: the same
    image serves as comprehension source and creation target unless the
    sample carries an explicit second image under a ``target`` key)."""

    def factory(**kw):
        def to_sample(s):
            imgs = [s[k] for k in sorted(s, key=_natkey) if k.startswith(("image", "source", "target"))]
            src = imgs[0]
            tgt = imgs[1] if len(imgs) > 1 else imgs[0]
            return ImageImagePair(source=src, target=tgt, text=s.get("txt", ""))

        stream = ShardStream(
            _shards(subdir), map_fn=to_sample,
            filters=[lambda s: any(k.startswith(("image", "source")) for k in s)], **_stream_kw(kw),
        )
        return IterableAsMapStyle(stream, size)

    return factory


def _webvid_json(subdir: str, size: int, num_frames: int = 8):
    """WebVid-style video-text pairs (reference WebVidDatasetInfo +
    webvid_vt_pair_dataset: json shard files listing {videoid, name/caption},
    videos under a sibling directory; frames sampled at load)."""

    def factory(**kw):
        import json

        root = os.environ.get(DATA_ROOT_ENV, "")
        meta = []
        for p in sorted(glob.glob(os.path.join(root, subdir, "*.json"))):
            with open(p) as f:
                meta += json.load(f)
        if not meta:  # fail fast like the shard factories (_shards)
            raise RuntimeError(f"no webvid json metadata under {root}/{subdir}")
        video_dir = os.path.join(root, subdir, "videos")

        class WebVid:
            def __len__(self):
                return len(meta)

            def __getitem__(self, i):
                from dreamllm_tpu_torch.utils.video import sample_video_frames

                row = meta[int(i) % len(meta)]
                path = os.path.join(video_dir, f"{row['videoid']}.mp4")
                frames = sample_video_frames(path, num_frames=num_frames)
                return VideoTextPair(frames=frames, text=row.get("name", row.get("caption", "")))

        return WebVid()

    return factory


def _conversation_json(subdir: str, size: int):
    def factory(**kw):
        import json

        root = os.environ.get(DATA_ROOT_ENV, "")
        path = os.path.join(root, subdir)
        with open(path) as f:
            raw = json.load(f)

        class Conv:
            def __len__(self):
                return len(raw)

            def __getitem__(self, i):
                item = raw[i]
                msgs = [
                    Message("user" if m["from"] in ("human", "user") else "assistant",
                            # normalize placeholder whitespace ("<image>\n..."
                            # in llava-instruct json) so the split on <image>
                            # doesn't leave stray newlines in the prompt
                            m["value"].replace("<image>\n", "<image>")
                                      .replace("\n<image>", "<image>"))
                    for m in item["conversations"]
                ]
                images = []
                if "image" in item:
                    from PIL import Image

                    images = [np.asarray(Image.open(
                        os.path.join(root, "images", item["image"])).convert("RGB"))]
                return ConversationSample(messages=msgs, images=images)

        return Conv()

    return factory


# --- real corpora (full mirror of the reference registry,
#     omni/data/constants.py:43-232 DATASETS_INFO_TABLE) ---
for name, sub, size, kind in [
    # image-text pair webdatasets
    ("laion400m", "laion400m", 270_000_000, "pair"),
    ("laion400m_orig", "laion400m-orig", 20_000_000, "pair"),
    ("laion2b_en", "laion2b-en", 2_000_000_000, "pair"),
    ("laion_coco", "laion-coco", 104_900_000, "pair"),
    ("blip_laion", "blip-laion", 65_000_000, "pair"),
    ("journeydb", "journeydb", 2_370_000, "pair"),
    # image-image pair webdatasets (variation/edit training)
    ("laion_coco_ii", "laion-coco", 100_000_000, "ii_pair"),
    ("blip_laion_ii", "blip-laion", 65_000_000, "ii_pair"),
    # interleaved documents
    ("mmc4_core", "mmc4-core", 7_000_000, "interleaved"),
    ("obelics", "obelics", 113_000_000, "interleaved"),
    # SFT-format interleaved (ChatGPT-constructed; filtered224 variant)
    ("mmc4_instruct", "mmc4-instruct", 20_321, "instruct_interleaved"),
    ("mmc4_instruct_filtered224", "mmc4-instruct", 20_321, "instruct_interleaved"),
    # video-text
    ("webvid", "webvid", 10_700_000, "video"),
]:
    if kind == "pair":
        factory = _pair_wds(sub, size)
    elif kind == "ii_pair":
        factory = _ii_pair_wds(sub, size)
    elif kind == "instruct_interleaved":
        factory = _instruct_interleaved_wds(sub, size)
    elif kind == "video":
        factory = _webvid_json(sub, size)
    else:
        factory = _interleaved_wds(sub, size)
    register_dataset(name, factory, dataset_type=kind, approx_size=size)

# conversation-format instruction sets (reference JsonDatasetInfo entries)
for name, path, size in [
    ("llava_instruct", "llava_instruct_150k.json", 158_000),
    ("llava_instruct_filter", "llava_instruct_80k.json", 80_000),
    ("llavav1.5_instruct", "llava_v1_5_mix665k.json", 665_298),
    ("llava_pretrain", "blip_laion_cc_sbu_558k.json", 558_000),
    ("llava_pretrain_cc3m", "ccs_synthetic_filtered_large.json", 558_000),
    ("gqa", "gqa_sft_train_short_filtered.json", 13_532_530),
    ("instruct_blip_laion", "instruct_pair_blip_laion_22k.json", 22_000),
]:
    register_dataset(name, _conversation_json(path, size),
                     dataset_type="conversation", approx_size=size)

# HF-datasets pairs (reference HFITDatasetInfo entries)
register_dataset(
    "pokemon-gpt4-captions",
    lambda **kw: hf_it_pair_dataset("lambdalabs/pokemon-blip-captions", **kw),
    dataset_type="pair", approx_size=833,
)
register_dataset(
    "dalle3-by-laion",
    lambda **kw: hf_it_pair_dataset("laion/dalle-3-dataset", image_key="image",
                                    text_key="caption", **kw),
    dataset_type="pair", approx_size=13_020,
)


# --- additional dataset kinds (reference datasets/ variants) ---


def hf_it_pair_dataset(name_or_path: str, image_key="image", text_key="text",
                       split="train", size: int | None = None, **_):
    """HF `datasets` image-text pairs (reference hf_it_pair_dataset.py)."""
    import datasets as hfds

    ds = hfds.load_dataset(name_or_path, split=split)

    class HF:
        def __len__(self):
            return size or len(ds)

        def __getitem__(self, i):
            row = ds[int(i) % len(ds)]
            return ImageTextPair(image=np.asarray(row[image_key]), text=row[text_key])

    return HF()


def simple_it_pair_dataset(root: str, captions_json: str = "captions.json",
                           size: int | None = None, **_):
    """Folder of images + {filename: caption} json (reference
    simple_it_pair_dataset.py)."""
    import json

    with open(os.path.join(root, captions_json)) as f:
        table = sorted(json.load(f).items())

    class Simple:
        def __len__(self):
            return size or len(table)

        def __getitem__(self, i):
            from PIL import Image

            name, caption = table[int(i) % len(table)]
            img = np.asarray(Image.open(os.path.join(root, name)).convert("RGB"))
            return ImageTextPair(image=img, text=caption)

    return Simple()


def simple_text_only_dataset(path: str, size: int | None = None, **_):
    """One document per line (reference simple_hf_text_only_dataset.py)."""
    from dreamllm_tpu_torch.data.dataset_types import TextOnly

    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]

    class Text:
        def __len__(self):
            return size or len(lines)

        def __getitem__(self, i):
            return TextOnly(text=lines[int(i) % len(lines)])

    return Text()


register_dataset("hf_it_pair", hf_it_pair_dataset, dataset_type="pair")
register_dataset("simple_it_pair", simple_it_pair_dataset, dataset_type="pair")
register_dataset("simple_text_only", simple_text_only_dataset, dataset_type="text")


# --- synthetic datasets (offline smoke/testing) ---


def _synthetic_pairs(size: int = 64, image_size: int = 16, **_):
    class Synth:
        def __len__(self):
            return size

        def __getitem__(self, i):
            # index-seeded: map-style datasets must be call-order independent
            # (a resumed stream re-reads the same index and must see the same
            # sample)
            rng = np.random.default_rng((0, i))
            img = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
            return ImageTextPair(image=img, text=f"synthetic caption number {i % 17}")

    return Synth()


def _synthetic_interleaved(size: int = 64, image_size: int = 16, **_):
    class Synth:
        def __len__(self):
            return size

        def __getitem__(self, i):
            rng = np.random.default_rng((1, i))
            img = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
            return InterleavedImageText(
                texts=[f"doc {i} first chunk", "second chunk"],
                images=[img],
                matched_text_index=[0],
            )

    return Synth()


def _synthetic_instruct(size: int = 64, image_size: int = 16, **_):
    """Instruction-prefixed interleaved docs — the SFT-stage data format at
    toy scale (the synthetic counterpart of mmc4_instruct; reference
    InstructInterleavedImageTextReturnType)."""

    class Synth:
        def __len__(self):
            return size

        def __getitem__(self, i):
            rng = np.random.default_rng((2, i))
            img = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
            return InstructInterleavedImageText(
                texts=[f"an answer about item {i}", "with a follow-up"],
                images=[img],
                matched_text_index=[0],
                instruction=f"describe item {i % 13} with one picture",
            )

    return Synth()


def _synthetic_conversation(size: int = 64, image_size: int = 16, **_):
    """Vicuna-style multimodal conversations at toy scale (the synthetic
    counterpart of llava_instruct)."""

    class Synth:
        def __len__(self):
            return size

        def __getitem__(self, i):
            rng = np.random.default_rng((3, i))
            img = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
            return ConversationSample(
                messages=[
                    Message("user", f"<image>\nwhat is in sample {i}?"),
                    Message("assistant", f"sample {i} shows pattern {i % 7}."),
                ],
                images=[img],
            )

    return Synth()


register_dataset("synthetic_pairs", _synthetic_pairs, dataset_type="pair", approx_size=64)
register_dataset("synthetic_interleaved", _synthetic_interleaved,
                 dataset_type="interleaved", approx_size=64)
register_dataset("synthetic_instruct", _synthetic_instruct,
                 dataset_type="instruct_interleaved", approx_size=64)
register_dataset("synthetic_conversation", _synthetic_conversation,
                 dataset_type="conversation", approx_size=64)
