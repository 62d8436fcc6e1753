"""DreamLLM sample builder: typed samples → token ids, labels, pixel arrays,
and the span-position arrays the static-shape forward consumes.

TPU-native re-design of the reference's `DreamLLMDataset.__getitem__` +
collators (omni/data/builders/builder_dreamllm.py:63-504). Semantics ported,
representation changed: instead of leaving ``<im_patch>`` runs for the model
to find at runtime (torch.cat splice loops), the builder emits explicit
``image_positions``/``dream_positions`` start offsets so the model forward is
one static scatter (models/dreamllm.py).

Span conventions (reference :110-128):
  image span = <im_start> + image_embed_len×<im_patch> + <im_end>
  dream span = <dream_start> + n_dream_queries×<im_patch> + <dream_end>

Label semantics ported exactly:
  * ImageTextPair, i2t: caption + eos learnable, image span masked (:190-208)
  * ImageTextPair, t2i: ALL LM labels ignored — pure diffusion sample (:209-225)
  * Interleaved: text learnable; every special/patch token masked EXCEPT
    <dream_start>, which is how the model learns WHEN to emit an image
    (:284-288); each image contributes a creation target (images_dm) AND
    comprehension context (CLIP input) via dream_ids + image_ids (:264)
  * Conversation: only assistant turns learnable (vicuna turn masking
    :358-433, via structured segments instead of token-count offsets)

A copy of ``dreamllm_tpu/data/builder.py``; ``CLIP_IMAGE_MEAN``/``STD`` and
``SpecialTokens`` come from the port's ``models/clip.py`` and
``models/dreamllm.py``."""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np

from dreamllm_tpu_torch.data.conversation import TEMPLATES, render_conversation, render_prompt
from dreamllm_tpu_torch.data.dataset_types import (
    ConversationSample,
    ImageImagePair,
    ImageTextPair,
    InstructInterleavedImageText,
    InterleavedImageText,
    Message,
    TextOnly,
    VideoTextPair,
)
from dreamllm_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from dreamllm_tpu_torch.models.dreamllm import SpecialTokens

IGNORE = -100
IMAGE_PLACEHOLDER = "<image>"


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...  # no bos/eos added


@dataclasses.dataclass(frozen=True)
class BuilderConfig:
    max_seq_len: int = 2048
    image_embed_len: int = 256
    n_dream_queries: int = 64
    special: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    max_images: int = 6          # per-sample caps (2048 tokens fit ~6 image spans)
    max_dreams: int = 5
    i2t_probability: float = 0.5  # ImageTextPair coin flip (reference :190)
    conv_template: str = "vicuna_v1.1"
    # creation / comprehension toggles (stage-1 configs train only one side)
    use_creation: bool = True
    use_comprehension: bool = True
    image_size: int = 224        # CLIP input
    image_size_dm: int = 256     # diffusion target (512 for SD at full res)


@dataclasses.dataclass
class BuiltSample:
    input_ids: np.ndarray        # [S] int32
    labels: np.ndarray           # [S] int32, IGNORE where masked
    images: list                 # CLIP inputs (HWC float, CLIP mean/std normalized)
    image_positions: list[int]
    images_dm: list              # diffusion targets (HWC float in [-1,1])
    dream_positions: list[int]
    # SDXL micro-conditioning per dream image: [orig_h, orig_w, crop_t,
    # crop_l, target_h, target_w] (reference SDXLDataProcessor :14-44)
    add_time_ids: list = dataclasses.field(default_factory=list)


def _to_float01(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    elif arr.ndim == 3 and arr.shape[-1] == 4:
        # RGBA (common in scraped PNG shards): composite over white like the
        # reference's PIL convert path — dropping alpha leaves transparent
        # regions as arbitrary RGB noise
        rgb, a = arr[..., :3], arr[..., 3:4]
        arr = rgb * a + (1.0 - a)
    elif arr.ndim == 3 and arr.shape[-1] == 2:  # LA
        l, a = arr[..., :1], arr[..., 1:2]
        arr = np.repeat(l * a + (1.0 - a), 3, axis=-1)
    return arr.astype(np.float32)


def _resize_hwc(arr: np.ndarray, size: int) -> np.ndarray:
    """Host-side nearest resize for ragged inputs; fine-grained bicubic
    resizing happens on device (clip_preprocess)."""
    h, w = arr.shape[:2]
    if h == size and w == size:
        return arr
    yi = (np.arange(size) * (h / size)).astype(np.int64).clip(0, h - 1)
    xi = (np.arange(size) * (w / size)).astype(np.int64).clip(0, w - 1)
    return arr[yi][:, xi]


class DreamLLMBuilder:
    def __init__(self, tokenizer: Tokenizer, cfg: BuilderConfig, seed: int = 0):
        self.tok = tokenizer
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    # ---- span id helpers (reference :110-128) ----
    def image_ids(self) -> list[int]:
        st = self.cfg.special
        return [st.im_start] + [st.im_patch] * self.cfg.image_embed_len + [st.im_end]

    def dream_ids(self) -> list[int]:
        st = self.cfg.special
        return [st.dream_start] + [st.im_patch] * self.cfg.n_dream_queries + [st.dream_end]

    def _img(self, image) -> np.ndarray:
        # CLIP mean/std normalization here so the TRAIN path feeds the frozen
        # CLIP tower the same distribution as the inference paths, which go
        # through clip_preprocess (reference normalizes in its builder via
        # CLIPImageProcessor.preprocess).
        arr = _resize_hwc(_to_float01(image), self.cfg.image_size)
        mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
        std = np.asarray(CLIP_IMAGE_STD, np.float32)
        return (arr - mean) / std

    def _img_dm(self, image) -> np.ndarray:
        return _resize_hwc(_to_float01(image), self.cfg.image_size_dm) * 2.0 - 1.0

    def _time_ids(self, image) -> np.ndarray:
        """SDXL micro-conditioning for one diffusion target."""
        arr = np.asarray(image)
        t = self.cfg.image_size_dm
        return np.asarray([arr.shape[0], arr.shape[1], 0, 0, t, t], np.float32)

    # ---- per-type builders ----

    def build(self, sample) -> BuiltSample:
        if isinstance(sample, BuiltSample):
            return sample  # pretokenized passthrough (reference
            # unified_it_pair_pretokenized_webdataset)
        if isinstance(sample, ImageTextPair):
            return self.build_pair(sample)
        if isinstance(sample, InstructInterleavedImageText):
            return self.build_instruct_interleaved(sample)
        if isinstance(sample, InterleavedImageText):
            return self.build_interleaved(sample)
        if isinstance(sample, ConversationSample):
            return self.build_conversation(sample)
        if isinstance(sample, TextOnly):
            return self.build_text(sample)
        if isinstance(sample, VideoTextPair):
            return self.build_video_pair(sample)
        if isinstance(sample, ImageImagePair):
            return self.build_ii_pair(sample)
        raise TypeError(f"unsupported sample type {type(sample)}")

    def build_ii_pair(self, s: ImageImagePair) -> BuiltSample:
        """Image→image: comprehend the source (image span), create the target
        (dream span). Layout: [bos] img_span [text] dream_span [eos] with ALL
        LM labels masked — ii-pair is a pure-creation sample whose loss comes
        from the diffusion head (reference builder_dreamllm.py:150-160:
        ``labels = [IGNORE_INDEX] * len(input_ids)``). The optional edit
        instruction text (absent from the reference's sample type) joins the
        input as conditioning only."""
        st = self.cfg.special
        ids: list[int] = [st.bos]
        img_span = self.image_ids()
        image_positions = [len(ids) + 1]
        ids += img_span
        t_ids = self.tok.encode(s.text) if s.text else []
        budget = self.cfg.max_seq_len - len(ids) - len(self.dream_ids()) - 1
        t_ids = t_ids[: max(budget, 0)]
        ids += t_ids
        d_span = self.dream_ids()
        dream_positions = [len(ids) + 1]
        ids += d_span
        ids.append(st.eos)
        labels = [IGNORE] * len(ids)
        return self._finish(
            ids, labels, [self._img(s.source)], image_positions,
            [self._img_dm(s.target)], dream_positions,
            time_ids=[self._time_ids(s.target)],
        )

    def build_video_pair(self, s: VideoTextPair) -> BuiltSample:
        """Video comprehension: each sampled frame becomes an image span
        before the caption (frames share one temporal caption — reference
        webvid handling; creation is not defined for video)."""
        st = self.cfg.special
        # cap the caption FIRST: requiring the full caption to fit before
        # admitting any frame would turn a long-caption sample into
        # zero-frame text about unseen video
        span_len = len(self.image_ids())
        max_cap = self.cfg.max_seq_len - 1 - span_len - 1  # bos + 1 frame + eos
        cap = self.tok.encode(s.text)[: max(max_cap, 0)]
        ids: list[int] = [st.bos]
        labels: list[int] = [IGNORE]
        images, image_positions = [], []
        for frame in list(s.frames)[: self.cfg.max_images]:
            span = self.image_ids()
            if len(ids) + len(span) + len(cap) + 1 > self.cfg.max_seq_len:
                break
            image_positions.append(len(ids) + 1)
            images.append(self._img(frame))
            ids += span
            labels += [IGNORE] * len(span)
        cap = cap[: self.cfg.max_seq_len - len(ids) - 1]
        ids += cap + [st.eos]
        labels += cap + [st.eos]
        return self._finish(ids, labels, images, image_positions, [], [])

    def build_text(self, s: TextOnly) -> BuiltSample:
        st = self.cfg.special
        ids = [st.bos] + self.tok.encode(s.text)[: self.cfg.max_seq_len - 2] + [st.eos]
        labels = list(ids)
        labels[0] = IGNORE
        return self._finish(ids, labels, [], [], [], [])

    def build_pair(self, s: ImageTextPair) -> BuiltSample:
        st = self.cfg.special
        i2t = self.rng.random() < self.cfg.i2t_probability
        if not self.cfg.use_creation:
            i2t = True
        if not self.cfg.use_comprehension:
            i2t = False
        cap = self.tok.encode(s.text)
        if i2t:
            # [bos] img_span caption [eos]; caption+eos learnable (:190-208)
            span = self.image_ids()
            budget = max(self.cfg.max_seq_len - 2 - len(span), 0)
            cap = cap[:budget]
            ids = [st.bos] + span + cap + [st.eos]
            labels = [IGNORE] * (1 + len(span)) + cap + [st.eos]
            img_pos = [2]  # after bos + im_start
            return self._finish(ids, labels, [self._img(s.image)], img_pos, [], [])
        # t2i: [bos] caption dream_span [eos]; all LM labels ignored (:209-225)
        span = self.dream_ids()
        budget = max(self.cfg.max_seq_len - 2 - len(span), 0)
        cap = cap[:budget]
        ids = [st.bos] + cap + span + [st.eos]
        labels = [IGNORE] * len(ids)
        dream_pos = [1 + len(cap) + 1]
        return self._finish(ids, labels, [], [], [self._img_dm(s.image)], dream_pos,
                            time_ids=[self._time_ids(s.image)])

    def build_interleaved(self, s: InterleavedImageText) -> BuiltSample:
        st = self.cfg.special
        return self._interleaved_body(s, [st.bos], [IGNORE])

    def build_instruct_interleaved(self, s: InstructInterleavedImageText) -> BuiltSample:
        """Instruction-prefixed interleaved doc (reference builder
        :290-356 + conversation_it_interleaved_dataset.py:87-101): the
        conversation prefix (system + USER: instruction + ASSISTANT:) is
        rendered from the template, and ALL its tokens are label-masked
        (:355-356 masks the first instruction_len labels); the interleaved
        document then follows with standard interleaved label semantics
        (text + <dream_start> learnable)."""
        st = self.cfg.special
        template = TEMPLATES[self.cfg.conv_template]
        prefix = render_prompt(template, [Message("user", s.instruction)])
        ids = [st.bos] + self.tok.encode(prefix)
        labels = [IGNORE] * len(ids)
        return self._interleaved_body(s, ids, labels)

    def _interleaved_body(self, s, ids: list[int], labels: list[int]) -> BuiltSample:
        st = self.cfg.special
        cfg = self.cfg
        # group images by their text anchor (reference :100-108 sorts by
        # matched_text_index and merges)
        by_chunk: dict[int, list[int]] = {}
        for i, idx in enumerate(s.matched_text_index):
            by_chunk.setdefault(int(idx), []).append(i)

        images, image_positions, images_dm, dream_positions = [], [], [], []
        time_ids = []

        for ci, text in enumerate(s.texts):
            t_ids = self.tok.encode(text)
            if len(ids) + len(t_ids) + 1 > cfg.max_seq_len:
                t_ids = t_ids[: max(cfg.max_seq_len - len(ids) - 1, 0)]
            ids += t_ids
            labels += t_ids  # text learnable
            for ii in by_chunk.get(ci, []):
                if len(images) >= cfg.max_images or len(images_dm) >= cfg.max_dreams:
                    continue
                d_span = self.dream_ids() if cfg.use_creation else []
                i_span = self.image_ids() if cfg.use_comprehension else []
                if len(ids) + len(d_span) + len(i_span) + 1 > cfg.max_seq_len:
                    continue
                if d_span:
                    # mask patches/end; keep <dream_start> learnable (:284-288)
                    dream_positions.append(len(ids) + 1)
                    images_dm.append(self._img_dm(s.images[ii]))
                    time_ids.append(self._time_ids(s.images[ii]))
                    ids += d_span
                    labels += [st.dream_start] + [IGNORE] * (len(d_span) - 1)
                if i_span:
                    image_positions.append(len(ids) + 1)
                    images.append(self._img(s.images[ii]))
                    ids += i_span
                    labels += [IGNORE] * len(i_span)
            if len(ids) >= cfg.max_seq_len - 1:
                break
        ids.append(st.eos)
        labels.append(st.eos)
        return self._finish(ids, labels, images, image_positions, images_dm,
                            dream_positions, time_ids=time_ids)

    def build_conversation(self, s: ConversationSample) -> BuiltSample:
        st = self.cfg.special
        cfg = self.cfg
        template = TEMPLATES[cfg.conv_template]
        segs = render_conversation(template, list(s.messages), s.system)

        # Exact path: tokenizers with char-offset support (HF fast) tokenize
        # each text-between-images as ONE string and mask labels by the char
        # spans of assistant segments — immune to tokens merging across turn
        # boundaries (the failure mode behind the reference's legacy-SPM
        # offset hacks, builder_dreamllm.py:383-397).
        if hasattr(self.tok, "encode_with_offsets"):
            return self._build_conversation_offsets(s, segs)

        ids: list[int] = [st.bos]
        labels: list[int] = [IGNORE]
        images, image_positions = [], []
        img_iter = iter(s.images)

        for seg in segs:
            parts = seg.text.split(IMAGE_PLACEHOLDER)
            for pi, part in enumerate(parts):
                if pi > 0:  # an <image> placeholder sat here (:29-60 expansion)
                    if len(images) < cfg.max_images:
                        span = self.image_ids()
                        if len(ids) + len(span) < cfg.max_seq_len:
                            image_positions.append(len(ids) + 1)
                            try:
                                images.append(self._img(next(img_iter)))
                            except StopIteration:
                                raise ValueError("more <image> placeholders than images")
                            ids += span
                            labels += [IGNORE] * len(span)
                if part:
                    t_ids = self.tok.encode(part)
                    room = cfg.max_seq_len - len(ids) - 1
                    t_ids = t_ids[: max(room, 0)]
                    ids += t_ids
                    labels += t_ids if seg.learnable else [IGNORE] * len(t_ids)
            if len(ids) >= cfg.max_seq_len - 1:
                break
        ids.append(st.eos)
        labels.append(st.eos if segs and segs[-1].learnable else IGNORE)
        return self._finish(ids, labels, images, image_positions, [], [])

    def _build_conversation_offsets(self, s: ConversationSample, segs) -> BuiltSample:
        st = self.cfg.special
        cfg = self.cfg
        # stitch segments into chunks split at <image> placeholders, tracking
        # learnable char ranges over each chunk
        chunks: list[tuple[str, list[tuple[int, int]]]] = []  # (text, learn spans)
        cur_text, cur_spans = "", []
        n_images_seen = 0
        for seg in segs:
            parts = seg.text.split(IMAGE_PLACEHOLDER)
            for pi, part in enumerate(parts):
                if pi > 0:
                    chunks.append((cur_text, cur_spans))
                    chunks.append(("<IMAGE>", []))
                    n_images_seen += 1
                    cur_text, cur_spans = "", []
                if part:
                    start = len(cur_text)
                    cur_text += part
                    if seg.learnable:
                        cur_spans.append((start, len(cur_text)))
        chunks.append((cur_text, cur_spans))
        if n_images_seen > len(s.images):
            raise ValueError("more <image> placeholders than images")

        ids: list[int] = [st.bos]
        labels: list[int] = [IGNORE]
        images, image_positions = [], []
        img_iter = iter(s.images)
        for text, spans in chunks:
            if text == "<IMAGE>":
                if len(images) >= cfg.max_images:
                    next(img_iter, None)
                    continue
                span = self.image_ids()
                if len(ids) + len(span) >= cfg.max_seq_len:
                    continue
                image_positions.append(len(ids) + 1)
                images.append(self._img(next(img_iter)))
                ids += span
                labels += [IGNORE] * len(span)
                continue
            if not text:
                continue
            t_ids, offsets = self.tok.encode_with_offsets(text)
            room = cfg.max_seq_len - len(ids) - 1
            t_ids, offsets = t_ids[:room], offsets[:room]
            for tid, (c0, c1) in zip(t_ids, offsets):
                # a token is learnable iff its char span overlaps a learnable
                # range (tokens straddling the boundary count as learnable,
                # matching the reference's inclusion of the sep in the loss)
                learn = any(c1 > a and c0 < b for a, b in spans)
                ids.append(tid)
                labels.append(tid if learn else IGNORE)
            if len(ids) >= cfg.max_seq_len - 1:
                break
        ids.append(st.eos)
        labels.append(st.eos if segs and segs[-1].learnable else IGNORE)
        return self._finish(ids, labels, images, image_positions, [], [])

    def _finish(self, ids, labels, images, image_positions, images_dm,
                dream_positions, time_ids=None):
        ids = np.asarray(ids[: self.cfg.max_seq_len], np.int32)
        labels = np.asarray(labels[: self.cfg.max_seq_len], np.int32)
        # never learn to predict raw patch/special placeholders except
        # <dream_start> (safety net mirroring :284-288)
        st = self.cfg.special
        banned = np.isin(labels, [st.im_patch, st.im_start, st.im_end, st.dream_end, st.image, st.dream])
        labels = np.where(banned, IGNORE, labels)
        return BuiltSample(
            input_ids=ids,
            labels=labels,
            images=images,
            image_positions=list(image_positions),
            images_dm=images_dm,
            dream_positions=list(dream_positions),
            add_time_ids=list(time_ids or []),
        )
