"""Typed dataset samples — the contracts between datasets and builders (a
copy of ``dreamllm_tpu/data/dataset_types.py``).

TPU-native equivalent of the reference's ReturnType dataclasses
(omni/data/manager/dataset_type.py:9-84). Images are numpy/PIL on the host;
everything device-bound is produced later by the builder/collator.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence


class DatasetType(str, enum.Enum):
    IMAGE_TEXT_PAIR = "image_text_pair"
    IMAGE_IMAGE_PAIR = "image_image_pair"
    INTERLEAVED_IMAGE_TEXT = "interleaved_image_text"
    CONVERSATION = "conversation"
    INSTRUCT_INTERLEAVED = "instruct_interleaved_image_text"
    TEXT_ONLY = "text_only"
    VIDEO_TEXT_PAIR = "video_text_pair"


@dataclasses.dataclass
class ImageTextPair:
    image: Any            # PIL.Image / np.ndarray HWC uint8
    text: str
    dataset_type: DatasetType = DatasetType.IMAGE_TEXT_PAIR


@dataclasses.dataclass
class InterleavedImageText:
    """MMC4/OBELICS-style document: text chunks + images anchored to chunks
    (reference dataset_type.py InterleavedImageText with matched_text_index)."""

    texts: Sequence[str]
    images: Sequence[Any]
    matched_text_index: Sequence[int]   # images[i] belongs after texts[idx[i]]
    matched_sim: Sequence[float] | None = None
    dataset_type: DatasetType = DatasetType.INTERLEAVED_IMAGE_TEXT


@dataclasses.dataclass
class InstructInterleavedImageText:
    """Instruction-prefixed interleaved doc — the SFT-stage data format
    (reference InstructInterleavedImageTextReturnType, dataset_type.py:60-62,
    built by builder_dreamllm.py:290-356): a conversation prefix rendered
    from ``instruction`` is fully label-masked, then the interleaved document
    follows as the assistant's answer with standard interleaved label
    semantics."""

    texts: Sequence[str]
    images: Sequence[Any]
    matched_text_index: Sequence[int]
    instruction: str = ""
    matched_sim: Sequence[float] | None = None
    dataset_type: DatasetType = DatasetType.INSTRUCT_INTERLEAVED


@dataclasses.dataclass
class ImageImagePair:
    """Source→target image pair (reference unified_ii_pair_webdataset —
    variation/edit training: comprehend the source, create the target)."""

    source: Any
    target: Any
    text: str = ""
    dataset_type: DatasetType = DatasetType.IMAGE_IMAGE_PAIR


@dataclasses.dataclass
class Message:
    role: str            # "system" | "user" | "assistant"
    content: str         # may contain "<image>" placeholders


@dataclasses.dataclass
class ConversationSample:
    messages: Sequence[Message]
    images: Sequence[Any] = ()
    system: str | None = None
    dataset_type: DatasetType = DatasetType.CONVERSATION


@dataclasses.dataclass
class TextOnly:
    text: str
    dataset_type: DatasetType = DatasetType.TEXT_ONLY


@dataclasses.dataclass
class VideoTextPair:
    """Sampled video frames + caption (reference webvid_vt_pair_dataset)."""

    frames: Sequence[Any]   # [T] HWC arrays
    text: str
    dataset_type: DatasetType = DatasetType.VIDEO_TEXT_PAIR
