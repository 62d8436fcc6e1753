"""Data-quality filter stack + shard-list expansion for web-scale corpora.

TPU-host-side equivalent of the reference's webdataset select() filters
(omni/data/datasets/unified_it_pair_webdataset.py:15-67: caption blacklist,
non-English reject, URL-in-caption reject, min-size) and the OBELICS
pickle-index shard expansion (omni/data/constants.py:23-36). Filters here
operate on the DECODED sample dict produced by webdataset.default_decoder
({"image": HWC uint8 array, "txt": str, "json": dict, ...}), composing with
``ShardStream(filters=[...])``.

A copy of ``dreamllm_tpu/data/filters.py`` with its imports pointed at the port."""

from __future__ import annotations

import pickle
import re
from typing import Callable, Sequence

Sample = dict
Filter = Callable[[Sample], bool]


# Watermark/boilerplate caption fragments that mark low-quality alt-text in
# web-crawled pair corpora (same intent as the reference's blacklist,
# unified_it_pair_webdataset.py:17-25: stock-photo credits, file extensions,
# spam/boilerplate markers; the reference list also carries Chinese-corpus
# entries that the non-English filter below already covers).
DEFAULT_CAPTION_BLACKLIST: tuple[str, ...] = (
    "image unavailable",
    "no caption",
    "stock photo",
    "stock image",
    "getty",
    "shutterstock",
    "alamy",
    "istock",
    "dreamstime",
    "123rf",
    "depositphotos",
    "copyright",
    "royalty free",
    "royalty-free",
    "click to enlarge",
    "click here",
    "thumbnail",
    ".jpg",
    ".jpeg",
    ".png",
    ".gif",
    ".tiff",
    ".svg",
    ".pdf",
    ".com",
    "@",
)

_NON_ASCII = re.compile(r"[^\x00-\x7F]")
_URL = re.compile(r"https?://\S+|www\.\S+")


def _caption(sample: Sample) -> str:
    return sample.get("txt") or ""


def has_caption_and_image(sample: Sample) -> bool:
    """Reject pairs missing either modality (reference
    filter_no_caption_or_no_image, :55-56)."""
    return bool(_caption(sample).strip()) and sample.get("image") is not None


def caption_blacklist(
    words: Sequence[str] = DEFAULT_CAPTION_BLACKLIST,
) -> Filter:
    """Reject captions containing any blacklisted fragment (case-insensitive;
    reference filter_caption_with_blacklist_words, :15-30)."""
    lowered = tuple(w.lower() for w in words)

    def f(sample: Sample) -> bool:
        cap = _caption(sample).lower()
        return not any(w in cap for w in lowered)

    return f


def english_only(sample: Sample) -> bool:
    """Reject captions containing non-ASCII characters (reference
    filter_caption_with_only_non_en_words, :33-39)."""
    return not _NON_ASCII.search(_caption(sample))


def no_urls(sample: Sample) -> bool:
    """Reject captions containing URLs (reference filter_url_caption,
    :42-48)."""
    return not _URL.search(_caption(sample))


def min_image_size(min_side: int) -> Filter:
    """Reject images whose min(H, W) <= min_side (reference filter_size,
    :66-68 — which the reference gates behind min_size>0 due to a batch-size
    bug; our static-shape collator has no such constraint)."""

    def f(sample: Sample) -> bool:
        img = sample.get("image")
        if img is None:
            return False
        h, w = img.shape[:2]
        return min(h, w) > min_side

    return f


def quality_filters(
    *,
    blacklist: Sequence[str] | None = DEFAULT_CAPTION_BLACKLIST,
    require_english: bool = True,
    reject_urls: bool = True,
    min_side: int = 0,
) -> list[Filter]:
    """The reference's full pair-corpus filter stack, in its order
    (unified_it_pair_webdataset.py:93-149). Pass to
    ``ShardStream(filters=quality_filters())``."""
    fs: list[Filter] = [has_caption_and_image]
    if blacklist:
        fs.append(caption_blacklist(blacklist))
    if require_english:
        fs.append(english_only)
    if reject_urls:
        fs.append(no_urls)
    if min_side > 0:
        fs.append(min_image_size(min_side))
    return fs


# ---------------------------------------------------------------------------
# Shard-list expansion
# ---------------------------------------------------------------------------


def expand_pickle_index(index_paths: Sequence[str]) -> tuple[list[str], int]:
    """OBELICS-style shard index: each ``.pkl`` holds a list of
    ``{"url": shard_url, "nsamples": int}`` records. Returns the flat shard
    URL list and the exact total sample count (reference
    get_shard_list_and_size_from_index, omni/data/constants.py:23-33)."""
    shard_list: list[str] = []
    total = 0
    for path in index_paths:
        from dreamllm_tpu_torch.data.webdataset import open_stream

        with open_stream(path) as f:
            for rec in pickle.load(f):
                shard_list.append(rec["url"])
                total += int(rec["nsamples"])
    return shard_list, total
