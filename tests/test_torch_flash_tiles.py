"""The flash backward kernel's tile-skip rule (``csrc/flash_bwd.cu``), in its
plain PyTorch form (``ops/attention.py`` ``segment_tile_ranges`` and
``flash_bwd_tile_pairs``): no pair that the attention mask keeps may lie in
a tile pair the rule skips, for packed, interleaved and padded layouts,
causal or not; and the rule does skip the 7B train batch's cross-segment
tiles."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dreamllm_tpu_torch.ops.attention import (
    BWD_TILE,
    _mask,
    bwd_tiles,
    flash_bwd_tile_pairs,
    segment_tile_ranges,
)

S2K = 2048
TRAIN_ROWS = [[1] * S2K, [1] * 1280 + [2] * (768 - 51) + [0] * 51]  # chip_smoke's 7B batch


def _layout(name: str) -> list[list[int]]:
    rng = np.random.default_rng(7)
    if name == "packed":
        return [[1] * 300 + [2] * 500 + [3] * 200 + [0] * 24,
                [1] * 700 + [2] * 300 + [0] * 24]
    if name == "interleaved":
        return [[1, 2] * 512, [3, 0, 3, 1] * 256]
    if name == "padding-tail":
        return [[1] * 300 + [2] * 400 + [0] * 300]
    if name == "padding-gap":  # a chunk of zeros between segments, and a zero head
        return [[0] * 70 + [1] * 130 + [0] * 200 + [2] * 600]
    if name == "ragged-unsorted":
        return [list(rng.integers(0, 4, 1000)), [5] * 600 + [2] * 400]
    if name == "train-7b":
        return TRAIN_ROWS
    raise KeyError(name)


# (query tile, key tile) of either pass at either head dim, and 64 x 64
TILES = sorted({t for d in (64, 128) for t in bwd_tiles(d)} | {(BWD_TILE, BWD_TILE)})


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("layout", ["packed", "interleaved", "padding-tail", "padding-gap",
                                    "ragged-unsorted", "train-7b"])
def test_no_kept_pair_in_a_skipped_tile(layout, tiles, causal):
    seg = torch.tensor(_layout(layout), dtype=torch.int32)
    b, s = seg.shape
    qt, kt = tiles
    keep = flash_bwd_tile_pairs(seg, seg, s, s, causal=causal, q_tile=qt, k_tile=kt)
    assert keep.shape == (b, -(-s // qt), -(-s // kt))
    mask = _mask(b, s, s, "cpu", causal, seg, seg)[:, 0, 0]  # [B, S, S]
    covered = keep.repeat_interleave(qt, 1).repeat_interleave(kt, 2)[:, :s, :s]
    assert not (mask & ~covered).any()


@pytest.mark.parametrize("causal", [False, True])
def test_no_segments_keeps_every_causal_tile(causal):
    keep = flash_bwd_tile_pairs(None, None, 1000, 1000, causal=causal)
    n = -(-1000 // BWD_TILE)
    assert keep.shape == (1, n, n)
    want = torch.ones((n, n), dtype=torch.bool)
    assert torch.equal(keep[0], want.tril() if causal else want)


def test_ranges_match_a_loop():
    seg = torch.tensor(_layout("ragged-unsorted") + _layout("padding-gap"), dtype=torch.int32)
    lo, hi, has_zero = segment_tile_ranges(seg, BWD_TILE)
    for b in range(seg.shape[0]):
        for c in range(lo.shape[1]):
            ids = seg[b, c * BWD_TILE:(c + 1) * BWD_TILE].tolist()
            nz = [i for i in ids if i != 0]
            assert bool(has_zero[b, c]) == (0 in ids)
            if nz:
                assert (lo[b, c].item(), hi[b, c].item()) == (min(nz), max(nz))
            else:
                assert lo[b, c] > hi[b, c]


@pytest.mark.parametrize("qt,kt", TILES)
def test_skips_the_train_batch_cross_segment_tiles(qt, kt):
    seg = torch.tensor(TRAIN_ROWS, dtype=torch.int32)
    keep = flash_bwd_tile_pairs(seg, seg, S2K, S2K, causal=True, q_tile=qt, k_tile=kt)
    # segment 2 (rows 1280-1996) starts a tile at every size: its query
    # tiles skip every key tile of segment 1
    assert not keep[1, 1280 // qt:, :1280 // kt].any()
    # row 0 is one segment: every causal tile pair stays
    causal_only = flash_bwd_tile_pairs(None, None, S2K, S2K, causal=True, q_tile=qt, k_tile=kt)
    assert torch.equal(keep[0], causal_only[0])
    # 12 x 20 of row 1's 528 causal 64 x 64 pairs dropped, whatever the tiles
    dropped = (causal_only[0] & ~keep[1]).sum().item() * qt * kt // BWD_TILE**2
    assert dropped == 240


def test_all_padding_tiles_are_skipped():
    seg = torch.tensor(_layout("padding-gap"), dtype=torch.int32)
    keep = flash_bwd_tile_pairs(seg, seg, 1000, 1000, causal=False)
    lo, hi, _ = segment_tile_ranges(seg)
    empty = (lo > hi)[0]
    assert empty.any()  # rows 256-383 hold only zeros
    assert not keep[0, empty, :].any() and not keep[0, :, empty].any()
