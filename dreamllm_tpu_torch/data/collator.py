"""Batch collation: pad ids/labels, stack pixel arrays to fixed
[B, max_images, H, W, 3] buffers, pad position arrays with -1.

Replaces the reference collators (builder_dreamllm.py:467-504) which pad ids
and torch.cat ragged image lists; here absent spans become -1 positions that
the model's scatter drops, keeping every batch the same shape for jit.

A copy of ``dreamllm_tpu/data/collator.py`` with its imports pointed at the port."""

from __future__ import annotations

import numpy as np

from dreamllm_tpu_torch.data.builder import IGNORE, BuiltSample


def collate(
    samples: list[BuiltSample],
    *,
    pad_token_id: int = 0,
    max_images: int | None = None,
    max_dreams: int | None = None,
    seq_len: int | None = None,
    image_size: int = 224,
    image_size_dm: int = 256,
    image_embed_len: int = 256,
    n_dream_queries: int = 64,
) -> dict:
    b = len(samples)
    if seq_len is None or max_images is None or max_dreams is None:
        # batch-content-derived shapes (and conditionally absent image keys)
        # give every batch a new jit signature — fine for tests/one-offs,
        # minutes-per-shape recompiles in a jitted train loop
        from dreamllm_tpu_torch.utils.logging import warning_once

        warning_once(
            "collate() called without pinned seq_len/max_images/max_dreams — "
            "shapes (and pytree structure) will vary per batch, which forces "
            "jit recompiles; pass all three for a compiled training loop"
        )
    seq_len = seq_len or max(len(s.input_ids) for s in samples)
    max_images = max_images if max_images is not None else max(
        (len(s.images) for s in samples), default=0
    )
    max_dreams = max_dreams if max_dreams is not None else max(
        (len(s.images_dm) for s in samples), default=0
    )

    ids = np.full((b, seq_len), pad_token_id, np.int32)
    labels = np.full((b, seq_len), IGNORE, np.int32)
    seg = np.zeros((b, seq_len), np.int32)
    pos = np.zeros((b, seq_len), np.int32)

    images = np.zeros((b, max_images, image_size, image_size, 3), np.float32)
    image_positions = np.full((b, max_images), -1, np.int32)
    images_dm = np.zeros((b, max_dreams, image_size_dm, image_size_dm, 3), np.float32)
    dream_positions = np.full((b, max_dreams), -1, np.int32)
    # SDXL micro-conditioning (batched like the reference's SDXL collator,
    # builder_dreamllm.py:486-504); harmless default for non-SDXL heads
    add_time_ids = np.tile(
        np.asarray([image_size_dm, image_size_dm, 0, 0, image_size_dm, image_size_dm],
                   np.float32),
        (b, max_dreams, 1),
    )

    for i, s in enumerate(samples):
        n = min(len(s.input_ids), seq_len)
        ids[i, :n] = s.input_ids[:n]
        labels[i, :n] = s.labels[:n]
        seg[i, :n] = 1
        pos[i, :n] = np.arange(n)
        # a span is kept only if its TOKEN footprint ([im_start] + embed_len
        # patches + [im_end], i.e. p-1 .. p+embed_len) fits inside seq_len —
        # a partial span would scatter features past its region
        for j, (img, p) in enumerate(zip(s.images, s.image_positions)):
            if j >= max_images or p < 0 or p + image_embed_len + 1 > seq_len:
                continue
            images[i, j] = img
            image_positions[i, j] = p
        for j, (img, p) in enumerate(zip(s.images_dm, s.dream_positions)):
            if j >= max_dreams or p < 0 or p + n_dream_queries + 1 > seq_len:
                continue
            images_dm[i, j] = img
            dream_positions[i, j] = p
            tids = getattr(s, "add_time_ids", [])
            if j < len(tids) and tids[j] is not None:
                add_time_ids[i, j] = tids[j]

    out = {
        "input_ids": ids,
        "labels": labels,
        "segment_ids": seg,
        "positions": pos,
    }
    if max_images:
        out["images"] = images
        out["image_positions"] = image_positions
    if max_dreams:
        out["images_dm"] = images_dm
        out["dream_positions"] = dream_positions
        out["add_time_ids"] = add_time_ids
    return out


def pack_samples(
    samples: list[BuiltSample],
    seq_len: int,
    *,
    image_embed_len: int = 256,
    n_dream_queries: int = 64,
) -> list[BuiltSample]:
    """Greedy first-fit packing of short samples into ``seq_len`` rows.

    TPU-native efficiency feature the reference lacks (its 2048-token rows are
    mostly padding for short SFT samples): multiple samples share one row,
    separated by **segment ids** which the attention kernels already honor
    (ops/attention.py). Span positions shift with the packing offset. The
    packed BuiltSample accumulates per-sample ``(segment, position)`` via the
    ``segments`` attribute consumed by :func:`collate_packed`.
    """
    order = sorted(range(len(samples)), key=lambda i: -len(samples[i].input_ids))
    rows: list[list[int]] = []   # sample indices per row
    space: list[int] = []
    for i in order:
        n = len(samples[i].input_ids)
        if n > seq_len:
            rows.append([i])
            space.append(0)
            continue
        placed = False
        for r in range(len(rows)):
            if space[r] >= n:
                rows[r].append(i)
                space[r] -= n
                placed = True
                break
        if not placed:
            rows.append([i])
            space.append(seq_len - n)

    packed = []
    for row in rows:
        ids, labels, segs, poss = [], [], [], []
        images, image_positions, images_dm, dream_positions = [], [], [], []
        add_time_ids = []  # SDXL micro-conditioning travels with its image
        for s_idx, i in enumerate(row, start=1):
            s = samples[i]
            n = min(len(s.input_ids), seq_len - len(ids))
            if n <= 0:
                break
            off = len(ids)
            ids.extend(s.input_ids[:n].tolist())
            labels.extend(s.labels[:n].tolist())
            segs.extend([s_idx] * n)
            poss.extend(range(n))
            # keep a span only if its full TOKEN footprint survived the
            # truncation to n (p indexes the first patch token; the span ends
            # at p + embed_len inclusive, the <im_end>/<dream_end> token)
            for img, p in zip(s.images, s.image_positions):
                if p + image_embed_len + 1 <= n:
                    images.append(img)
                    image_positions.append(p + off)
            tids = list(getattr(s, "add_time_ids", []) or [])
            for j, (img, p) in enumerate(zip(s.images_dm, s.dream_positions)):
                if p + n_dream_queries + 1 <= n:
                    images_dm.append(img)
                    dream_positions.append(p + off)
                    # keep tids index-aligned with images_dm across mixed
                    # rows: None means "use the collate default"
                    add_time_ids.append(tids[j] if j < len(tids) else None)
        b = BuiltSample(
            input_ids=np.asarray(ids, np.int32),
            labels=np.asarray(labels, np.int32),
            images=images,
            image_positions=image_positions,
            images_dm=images_dm,
            dream_positions=dream_positions,
            add_time_ids=add_time_ids,
        )
        b.segments = np.asarray(segs, np.int32)       # type: ignore[attr-defined]
        b.positions = np.asarray(poss, np.int32)      # type: ignore[attr-defined]
        packed.append(b)
    return packed


def collate_packed(samples: list[BuiltSample], **kw) -> dict:
    """collate() honoring per-sample ``segments``/``positions`` from
    :func:`pack_samples`."""
    out = collate(samples, **kw)
    for i, s in enumerate(samples):
        segs = getattr(s, "segments", None)
        poss = getattr(s, "positions", None)
        if segs is not None:
            n = min(len(segs), out["segment_ids"].shape[1])
            out["segment_ids"][i, :n] = segs[:n]
            out["positions"][i, :n] = poss[:n]
    return out
