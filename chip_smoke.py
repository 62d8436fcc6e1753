"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --no-main  # environment, build and kernel checks only
    python3 chip_smoke.py --profile chiprun_out/profile  # + traced UNet and decode steps
    python3 chip_smoke.py --only entry_points  # build, then phase 10 alone
    python3 chip_smoke.py --only convert_eval  # build, then phase 11 alone

Phases, each on lines of its own; any failure exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every ``dreamllm_tpu_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each hand-written kernel (flash-attention forward and backward,
   fused 8-bit AdamW, w4a16 int4 matmul) against its plain PyTorch version
   on the card at the shapes the main paths give it, the SD-2.1 and SDXL
   UNets' included (the flash kernels and
   the int4 matmul also twice, for equal bits; the 8-bit AdamW also on a
   conv kernel, which its caller blocks in HWIO order, and on the float32
   factors of a LoRA adapter), timed beside the plain version, PyTorch's
   own library call where there is one, and the card's bound; and whether
   the int4 matmul gives each row of an 8-row call the bits of a 1-row one;
4. small reference: a tiny random DreamLLM document, an image-out chat
   turn, a text-to-image at DeepCache interval 2 (the tiny UNet's
   ``conv_out`` redrawn at its fan-in scale, so that the images depend on
   the UNet), a tiny train step and a
   tiny int4 decoder's ``generate_text`` (batch 1 and 8) and engine (4
   slots, 6 requests), and the same decoder with a LoRA adapter attached
   (``generate_text``, the engine with the prefix cache and an embeddings
   prompt, a micro-batching ``ModelServer``, one QLoRA step), the decoding
   variants on the int4 decoder (``beam_search``,
   ``generate_text_speculative``, the speculative engine) and a tiny
   ``run_vqa`` with 2 beams on the card agree with the same on the CPU;
5. main path, serving: a random full-width DreamLLM-7B + SD-2.1 (bf16,
   seeded, built on the card) writes one interleaved document with two
   512x512 images; then, on the same parameters with the UNet's
   ``conv_out`` redrawn at its fan-in scale, text-to-image as
   ``projects/dreamllm/inference.py`` makes it (``encode_prompt_embeds`` on
   the prompt and the negative prompt, timed alone, then ``sd_head_pipeline``
   with DDIM, 50 steps, guidance 3.5, 512x512, run twice at DeepCache
   interval 1 and twice at 2, the second run of each timed), the document
   again with its images at DeepCache interval 2, and one multimodal
   ``chat`` turn (one 224x224 image, 64 greedy tokens). The flash kernel's
   launches over each of these runs are checked against the counts derived
   from the UNet's configuration (10 a full UNet forward, 5 a shallow one);
   then the model variants on the same decoder and CLIP tower:
   DreamLLM-SDXL-7B (196 dream queries, a 2-layer MLP projector, the SDXL
   head with its 2.6 B UNet in bf16 and its VAE in float32) writes the same
   document with two 1024x1024 images (``generate_interleaved`` picks
   ``sdxl_head_pipeline`` itself) and makes text-to-image (DDIM, 50 steps,
   guidance 5.0, 1024 px, twice, the second timed; K1 140 a CFG UNet
   forward: 70 self- and 70 cross-attentions over the 196 dream queries);
   the CLIP text tower at ViT-L/14's width encodes 4 prompts and scores
   them against the SDXL images (``clip_similarity``); three
   DreamLLM-SDXL stage-1 creation steps (dream queries and projectors only,
   batch 2 x 512, 1024 px); ControlNet on the SD-2.1 head
   (``controlnet_pipeline``, DDIM 50 steps, guidance 7.5, 512 px, a
   synthetic edge map; K1 14 a step) against ``sd_head_pipeline`` from the
   same start latents, at conditioning scale 1 and 0; and three LLaVA-1.5-7B
   stage-1 steps (the projector only, batch 2 x 2048, 336 px images);
6. main path, training: the same parameters take three joint train steps
   (LM + diffusion loss, CLIP/UNet/VAE frozen, 8-bit AdamW with the fused
   kernel, full remat) through ``Trainer.train`` at batch 2 x 2048; losses,
   updates, frozen parameters, the three kernels' launch counts and the one
   final checkpoint the trainer asks for (recorded, not written) are
   checked, and one full optimizer update is timed fused and unfused;
7. main path, quantized serving: DreamLLM-7B's decoder (bf16, seeded, built
   on the card) quantized to int4 group-128 layer by layer; ``generate_text``
   with a 128-token prompt and 128 greedy tokens at batch 1 and 8 (fused
   layout, bf16 cache) and at batch 8 on the int8 cache, then the
   continuous-batching engine with ``projects/dreamllm/serve.py``'s defaults
   (8 slots, unfused int4) answering 16 requests; the w4a16 kernel's launch
   count and one decode step's logits against its plain version are checked;
8. main path, decoding variants on that int4 decoder (unfused):
   ``generate_text_speculative`` at batch 1 (draft 7 and 8) in turns with
   ``generate_text``, ``beam_search`` with 4 beams at batch 1 and 2,
   ``run_vqa`` on 8 synthetic 224x224 samples (greedy at batch 8, 4 beams
   at batch 2) with DreamLLM-7B's CLIP tower, and the engine's per-slot
   speculation (adaptive, static, off) on 16 repetitive prompts and on a
   sparse mix; outputs are held to plain decode by a near-tie rule and the
   w4a16 kernel's launches to the count derived for each path;
9. main path, QLoRA and HTTP serving: a rank-8 LoRA adapter over that int4
   decoder takes three QLoRA steps at batch 2 x 2048 (8-bit AdamW on its
   float32 factors, lr 2e-4); then the adapter is served attached:
   ``generate_text`` beside the bare base, the engine with the prompt-prefix
   cache (16 requests under two 512-token system prompts, against the same
   engine without the cache) and embeddings prompts, and ``ModelServer`` on
   127.0.0.1 (``/health``, ``/generate`` with and without streaming,
   ``/logprob``, ``/chat`` with a 224x224 image through the engine's
   embeddings lanes), called through ``OnlineClient``;
10. entry points: the port's command-line entry points as users start them,
   on the recipes of ``projects/`` (random parameters from the recipes'
   seeds, ``tokenizer=toy``, bf16 by override), every model at full width:
   ``python -m dreamllm_tpu_torch.projects.dreamllm.serve`` on ``sft.py``
   at full depth in int4 as a subprocess (``/health``, 8 concurrent
   ``/generate`` each equal to the same prompt alone, ``/logprob``,
   ``/chat`` with a 224x224 image, exit within 30 s of SIGTERM); through
   ``main(argv)``: t2i (20 DPM steps) and an interleaved document on
   ``sft.py``, DreamLLM-SDXL t2i (10 steps, 1024 px) on its stage-1 recipe,
   3 train steps on ``stage1_creation.py`` cut to 4 layers (8-bit AdamW,
   its checkpoint written) and t2i from that checkpoint, and
   ``stable_diffusion/sample.py`` on SD-2.1 base (20 DPM steps). Each run's
   kernel launches equal the counts derived from its configuration;
11. conversion and evaluation (``convert_eval``): DreamLLM-7B's random
   weights written in the published layouts (Vicuna-7B safetensors, a
   4-layer ``.bin``, CLIP ViT-L/14 as ``CLIPVisionModel`` and ``CLIPModel``,
   SD-2.1 as a diffusers dir), converted by ``python -m
   dreamllm_tpu_torch.convert.cli`` (bf16 with the vocabulary grown to
   32064, and int4, side by side; walls and peak host RSS), both
   checkpoints held to their sources bit for bit, 32 greedy tokens from
   the int4 one equal to the
   on-card quantized tree's, ``stage1_creation.py`` trained 3 steps from
   ``pretrained.llm/clip/sd``, ``eval_t2i`` on ``sft.py`` and on the
   DreamLLM-SDXL recipe, the converted ``CLIPModel``'s similarity on the
   card against the CPU, and JPEG shards through ``device_prefetch``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

# Full float32 for float32 products and convolutions on the card (PyTorch's
# defaults differ: cuDNN convolutions would run in TF32). The package sets
# neither flag; the caller chooses. The JAX package's reference tests run
# float32 at "highest" precision, and the small reference phase compares
# the card with the CPU in float32. The bf16 main path uses neither.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version, both bf16 on the card, inputs N(0, 1). Both round
# the output to bf16, and the kernel rounds unnormalised probabilities to
# bf16 where the plain version rounds normalised ones, so an output may sit
# an ulp or so from the plain one at its own magnitude. The output limit
# therefore scales with each shape's reference: 4 bf16 ulps of its largest
# |value| (about 4e-3 at the UNet's S4096 shape, 8e-3 at S1024), capped at
# 2e-2. The cap binds only in the causal D128 sets, whose first rows
# average a handful of keys and reach 2-4, where one ulp is 1.56e-2. On
# top, the relative RMS error must stay within 1e-2, about three times
# what bf16 rounding on both sides gives (3e-3). Both limits reject the
# plain version with its last 64 keys dropped at the UNet shapes
# (tests/test_torch_ops.py::test_output_limits_reject_a_dropped_key_tile).
# The LSE is float32 in both, summed in another order and in base 2: 1e-3
# is far above that rounding.
OUT_ULPS = 4
OUT_TOL_CAP = 2e-2
OUT_REL_RMS = 1e-2
LSE_TOL = 1e-3

# Backward kernel vs plain version, both bf16 on the card from the same
# (q, k, v, dO, O, LSE). Both round P and dS to bf16 before their products
# and the results to bf16; the kernel takes P in base 2 and sums in tiles,
# so a P or dS may land on the neighbouring bf16 value, and a result an ulp
# or so from the plain one. A gradient has no fixed magnitude: the max-abs
# limit is 4 bf16 ulps of each reference's largest |value|, and the relative
# RMS error must stay within 2e-3: a bf16 rounding of every element would
# give 1.7e-3, and the two versions mostly land on the same bf16 value (the
# first runs on the card measured 0.6e-4 to 2.4e-4). Both limits reject a backward with one 64-row K/V tile dropped
# (tests/test_torch_ops.py::test_grad_limits_reject_a_dropped_kv_tile).
GRAD_ULPS = 4
GRAD_REL_RMS = 2e-3

# Fused 8-bit AdamW vs plain version, same state and gradient. The kernel
# rounds every intermediate as the op-by-op version does, so it should agree
# bit for bit; the limits leave room for a float32 scale one ulp off (1.2e-7
# relative; limit two ulps) and, where that ulp crosses a rounding boundary,
# a code off by one in at most 1 of 10^4 entries, never by more than one; the
# emitted update within one bf16 ulp of the reference's largest |value|.
ADAM_UPD_ULPS = 1.0
ADAM_SCALE_REL = 2.4e-7
ADAM_CODE_SHARE = 1e-4

# w4a16 kernel vs plain version, same bf16-rounded x and packed weight. Both
# multiply by exact small integers, sum the same products in float32 in
# different orders (float32 differences near 1e-7 relative), then round to
# the output dtype. A bf16 output may land on the neighbouring bf16 value:
# max-abs within 2 bf16 ulps of the reference's largest |value|, relative
# RMS within 2e-3. A float32 output (the 32000-wide head takes float32 x)
# keeps the float32 sums: max-abs within 1e-4 of the reference's largest
# |value|, far above float32 reordering and far below one group's share.
# Each limit rejects the plain version with one 128-row group dropped
# (tests/test_torch_quant4.py::test_w4_limits_reject_a_dropped_group).
W4_ULPS = 2
W4_REL_RMS = 2e-3
W4_F32_REL = 1e-4


def bf16_ulp(x: float) -> float:
    """Spacing of bfloat16 numbers at magnitude ``x`` (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def out_limit(want_max_abs: float) -> float:
    """Max-abs limit on a kernel's bf16 output, from its reference's peak."""
    return min(OUT_TOL_CAP, OUT_ULPS * bf16_ulp(want_max_abs))


def out_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max-abs error, its limit, relative RMS error) of ``got`` against
    the plain version's ``want``."""
    ref = want.float()
    diff = got.float() - ref
    return (diff.abs().max().item(), out_limit(ref.abs().max().item()),
            (diff.norm() / ref.norm()).item())


def w4_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max-abs error, its limit, relative RMS error) of the w4a16 kernel's
    output against its plain version's, by the output dtype (above)."""
    ref = want.float()
    diff = got.float() - ref
    peak = ref.abs().max().item()
    tol = W4_ULPS * bf16_ulp(peak) if want.dtype == torch.bfloat16 else W4_F32_REL * peak
    return diff.abs().max().item(), tol, (diff.norm() / ref.norm()).item()


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: its CUDA kernels' time, summed by
    ``torch.profiler`` over ``iters`` calls. Every kernel's ``ms``,
    ``plain_ms`` and ``library_ms`` is this time: unlike :func:`cuda_ms` it
    leaves out the host's launch overhead, which exceeds a small kernel's
    time on the card. Where three profiles in a row come back without
    device time, the time between CUDA events stands in (:func:`cuda_ms`,
    host launch cost included), and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then comes back without its kernels: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    log("[profile] torch.profiler recorded no device time in three profiles: "
        "CUDA-event time instead")
    return cuda_ms(fn, iters)


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, between two CUDA
    events: the larger of its device time and its host time a call. Every
    kernel's ``call_ms``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a card")
    line = gpu_line()
    log(f"[env] gpu: {line}")
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    from dreamllm_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    log(f"[env] nvcc: {nvcc}")
    return line


def phase_build() -> None:
    from dreamllm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    names = _build.build_all()
    log(f"[build] {names} in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for ln in text.splitlines():
            if any(w in ln.lower() for w in ("registers", "spill", "error", "warning")):
                log(f"[build] {name}: {ln.strip()}")


def _flash_case(name, b, hq, hkv, s, d, causal, with_lse, segments, gen, skv=None):
    """One shape set: kernel vs plain version, timings and bound. ``skv``:
    the key length where it differs from the query length ``s`` (a
    cross-attention)."""
    from dreamllm_tpu_torch.ops.attention import (
        flash_attention_cuda,
        flash_attention_reference,
    )

    dev = "cuda"
    skv = skv or s
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).bfloat16()
    seg = None
    if segments is not None:
        seg = torch.tensor(segments, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)

    def kernel():
        return flash_attention_cuda(q, k, v, seg, seg, causal=causal, sm_scale=scale,
                                    return_lse=with_lse)

    def plain():
        return flash_attention_reference(q, k, v, seg, seg, causal=causal, sm_scale=scale,
                                         return_lse=with_lse)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if with_lse:
        (got, got_lse), (again, again_lse), (want, want_lse) = got, again, want
        if not torch.equal(got_lse, again_lse):
            raise AssertionError(f"[kernels] {name}: two calls gave different LSE bits")
    if not torch.equal(got, again):
        raise AssertionError(f"[kernels] {name}: two calls gave different output bits")
    rows = torch.ones((b, s), dtype=torch.bool, device=dev) if seg is None else seg != 0
    err, tol, rel_rms = out_errors(got[rows], want[rows])
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"[kernels] {name}: output max-abs {err} > {tol}")
    if not rel_rms <= OUT_REL_RMS:
        raise AssertionError(f"[kernels] {name}: output relative RMS {rel_rms} > {OUT_REL_RMS}")
    lse_err = None
    if with_lse:
        lse_err = (got_lse - want_lse).abs().transpose(1, 2)[rows].max().item()
        if not math.isfinite(lse_err) or lse_err > LSE_TOL:
            raise AssertionError(f"[kernels] {name}: LSE max-abs {lse_err} > {LSE_TOL}")

    # the library yardstick: one SDPA call on BHSD views of the same data
    # (KV heads repeated for GQA outside the timed call)
    groups = hq // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
    mask = None
    keep = torch.ones((b, s, skv), dtype=torch.bool, device=dev)
    if causal:
        keep &= torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    if seg is not None:
        keep &= (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        mask = keep[:, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale)

    iters = 20
    ms = device_ms(kernel, iters)
    call_ms = cuda_ms(kernel, iters)
    plain_ms = device_ms(plain, 5)
    library_ms = device_ms(library, iters)

    # least time for this work: the (q, k) pairs this data keeps, 2 products
    # of 2*d flops each per pair and query head; bytes each read/written once
    pairs = int(keep.sum().item())
    flops = 4.0 * pairs * hq * d
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    nbytes += 4 * b * hq * s if with_lse else 0
    nbytes += 2 * 4 * seg.numel() if seg is not None else 0
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    log(f"[kernels] {name}: max_abs_err {err:.3e} (limit {tol:.3e}) rel_rms {rel_rms:.3e}"
        + (f" lse_err {lse_err:.3e}" if lse_err is not None else "")
        + f"  kernel {ms:.4f} ms (call {call_ms:.4f} ms)  plain {plain_ms:.4f} ms"
        f"  sdpa {library_ms:.4f} ms"
        f"  bound {bound_ms * 1e3:.2f} us ({bound_by}, {flops / 1e9:.2f} GFLOP)"
        f"  {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {"shape": name, "max_abs_err": err, "max_abs_limit": tol, "rel_rms_err": rel_rms,
            "lse_err": lse_err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def grad_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max-abs error, its limit, relative RMS error) of a bf16 gradient
    against the plain version's. Gradients have no fixed magnitude, so the
    max-abs limit is ``GRAD_ULPS`` bf16 ulps of the reference's largest
    |value| with no cap."""
    ref = want.float()
    diff = got.float() - ref
    return (diff.abs().max().item(), GRAD_ULPS * bf16_ulp(ref.abs().max().item()),
            (diff.norm() / ref.norm()).item())


def flash_bwd_tile_share(q, k, v, do, out, lse, seg, causal, scale):
    """The tile pairs each pass of the backward kernel computed, counted by
    the kernel itself (one more launch), as a share of the pass's causal
    tile pairs: ``{"dkv": x, "dq": y}``. Raises unless both counts are what
    the plain skip rule gives over the launcher's tiles."""
    from dreamllm_tpu_torch.ops.attention import (
        bwd_tiles,
        flash_bwd_tile_pairs,
        flash_bwd_tiles_computed,
    )

    b, s, hq, d = q.shape
    skv = k.shape[1]
    counts = flash_bwd_tiles_computed(q, k, v, do, out, lse, seg, seg, causal=causal,
                                      sm_scale=scale)
    share = {}
    for label, (qt, kt) in zip(("dkv", "dq"), bwd_tiles(d)):
        rule = tuple(hq * (b if x is None else 1)
                     * flash_bwd_tile_pairs(x, x, s, skv, causal=causal, q_tile=qt, k_tile=kt)
                     .sum().item() for x in (seg, None))
        if counts[label] != rule:
            raise AssertionError(f"flash_bwd: {label} pass computed/causal tile pairs "
                                 f"{counts[label]}, the plain skip rule gives {rule}")
        share[label] = counts[label][0] / counts[label][1]
    return share


def _flash_bwd_case(name, b, hq, hkv, s, d, causal, segments, gen, skv=None):
    """One shape set of the backward kernel: dQ, dK, dV against the plain
    version from the same (q, k, v, dO, O, LSE), timings and bound. O and the
    LSE come from the forward kernel, as on the training path. ``skv``: as
    in :func:`_flash_case`."""
    from dreamllm_tpu_torch.ops.attention import (
        flash_attention_bwd_cuda,
        flash_attention_bwd_reference,
        flash_attention_cuda,
    )

    dev = "cuda"
    skv = skv or s
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).bfloat16()
    do = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    seg = None
    if segments is not None:
        seg = torch.tensor(segments, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_attention_cuda(q, k, v, seg, seg, causal=causal, sm_scale=scale,
                                    return_lse=True)

    def kernel():
        return flash_attention_bwd_cuda(q, k, v, do, out, lse, seg, seg, causal=causal,
                                        sm_scale=scale)

    def plain():
        return flash_attention_bwd_reference(q, k, v, do, out, lse, seg, seg, causal=causal,
                                             sm_scale=scale)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    for label, g_, a_ in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(g_, a_):
            raise AssertionError(f"[kernels] {name}: two calls gave different {label} bits")
    errs = {}
    for label, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        err, tol, rel_rms = grad_errors(g_, w_)
        errs[label] = (err, tol, rel_rms)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"[kernels] {name}: {label} max-abs {err} > {tol}")
        if not rel_rms <= GRAD_REL_RMS:
            raise AssertionError(f"[kernels] {name}: {label} relative RMS {rel_rms} > {GRAD_REL_RMS}")
    if seg is not None:
        pad_rows = seg == 0
        for label, g_ in zip(("dq", "dk", "dv"), got):
            if g_[pad_rows].float().abs().max().item() != 0.0:
                raise AssertionError(f"[kernels] {name}: {label} of padding rows is not zero")

    # the library yardstick: the backward of one SDPA call, timed alone
    groups = hq // hkv
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous().requires_grad_()
    vt = v.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous().requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    mask = None
    keep = torch.ones((b, s, skv), dtype=torch.bool, device=dev)
    if causal:
        keep &= torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    if seg is not None:
        keep &= (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        mask = keep[:, None]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

    ms = device_ms(kernel, 20)
    call_ms = cuda_ms(kernel, 20)
    plain_ms = device_ms(plain, 3)
    library_ms = device_ms(library, 20)

    # least time: five products of 2*d flops per kept (q, k) pair and query
    # head; q, k, v, dO, O read and dQ, dK, dV written once, plus the LSE
    pairs = int(keep.sum().item())
    flops = 10.0 * pairs * hq * d
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * b * hq * s
    nbytes += 2 * 4 * seg.numel() if seg is not None else 0
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    tile_share = flash_bwd_tile_share(q, k, v, do, out, lse, seg, causal, scale)
    worst = max(errs.values(), key=lambda e: e[0] / e[1])
    log(f"[kernels] flash_bwd {name}: "
        + "  ".join(f"{lb} err {e[0]:.3e} (limit {e[1]:.3e}) rel_rms {e[2]:.3e}"
                    for lb, e in errs.items())
        + f"  equal bits  tiles computed by the kernel (of causal, as the plain rule)"
        f" dK/dV {tile_share['dkv']:.4f}"
        f" dQ {tile_share['dq']:.4f}"
        f"  kernel {ms:.4f} ms (call {call_ms:.4f} ms)  plain {plain_ms:.4f} ms"
        f"  sdpa-bwd {library_ms:.4f} ms"
        f"  bound {bound_ms * 1e3:.2f} us ({bound_by}, {flops / 1e9:.2f} GFLOP)"
        f"  {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    return {"shape": name, "max_abs_err": worst[0], "max_abs_limit": worst[1],
            "rel_rms_err": max(e[2] for e in errs.values()), "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms, "tile_share": tile_share}


def _ulp(x: float, dtype) -> float:
    """Spacing of ``dtype`` numbers (bfloat16 or float32) at magnitude ``x``."""
    return bf16_ulp(x) if dtype == torch.bfloat16 else 2.0 ** (math.floor(math.log2(x)) - 23)


def _adam_case(name, shape, gen, steps=3, dtype=torch.bfloat16):
    """The fused 8-bit AdamW kernel on one leaf (bf16 parameters, or the
    float32 factors of a LoRA adapter over an int4 base) over ``steps``
    successive steps against its plain version. Each step both start from
    the kernel's previous state, so a one-code difference cannot compound
    into the next comparison. The update is held to one ulp of the leaf's
    dtype. The kernel is called as the optimizer calls it
    (``adam8bit_update_fused``): a 4-D leaf is an OIHW conv kernel, stored
    channels-last as the port stores them, and goes to the kernel in the
    HWIO order in which the plain version cuts its 256-blocks."""
    from dreamllm_tpu_torch.train.optim8bit import (
        _logical,
        adam8bit_update_cuda,
        adam8bit_update_fused,
        adam8bit_update_reference,
        quant_moment_m,
        quant_moment_v,
    )

    dev = "cuda"
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    p = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
    if len(shape) == 4:
        p = p.contiguous(memory_format=torch.channels_last)
    zeros = torch.zeros(shape, device=dev)
    mq, vq = quant_moment_m(zeros), quant_moment_v(zeros)
    n = p.numel()
    worst_upd = worst_scale = 0.0
    code_share = 0.0
    for step in range(steps):
        g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dtype)
        count = step + 1
        scalars = torch.tensor([4e-5, 1 - 0.9 ** count, 1 - 0.999 ** count], device=dev)
        want_u, want_m, want_v = adam8bit_update_reference(g, p, mq, vq, scalars, **hyper)
        got_u = adam8bit_update_fused(g.clone(), p, mq, vq, scalars, **hyper)  # mq, vq in place
        torch.cuda.synchronize()
        ulp = _ulp(want_u.float().abs().max().item(), dtype)
        worst_upd = max(worst_upd, (got_u.float() - want_u.float()).abs().max().item() / ulp)
        for got_q, want_q in ((mq, want_m), (vq, want_v)):
            diff = (got_q.codes.int() - want_q.codes.int()).abs()
            if diff.max().item() > 1:
                raise AssertionError(f"[kernels] adam8bit {name}: a code differs by more than 1")
            code_share = max(code_share, (diff != 0).float().mean().item())
            rel = ((got_q.scale - want_q.scale).abs()
                   / want_q.scale.abs().clamp_min(1e-30)).max().item()
            worst_scale = max(worst_scale, rel)
    if worst_upd > ADAM_UPD_ULPS or worst_scale > ADAM_SCALE_REL or code_share > ADAM_CODE_SHARE:
        raise AssertionError(
            f"[kernels] adam8bit {name}: update {worst_upd} ulps (limit {ADAM_UPD_ULPS}), scales "
            f"{worst_scale} (limit {ADAM_SCALE_REL}), codes off by one {code_share} "
            f"(limit {ADAM_CODE_SHARE})")

    # a skipped step: zero update, state untouched
    before = [t.clone() for t in (*mq, *vq)]
    skip = torch.ones((), dtype=torch.int32, device=dev)
    got_u = adam8bit_update_fused(g.clone(), p, mq, vq, scalars, skip=skip, **hyper)
    if got_u.float().abs().max().item() != 0.0 or any(
            not torch.equal(a, b_) for a, b_ in zip(before, (*mq, *vq))):
        raise AssertionError(f"[kernels] adam8bit {name}: a skipped step moved something")

    # the kernel alone, on the leaf already in its blocks' order
    gl, pl = _logical(g).contiguous(), _logical(p).contiguous()
    ms = device_ms(lambda: adam8bit_update_cuda(gl, pl, mq, vq, scalars, **hyper), 20)
    call_ms = cuda_ms(lambda: adam8bit_update_cuda(gl, pl, mq, vq, scalars, **hyper), 20)
    plain_ms = device_ms(lambda: adam8bit_update_reference(g, p, mq, vq, scalars, **hyper), 5)
    # g, p read and the update written at 2 B (bf16) or 4 B (float32); two
    # codes read and written; two float32 scales per 256 elements read and
    # written
    nb = -(-n // 256)
    nbytes = (3 * p.element_size() + 4) * n + 16 * nb
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    unit = "bf16" if dtype == torch.bfloat16 else "float32"
    log(f"[kernels] adam8bit {name}: update err {worst_upd:.3f} {unit} ulps, scales rel "
        f"{worst_scale:.3e}, codes off by one {code_share:.3e}  kernel {ms:.4f} ms (call "
        f"{call_ms:.4f} ms)  plain {plain_ms:.4f} ms  bound {bound_ms * 1e3:.2f} us (bytes)  "
        f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"shape": name, "max_abs_err": worst_upd * ulp, "update_err_ulps": worst_upd,
            "ulp_of": unit, "scale_rel_err": worst_scale, "codes_off_by_one": code_share, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": "bytes", "bound_share": bound_ms / ms}


W4_SHAPES = {  # DreamLLM-7B's decode projections, [K, N]
    "wqkv": (4096, 12288), "wo": (4096, 4096), "w_gate_up": (4096, 22016),
    "w_gate": (4096, 11008), "w_down": (11008, 4096), "head32000": (4096, 32000),
}


def _int4pack_fn(x, t):
    """PyTorch's own int4 matmul (``torch._weight_int4pack_mm``) on the same
    weight, for timing only: ``w = (u - 8) * scale + zero`` with zero 0 is
    this function, with bf16 scales. None where this PyTorch lacks it or
    refuses the shape."""
    from dreamllm_tpu_torch.ops.quant4 import GROUP

    try:
        p = t.packed
        u = torch.cat([p & 0xF, p >> 4], dim=0).T.contiguous()           # [N, K] in 0..15
        w_nk = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)           # [N, K/2]
        packed = torch._convert_weight_to_int4pack(w_nk, 8)
        sz = torch.stack([t.scale, torch.zeros_like(t.scale)], dim=-1).bfloat16().contiguous()
        xb = x.bfloat16()
        fn = lambda: torch._weight_int4pack_mm(xb, packed, GROUP, sz)  # noqa: E731
        fn()
        return fn
    except Exception as e:  # absent, or refuses this shape: reported as none
        first = str(e).strip().splitlines()[0][:160] if str(e).strip() else ""
        log(f"[kernels] w4a16: torch._weight_int4pack_mm unavailable ({type(e).__name__}: {first})")
        return None


def _w4_case(label, b, xdtype, gen):
    """The w4a16 kernel at one 7B shape: against its plain version, then
    timed (weights rotated through more copies than the 50 MB L2 holds, as
    decode reads each weight cold) beside the plain version, the dense bf16
    product on the unquantized weight, the dequantize product (the path
    outside the gate) and PyTorch's int4 matmul."""
    from dreamllm_tpu_torch.ops import quant4
    from dreamllm_tpu_torch.ops.quant4 import (
        Q4Tensor,
        dequantize_int4,
        quantize_int4,
        w4_matmul_reference,
    )

    w4_matmul_cuda = quant4.w4_matmul_cuda
    k, n = W4_SHAPES[label]
    name = f"{label} {k}x{n} B{b}" + (" f32" if xdtype == torch.float32 else "")
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    t = quantize_int4(w)
    wb = w.bfloat16()
    del w
    x = torch.randn((b, k), generator=gen, device="cuda").to(xdtype)
    got, again, want = w4_matmul_cuda(x, t), w4_matmul_cuda(x, t), w4_matmul_reference(x, t)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"[kernels] w4a16 {name}: two calls gave different bits")
    err, tol, rel_rms = w4_errors(got, want)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"[kernels] w4a16 {name}: max-abs {err} > {tol}")
    if not rel_rms <= W4_REL_RMS:
        raise AssertionError(f"[kernels] w4a16 {name}: relative RMS {rel_rms} > {W4_REL_RMS}")

    wbytes = t.nbytes()
    qs = [t] + [Q4Tensor(t.packed.clone(), t.scale.clone())
                for _ in range(math.ceil(150e6 / wbytes) - 1)]
    ws = [wb] + [wb.clone() for _ in range(math.ceil(150e6 / (2 * wb.numel())) - 1)]
    xb = x.bfloat16()
    lib = _int4pack_fn(x, t)
    lib_err = None if lib is None else (lib().float() - want.float()).abs().max().item()

    def rotating(f, pool):
        i = [0]

        def call():
            i[0] += 1
            return f(pool[i[0] % len(pool)])
        return call

    iters = max(20, 2 * len(qs))
    ms = device_ms(rotating(lambda q: w4_matmul_cuda(x, q), qs), iters)
    call_ms = cuda_ms(rotating(lambda q: w4_matmul_cuda(x, q), qs), iters)
    plain_ms = device_ms(rotating(lambda q: w4_matmul_reference(x, q), qs), 5)
    dense_ms = device_ms(rotating(lambda wd: xb @ wd, ws), iters)
    dequant_ms = device_ms(rotating(lambda q: x @ dequantize_int4(q, x.dtype), qs), 5)
    library_ms = None if lib is None else device_ms(lib, iters)
    del qs, ws

    # least time: the packed weight and its scales read once, x read and y
    # written once; the products at the bf16 tensor-core rate
    nbytes = wbytes + x.numel() * x.element_size() + b * n * x.element_size()
    flops = 2.0 * b * k * n
    bound_ms = max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    log(f"[kernels] w4a16 {name}: max_abs_err {err:.3e} (limit {tol:.3e}) rel_rms {rel_rms:.3e}"
        f"  kernel {ms:.4f} ms (call {call_ms:.4f} ms)  plain {plain_ms:.4f} ms"
        f"  dense-bf16 {dense_ms:.4f} ms  dequant {dequant_ms:.4f} ms  int4pack "
        + (f"{library_ms:.4f} ms (max-abs vs plain {lib_err:.3e})" if lib_err is not None
           else "none")
        + f"  bound {bound_ms * 1e3:.2f} us ({bound_by})  {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"shape": name, "max_abs_err": err, "max_abs_limit": tol, "rel_rms_err": rel_rms,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "dense_bf16_ms": dense_ms, "dequant_ms": dequant_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


# the decoder's projections at 7B, [K, N]: both serving layouts
W4_DECODER_SHAPES = ("wqkv", "wo", "w_gate_up", "w_gate", "w_down")


def _w4_row_invariance(gen) -> dict:
    """Whether the w4a16 kernel is row-invariant at each decoder shape: row
    r of a B = 8 call against the B = 1 call on row r alone, bit for bit.
    A measurement, not a check: where it holds, a K3 product in a verify
    or beam forward (up to 8 rows) rounds every row as a plain decode step
    would. Returns ``{shape: rows that differ}`` with the largest difference."""
    from dreamllm_tpu_torch.ops.quant4 import quantize_int4, w4_matmul_cuda

    out = {}
    for label in W4_DECODER_SHAPES:
        k, n = W4_SHAPES[label]
        t = quantize_int4(torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5)
        x = torch.randn((8, k), generator=gen, device="cuda").bfloat16()
        full = w4_matmul_cuda(x, t)
        rows = [w4_matmul_cuda(x[r:r + 1].contiguous(), t)[0] for r in range(8)]
        diff = [(full[r].float() - rows[r].float()).abs().max().item() for r in range(8)]
        out[label] = {"rows_differing": sum(d != 0 for d in diff), "max_abs_diff": max(diff)}
        log(f"[kernels] w4a16 row invariance {label} {k}x{n}: rows of a B8 call equal to B1 "
            f"calls bit for bit in {8 - out[label]['rows_differing']} of 8 rows (max-abs "
            f"difference {max(diff):.3e})")
    return out


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    pad = 24
    segs = [[1] * 300 + [2] * 500 + [3] * (200) + [0] * pad,
            [1] * 700 + [2] * (1024 - 700 - pad) + [0] * pad]
    segs2k = [[1] * 2048, [1] * 1280 + [2] * (768 - 51) + [0] * 51]  # as _joint_batch packs it
    cases = [
        # the UNet's spatial self-attention at 512 px (CFG batch 2)
        ("unet64x64 B2 H5 S4096 D64", 2, 5, 5, 4096, 64, False, False, None),
        ("unet32x32 B2 H10 S1024 D64", 2, 10, 10, 1024, 64, False, False, None),
        # the SDXL UNet's spatial self-attention at 1024 px (CFG batch 2)
        ("sdxl64x64 B2 H10 S4096 D64", 2, 10, 10, 4096, 64, False, False, None),
        ("sdxl32x32 B2 H20 S1024 D64", 2, 20, 20, 1024, 64, False, False, None),
        # and its cross-attention over DreamLLM-SDXL's 196 dream queries
        ("sdxl64x64-cross B2 H10 S4096 Skv196 D64", 2, 10, 10, 4096, 64, False, False, None),
        ("sdxl32x32-cross B2 H20 S1024 Skv196 D64", 2, 20, 20, 1024, 64, False, False, None),
        # the decoder's shapes (training and cache-free forwards)
        ("causal B1 H32 S2048 D128 lse", 1, 32, 32, 2048, 128, True, True, None),
        ("causal-gqa-seg B2 Hq32 Hkv8 S1024 D128", 2, 32, 8, 1024, 128, True, True, segs),
        # the 7B training batch: two rows, the second packed with a padding tail
        ("train causal-seg B2 H32 S2048 D128 lse", 2, 32, 32, 2048, 128, True, True, segs2k),
    ]
    results = [_flash_case(*c, gen, skv=196 if "cross" in c[0] else None) for c in cases]
    bwd_cases = [
        # the decoder's training shapes
        ("causal B1 H32 S2048 D128", 1, 32, 32, 2048, 128, True, None),
        ("causal-gqa-seg B2 Hq32 Hkv8 S1024 D128", 2, 32, 8, 1024, 128, True, segs),
        ("train causal-seg B2 H32 S2048 D128", 2, 32, 32, 2048, 128, True, segs2k),
        # the UNet's spatial self-attention at 512 px (training batch 2)
        ("unet64x64 B2 H5 S4096 D64", 2, 5, 5, 4096, 64, False, None),
        ("unet32x32 B2 H10 S1024 D64", 2, 10, 10, 1024, 64, False, None),
        # the SDXL UNet's at 1024 px (the SDXL creation step, batch 2)
        ("sdxl64x64 B2 H10 S4096 D64", 2, 10, 10, 4096, 64, False, None),
        ("sdxl32x32 B2 H20 S1024 D64", 2, 20, 20, 1024, 64, False, None),
        ("sdxl64x64-cross B2 H10 S4096 Skv196 D64", 2, 10, 10, 4096, 64, False, None),
        ("sdxl32x32-cross B2 H20 S1024 Skv196 D64", 2, 20, 20, 1024, 64, False, None),
    ]
    bwd = [_flash_bwd_case(*c, gen, skv=196 if "cross" in c[0] else None) for c in bwd_cases]
    adam = [_adam_case(name, shape, gen) for name, shape in (
        ("w_gate [4096, 11008]", (4096, 11008)),
        ("wq [4096, 4096]", (4096, 4096)),
        ("norm [4096]", (4096,)),
        # an SD-2.1 UNet conv kernel (OIHW): the caller blocks it in HWIO order
        ("conv [320, 320, 3, 3]", (320, 320, 3, 3)),
    )]
    # the float32 factors of a rank-8 LoRA adapter over the int4 7B decoder
    adam += [_adam_case(name, shape, gen, dtype=torch.float32) for name, shape in (
        ("lora_a f32 [4096, 8]", (4096, 8)),
        ("lora_b f32 [8, 4096]", (8, 4096)),
    )]
    w4 = [_w4_case(label, b, torch.bfloat16, gen) for label, b in (
        ("wqkv", 1), ("wqkv", 8), ("wo", 1), ("wo", 3), ("wo", 8), ("w_gate_up", 1),
        ("w_gate_up", 8), ("w_gate", 1), ("w_gate", 8), ("w_down", 1), ("w_down", 8))]
    # a 32000-wide head (bench.py's vocab) takes the kernel with float32 x
    w4.append(_w4_case("head32000", 1, torch.float32, gen))
    return {"flash_fwd": results, "flash_bwd": bwd, "adam8bit": adam, "w4a16": w4,
            "w4a16_row_invariance": _w4_row_invariance(gen)}


def _tiny_configs():
    from dreamllm_tpu_torch.models.clip import CLIPVisionConfig
    from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig
    from dreamllm_tpu_torch.models.llama import LlamaConfig
    from dreamllm_tpu_torch.models.sd.head import SDHeadConfig
    from dreamllm_tpu_torch.models.sd.unet import UNetConfig
    from dreamllm_tpu_torch.models.sd.vae import VAEConfig

    llm = LlamaConfig(vocab_size=32008, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4)
    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, image_size=32, patch_size=16)
    cfg = DreamLLMConfig(llm=llm, vision=vision, image_embed_len=4, n_dream_queries=8)
    unet = UNetConfig(sample_size=8, block_out_channels=(32, 64),
                      down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                      up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                      layers_per_block=1, transformer_layers_per_block=(1, 1),
                      num_attention_heads=(2, 4), cross_attention_dim=24,
                      norm_num_groups=8)
    vae = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
    return cfg, SDHeadConfig(unet=unet, vae=vae, llm_hidden_size=64)


def phase_small_reference() -> None:
    """A tiny float32 document on the card against the same on the CPU:
    the same greedy text, images within 1e-3 (float32 products on both,
    summed in other orders through 2 x 2 UNet steps and the VAE). Then, the
    same way, an image-out chat turn (same greedy text, its image within
    1e-3) and a tiny text-to-image at DeepCache interval 2 (within 1e-3)."""
    from dreamllm_tpu_torch.generation.interleaved import InterleavedConfig, generate_interleaved
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig
    from dreamllm_tpu_torch.models.dreamllm import init_dreamllm_params
    from dreamllm_tpu_torch.models.sd.head import init_sd_head_params, sd_head_pipeline

    cfg, head_cfg = _tiny_configs()
    gen = torch.Generator().manual_seed(3)
    params = init_dreamllm_params(cfg, generator=gen, device="cpu")
    head = init_sd_head_params(head_cfg, generator=gen, device="cpu")
    _live_conv_out(head, head_cfg, gen)
    ids = torch.randint(10, 31000, (1, 8), generator=gen)
    noise = [torch.randn((1, 8, 8, 4), generator=gen) for _ in range(2)]
    icfg = InterleavedConfig(max_new_tokens=18, max_images=2, num_inference_steps=2,
                             image_height=16, image_width=16, sampler="dpm",
                             force_image_interval=6,
                             sampling=SamplingConfig(greedy=True, eos_token_id=-1))

    def run(device):
        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [move(v) for v in tree]
            return tree.to(device)

        calls = iter(noise)

        def pipe(*a, **kw):
            return sd_head_pipeline(*a, latents=next(calls), **kw)

        return generate_interleaved(move(params), cfg, move(head), head_cfg, ids, icfg,
                                    pipeline_fn=pipe, device=device)

    ref, got = run("cpu"), run("cuda")
    kinds = [s[0] for s in got["segments"]]
    if kinds != [s[0] for s in ref["segments"]] or len(got["images"]) != 2:
        raise AssertionError(f"[small] segment kinds differ: {kinds}")
    img_err = 0.0
    for (kind, a), (_, b) in zip(got["segments"], ref["segments"]):
        if kind == "text" and a.tolist() != b.tolist():
            raise AssertionError(f"[small] text differs: {a.tolist()} vs {b.tolist()}")
        if kind == "image":
            img_err = max(img_err, (a.cpu() - b).abs().max().item())
    if not img_err <= 1e-3:
        raise AssertionError(f"[small] image max-abs {img_err} > 1e-3")
    log(f"[small] card == CPU: segments {kinds}, image max-abs {img_err:.3e}")
    _small_chat_and_t2i(cfg, head_cfg, params, head, gen)


def _small_chat_and_t2i(cfg, head_cfg, params, head, gen) -> None:
    """Card against CPU on the tiny model: one image-out chat turn
    (``generate_interleaved`` under ``chat``, both sides' image made from the
    same start latents) and one text-to-image at DeepCache interval 2."""
    import dreamllm_tpu_torch.generation.interleaved as interleaved_mod
    from dreamllm_tpu_torch.data.dataset_types import Message
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.generation.chat import chat
    from dreamllm_tpu_torch.generation.interleaved import InterleavedConfig
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig
    from dreamllm_tpu_torch.models.dreamllm import encode_prompt_embeds
    from dreamllm_tpu_torch.models.sd.head import sd_head_pipeline

    tok = ToyTokenizer()
    image = torch.rand((32, 32, 3), generator=gen)
    chat_noise = torch.randn((1, 8, 8, 4), generator=gen)
    t2i_noise = torch.randn((1, 8, 8, 4), generator=gen)
    msgs = [Message("user", "<image>\nWhat is in this picture?")]
    icfg = InterleavedConfig(max_new_tokens=12, max_images=1, num_inference_steps=2,
                             image_height=16, image_width=16, sampler="dpm",
                             force_image_interval=5)
    sampling = SamplingConfig(greedy=True, eos_token_id=-1, max_new_tokens=12)
    real_pipeline = interleaved_mod.sd_head_pipeline

    def run(device):
        p, h = _to_device(params, device), _to_device(head, device)
        interleaved_mod.sd_head_pipeline = (
            lambda *a, **kw: real_pipeline(*a, latents=chat_noise, **kw))
        try:
            turn = chat(p, cfg, tok, msgs, [image], sampling=sampling, head_params=h,
                        head_cfg=head_cfg, interleaved=icfg, device=device)
        finally:
            interleaved_mod.sd_head_pipeline = real_pipeline
        with torch.no_grad():
            cond = encode_prompt_embeds(p, cfg, tok, T2I_PROMPT + POSITIVE_SUFFIX)
            neg = encode_prompt_embeds(p, cfg, tok, NEGATIVE_PROMPT)
            t2i = sd_head_pipeline(h, head_cfg, cond, neg, None, height=16, width=16,
                                   num_inference_steps=4, guidance_scale=3.5, sampler="ddim",
                                   deepcache_interval=2, latents=t2i_noise)
        return turn, t2i

    (ref_turn, ref_t2i), (got_turn, got_t2i) = run("cpu"), run("cuda")
    if got_turn["text"] != ref_turn["text"] or len(got_turn["images"]) != 1:
        raise AssertionError(f"[small] chat turn differs: {got_turn['text']!r} with "
                             f"{len(got_turn['images'])} images vs {ref_turn['text']!r}")
    chat_err = (got_turn["images"][0].cpu() - ref_turn["images"][0]).abs().max().item()
    t2i_err = (got_t2i.cpu() - ref_t2i).abs().max().item()
    if not (chat_err <= 1e-3 and t2i_err <= 1e-3):
        raise AssertionError(f"[small] chat image max-abs {chat_err}, t2i max-abs {t2i_err}; "
                             "limit 1e-3")
    log(f"[small] card == CPU: image-out chat turn ({len(got_turn['text'].split())} text "
        f"tokens, image max-abs {chat_err:.3e}); t2i at DeepCache interval 2 "
        f"(max-abs {t2i_err:.3e})")


def _redraw_conv(conv, gen) -> None:
    """Redraw a conv's weight at its fan-in scale, in place, from ``gen``."""
    from dreamllm_tpu_torch.models.sd.blocks import init_conv

    cout, cin, kh, kw = conv["w"].shape  # OIHW
    with torch.no_grad():
        new = init_conv(kh, kw, cin, cout, conv["w"].dtype, conv["w"].device, gen)
        conv["w"].copy_(new["w"])


def _live_conv_out(head, head_cfg, gen) -> None:
    """Redraw the UNet's ``conv_out`` at its fan-in scale, in place, from
    ``gen``. Its initial std of 1e-5 leaves the UNet's output next to nothing
    on random weights: the images would then follow their start latents, and
    neither a card-vs-CPU limit nor DeepCache's drift would see the UNet."""
    _redraw_conv(head["unet"]["conv_out"], gen)


def phase_main(profile_dir: str | None = None) -> dict:
    from dreamllm_tpu_torch.configs import dreamllm_7b
    from dreamllm_tpu_torch.models.dreamllm import init_dreamllm_params
    from dreamllm_tpu_torch.models.sd.head import init_sd_head_params, sd_head_pipeline

    cfg, head_cfg = dreamllm_7b(torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = init_dreamllm_params(cfg, generator=gen, device="cuda")
        head = init_sd_head_params(head_cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params)) + sum(t.numel() for t in _leaves(head))
    log(f"[main] DreamLLM-7B ({cfg.llm.num_hidden_layers} decoder layers) + SD-2.1, bf16: "
        f"{n_params / 1e9:.3f} B parameters built in {time.perf_counter() - t0:.2f} s")
    model = (params, cfg, head, head_cfg)
    launches, _ = _document(model, sd_head_pipeline, 1, gen, "main")
    if profile_dir:
        _profile_main(params, cfg, head, head_cfg, profile_dir)
    return launches, model


DOC_STEPS, DOC_IMAGES, DOC_SEGMENT = 20, 2, 32  # the document: 2 images of 20 DPM steps


def _document(model, pipeline, deepcache_interval: int, gen, label: str) -> tuple[dict, list]:
    """One interleaved document with two images at the head's own size
    (``pipeline`` makes them, at ``deepcache_interval``; with ``pipeline``
    None, ``generate_interleaved`` picks the head's pipeline itself, as it
    does for an SDXL head), timed; the flash kernel's launches over the run
    must equal the UNet's flash sites of every full and shallow step."""
    import dreamllm_tpu_torch.generation.interleaved as interleaved_mod
    from dreamllm_tpu_torch.generation.interleaved import InterleavedConfig, generate_interleaved
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig
    from dreamllm_tpu_torch.ops.attention import flash_attention

    params, cfg, head, head_cfg = model
    steps, n_images, seg = DOC_STEPS, DOC_IMAGES, DOC_SEGMENT
    side = _head_side(head_cfg)
    icfg = InterleavedConfig(
        max_new_tokens=seg * (n_images + 1), max_images=n_images,
        num_inference_steps=steps, guidance_scale=3.5, sampler="dpm",
        image_height=side, image_width=side, append_image_span=True,
        force_image_interval=seg,
        sampling=SamplingConfig(greedy=True, eos_token_id=-1),
    )
    ids = torch.randint(10, 31000, (1, 16), generator=gen, device="cuda")
    image_s = [0.0]

    def timed(fn, **extra):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            img = fn(*a, **extra, **kw)
            torch.cuda.synchronize()
            image_s[0] += time.perf_counter() - t
            return img

        return run

    real_sdxl = interleaved_mod.sdxl_head_pipeline
    if pipeline is None:
        interleaved_mod.sdxl_head_pipeline = timed(real_sdxl)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t = time.perf_counter()
    try:
        with torch.no_grad():
            doc = generate_interleaved(
                params, cfg, head, head_cfg, ids, icfg, gen, device="cuda",
                pipeline_fn=None if pipeline is None else timed(
                    pipeline, deepcache_interval=deepcache_interval))
        torch.cuda.synchronize()
    finally:
        interleaved_mod.sdxl_head_pipeline = real_sdxl
    doc_s = time.perf_counter() - t
    launches = flash_attention.launches

    texts = [s[1] for s in doc["segments"] if s[0] == "text"]
    imgs = doc["images"]
    if len(imgs) != n_images or len(texts) != n_images + 1:
        raise AssertionError(f"[{label}] {len(imgs)} images, {len(texts)} text segments")
    for img in imgs:
        _check_image(img, label, (side, side, 3))
    want = n_images * pipeline_flash_launches(head_cfg.unet, steps, deepcache_interval,
                                              cfg.n_dream_queries)
    if launches != want:
        raise AssertionError(f"[{label}] flash kernel launched {launches} times, want {want}")
    decoded = icfg.max_new_tokens
    other_s = doc_s - image_s[0]
    peak = torch.cuda.max_memory_allocated()
    log(f"[{label}] document (DeepCache interval {deepcache_interval}): {doc_s:.3f} s; images "
        f"{image_s[0]:.3f} s ({image_s[0] / n_images:.3f} s each, {side}x{side}, {steps} dpm "
        f"steps, CFG batch 2); text+spans {other_s:.3f} s for {decoded} decoded tokens "
        f"({decoded / other_s:.2f} tokens/s, prefill, dream and span appends included)")
    log(f"[{label}] text segments {[len(x) for x in texts]}; flash launches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    return {"flash_fwd": launches}, imgs


def _check_image(img, label: str, shape=(512, 512, 3)) -> None:
    if tuple(img.shape) != shape or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"[{label}] image shape {tuple(img.shape)} or non-finite values")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError(f"[{label}] image values outside [0, 1]")


# projects/dreamllm/inference.py, mode "t2i": the prompt's suffix and the
# negative prompt that conditions the unconditional side
POSITIVE_SUFFIX = ", best quality, extremely detailed"
NEGATIVE_PROMPT = (
    "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, "
    "fewer digits, cropped, worst quality, low quality"
)
T2I_PROMPT = "a photo of a dog"  # inference.py's default prompt
T2I_STEPS = 50                   # inference.py's defaults: DDIM, 50 steps, guidance 3.5


def phase_t2i(model) -> tuple[dict, dict]:
    """Text-to-image as ``projects/dreamllm/inference.py`` makes it, on the
    7B parameters with the UNet's ``conv_out`` redrawn at its fan-in scale
    (:func:`_live_conv_out`, kept for the later phases): the prompt with its
    suffix and the negative prompt through ``encode_prompt_embeds``, timed
    alone, then ``sd_head_pipeline`` (DDIM, 50 steps, guidance 3.5, 512x512)
    at DeepCache interval 1 and 2 from the same start latents, twice each;
    the second run of each interval is the one timed. Each run is one path:
    the flash count is set to 0 before it and read after it (the prompts'
    forwards take plain attention and launch nothing)."""
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.models.dreamllm import encode_prompt_embeds
    from dreamllm_tpu_torch.models.sd.head import sd_head_pipeline
    from dreamllm_tpu_torch.ops.attention import flash_attention

    params, cfg, head, head_cfg = model
    tok = ToyTokenizer()
    gen = torch.Generator(device="cuda").manual_seed(2)
    _live_conv_out(head, head_cfg, gen)
    latents = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")

    torch.cuda.synchronize()
    flash_attention.launches = 0
    t = time.perf_counter()
    with torch.no_grad():
        cond = encode_prompt_embeds(params, cfg, tok, T2I_PROMPT + POSITIVE_SUFFIX)
        neg = encode_prompt_embeds(params, cfg, tok, NEGATIVE_PROMPT)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t
    if cond.shape != (1, cfg.n_dream_queries, cfg.llm.hidden_size) or cond.shape != neg.shape:
        raise AssertionError(f"[t2i] prompt states of shapes {tuple(cond.shape)}, "
                             f"{tuple(neg.shape)}")
    if flash_attention.launches != 0:
        raise AssertionError(f"[t2i] the prompts' forwards launched the flash kernel "
                             f"{flash_attention.launches} times, want 0")
    log(f"[t2i] the two prompts' forwards (encode_prompt_embeds): {prompt_s:.3f} s")

    images, launches, walls = {}, {}, {}
    for interval in (1, 2):
        want = pipeline_flash_launches(head_cfg.unet, T2I_STEPS, interval, cfg.n_dream_queries)
        walls[interval] = []
        for _ in range(2):
            torch.cuda.synchronize()
            flash_attention.launches = 0
            t = time.perf_counter()
            with torch.no_grad():
                img = sd_head_pipeline(head, head_cfg, cond, neg, gen, height=512, width=512,
                                       num_inference_steps=T2I_STEPS, guidance_scale=3.5,
                                       sampler="ddim", deepcache_interval=interval,
                                       latents=latents)
            torch.cuda.synchronize()
            walls[interval].append(time.perf_counter() - t)
            launches[interval] = flash_attention.launches
            _check_image(img[0], "t2i")
            if launches[interval] != want:
                raise AssertionError(f"[t2i] interval {interval}: flash kernel launched "
                                     f"{launches[interval]} times, want {want}")
        images[interval] = img
        first, second = walls[interval]
        log(f"[t2i] DeepCache interval {interval}: sd_head_pipeline {second:.3f} s for one "
            f"512x512 image ({T2I_STEPS} ddim steps, CFG batch 2; second of two runs, the "
            f"first {first:.3f} s); flash launches {launches[interval]} a run")
    drift = (images[2] - images[1]).abs().mean().item()
    log(f"[t2i] interval 2 / interval 1 pipeline wall: {walls[2][1] / walls[1][1]:.3f}; "
        f"interval-2 drift from interval 1: mean |delta| {drift:.4e} on [0, 1] pixels")
    return {"flash_fwd": launches[1]}, {"flash_fwd": launches[2]}


def phase_document_dc2(model) -> dict:
    """The main path's document again, its images at DeepCache interval 2."""
    from dreamllm_tpu_torch.models.sd.head import sd_head_pipeline

    gen = torch.Generator(device="cuda").manual_seed(0)
    return _document(model, sd_head_pipeline, 2, gen, "main-dc2")[0]


def phase_chat(model) -> dict:
    """One multimodal chat turn on the 7B parameters: the vicuna_v1.1
    template, one random 224x224 image, 64 greedy tokens (EOS off: random
    weights would stop at random). Every attention of the turn takes the
    plain path (CLIP's, and the decoder's with its KV cache), so the flash
    kernel is never launched."""
    from dreamllm_tpu_torch.data.dataset_types import Message
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.generation.chat import chat
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig
    from dreamllm_tpu_torch.ops.attention import flash_attention

    params, cfg, _, _ = model
    gen = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((224, 224, 3), generator=gen, device="cuda")
    msgs = [Message("user", "<image>\nDescribe this image in detail.")]
    n_new = 64
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t = time.perf_counter()
    out = chat(params, cfg, ToyTokenizer(), msgs, [image], template="vicuna_v1.1",
               sampling=SamplingConfig(greedy=True, max_new_tokens=n_new, eos_token_id=-1),
               generator=gen, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = flash_attention.launches
    words = out["text"].split()
    if len(words) != n_new or out["images"]:
        raise AssertionError(f"[chat] {len(words)} tokens and {len(out['images'])} images")
    if launches != 0:
        raise AssertionError(f"[chat] flash kernel launched {launches} times, want 0")
    log(f"[chat] one turn (1 image, {n_new} greedy tokens): {secs:.3f} s, "
        f"{n_new / secs:.2f} tokens/s (CLIP, prompt build and prefill included)")
    return {"flash_fwd": launches}


# ---------------------------------------------------------------------------
# Model variants: DreamLLM-SDXL, ControlNet, the CLIP text tower
# ---------------------------------------------------------------------------

SDXL_T2I_GUIDANCE = 5.0  # sdxl_head_pipeline's default, as JAX's


def _head_side(head_cfg) -> int:
    """The image side a head makes by default: its latents times the VAE's
    factor (512 for SD 2.1, 1024 for SDXL)."""
    return head_cfg.unet.sample_size * 2 ** (len(head_cfg.vae.block_out_channels) - 1)


def _sdxl_model(model, gen) -> tuple:
    """DreamLLM-SDXL-7B (``configs.dreamllm_sdxl_7b``, bf16) on the card:
    the decoder's and the CLIP tower's tensors are DreamLLM-7B's (``model``;
    the shapes agree, and the rotary tables follow the positions, not
    ``max_position_embeddings``); the MLP projector, the 196 dream queries
    and the SDXL head are drawn from ``gen``, the UNet's ``conv_out`` at its
    fan-in scale."""
    from dreamllm_tpu_torch.configs import dreamllm_sdxl_7b
    from dreamllm_tpu_torch.models.projector import init_projector_params
    from dreamllm_tpu_torch.models.sd.sdxl import init_sdxl_head_params

    params7 = model[0]
    cfg, head_cfg = dreamllm_sdxl_7b(torch.bfloat16)
    h = cfg.llm.hidden_size
    t0 = time.perf_counter()
    with torch.no_grad():
        params = {
            "llm": params7["llm"],
            "clip_vision_embedding": {
                "clip": params7["clip_vision_embedding"]["clip"],
                "projector": init_projector_params(cfg.projector_cfg(), generator=gen,
                                                   device="cuda"),
            },
            # drawn as init_dreamllm_params draws them
            "dream_embedding": {"queries": (torch.randn((cfg.n_dream_queries, h), generator=gen,
                                                        device="cuda") * h ** -0.5
                                            ).to(cfg.llm.dtype)},
        }
        head = init_sdxl_head_params(head_cfg, generator=gen, device="cuda")
        _live_conv_out(head, head_cfg, gen)
    torch.cuda.synchronize()
    n_new = (sum(t.numel() for t in _leaves(head)) + params["dream_embedding"]["queries"].numel()
             + sum(t.numel() for t in _leaves(params["clip_vision_embedding"]["projector"])))
    log(f"[sdxl] DreamLLM-SDXL-7B: the 7B decoder and CLIP tower shared, {n_new / 1e9:.3f} B "
        f"new parameters (SDXL UNet {sum(t.numel() for t in _leaves(head['unet'])) / 1e9:.3f} "
        f"B bf16, VAE float32) built in {time.perf_counter() - t0:.2f} s")
    return params, cfg, head, head_cfg


def phase_sdxl(model, profile_dir: str | None = None) -> tuple[dict, dict, tuple, list]:
    """DreamLLM-SDXL-7B serving (:func:`_sdxl_model`): one interleaved
    document as the main path's (16-token prompt, two 1024x1024 images of
    20 DPM-Solver++ steps at CFG 3.5, 96 tokens) with ``generate_interleaved``
    choosing ``sdxl_head_pipeline`` itself, then text-to-image as
    ``projects/dreamllm/inference.py`` makes it for an SDXL head
    (``encode_prompt_embeds`` of the prompt and the negative prompt, then
    ``sdxl_head_pipeline``: DDIM, 50 steps, guidance 5.0, 1024 px) twice from
    the same start latents, the second run timed. K1: 140 launches a CFG
    UNet forward (``unet_flash_sites``: 70 self-attentions, and as many
    cross-attentions, whose 196 dream-query keys pass the flash rule).
    ``profile_dir``: then profile one CFG UNet step (kernel sums only).
    Returns the launches of both paths, the model and the three images."""
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.models.dreamllm import encode_prompt_embeds
    from dreamllm_tpu_torch.models.sd.sdxl import sdxl_head_pipeline
    from dreamllm_tpu_torch.ops.attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    sdxl = _sdxl_model(model, gen)
    params, cfg, head, head_cfg = sdxl
    sites = unet_flash_sites(head_cfg.unet, 2, cfg.n_dream_queries)[0]
    doc_launches, images = _document(sdxl, None, 1, gen, "sdxl")

    tok = ToyTokenizer()
    side, lat = _head_side(head_cfg), head_cfg.unet.sample_size
    latents = torch.randn((1, lat, lat, head_cfg.unet.in_channels), generator=gen, device="cuda")
    flash_attention.launches = 0
    with torch.no_grad():
        cond = encode_prompt_embeds(params, cfg, tok, T2I_PROMPT + POSITIVE_SUFFIX)
        neg = encode_prompt_embeds(params, cfg, tok, NEGATIVE_PROMPT)
    if cond.shape != (1, cfg.n_dream_queries, cfg.llm.hidden_size) or neg.shape != cond.shape:
        raise AssertionError(f"[sdxl-t2i] prompt states of shapes {tuple(cond.shape)}, "
                             f"{tuple(neg.shape)}")
    if flash_attention.launches != 0:
        raise AssertionError(f"[sdxl-t2i] the prompts launched K1 {flash_attention.launches} "
                             "times, want 0")
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t = time.perf_counter()
        with torch.no_grad():
            img = sdxl_head_pipeline(head, head_cfg, cond, neg, gen, height=side,
                                     width=side, num_inference_steps=T2I_STEPS,
                                     guidance_scale=SDXL_T2I_GUIDANCE, sampler="ddim",
                                     latents=latents)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        launches = flash_attention.launches
        _check_image(img[0], "sdxl-t2i", (side, side, 3))
        if launches != T2I_STEPS * sites:
            raise AssertionError(f"[sdxl-t2i] K1 launched {launches} times, want "
                                 f"{T2I_STEPS * sites}")
    peak = torch.cuda.max_memory_allocated()
    if profile_dir:
        from dreamllm_tpu_torch.models.projector import projector_forward
        from dreamllm_tpu_torch.models.sd.sdxl import _pooled, make_add_time_ids
        from dreamllm_tpu_torch.models.sd.unet import unet_forward

        with torch.no_grad():
            states = torch.cat([neg, cond], dim=0)
            ctx = projector_forward(head["projector"], head_cfg.projector_cfg(), states)
            added = {"time_ids": make_add_time_ids((side, side), (0, 0), (side, side), 2,
                                                   device="cuda"),
                     "text_embeds": _pooled(head, head_cfg, states)}
            lat_in = torch.cat([latents, latents], dim=0).to(ctx.dtype)
            tt = torch.full((2,), 500, device="cuda")
            _profile(lambda: unet_forward(head["unet"], head_cfg.unet, lat_in, tt, ctx,
                                          added_cond=added),
                     "sdxl_unet_cfg_step", profile_dir, trace=False, top=12)
    log(f"[sdxl-t2i] sdxl_head_pipeline {walls[1]:.3f} s for one {side}x{side} image "
        f"({T2I_STEPS} ddim steps, guidance {SDXL_T2I_GUIDANCE}, CFG batch 2; second of two runs, "
        f"the first {walls[0]:.3f} s); flash launches {launches} a run; peak memory "
        f"{peak / 2**30:.2f} GiB")
    return doc_launches, {"flash_fwd": launches}, sdxl, images + [img[0]]


def phase_clip_text(model, images: list) -> dict:
    """The CLIP text tower at ViT-L/14's width (``CLIPTextConfig()``, bf16,
    seeded) on 4 prompts tokenised by id (``<|startoftext|>`` 49406, the
    caption, ``<|endoftext|>`` 49407, padding 0, 77 positions), then
    ``clip_similarity`` of those prompts against ``clip_pooled_output`` of
    ``images`` through DreamLLM-7B's CLIP tower (random visual and text
    projections to 768, ``logit_scale`` as a checkpoint stores it, log 100).
    Checks: shapes, finite values, logits within the scale, attention at 77
    positions on the plain path (K1 0), and each row of the batch within
    1e-2 relative of the same prompt computed alone, on a float32 copy of
    the same weights: in bf16 a prompt's pooled state lies about 1e-2 from
    its float32 value whatever the batch (rounding through 12 random
    layers), so the bf16 distances are logged beside it, not held."""
    from dreamllm_tpu_torch.models.clip import (
        clip_pooled_output,
        clip_preprocess,
        clip_vision_forward,
    )
    from dreamllm_tpu_torch.models.clip_text import (
        CLIPTextConfig,
        clip_similarity,
        clip_text_forward,
        init_clip_text_params,
    )
    from dreamllm_tpu_torch.models.llama import dense_init
    from dreamllm_tpu_torch.ops.attention import flash_attention
    from dreamllm_tpu_torch.train.tree import tree_map

    params, cfg = model[0], model[1]
    tcfg = CLIPTextConfig(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        tparams = init_clip_text_params(tcfg, generator=gen, device="cuda")
    ids = torch.zeros((4, tcfg.max_position_embeddings), dtype=torch.long, device="cuda")
    for row, length in enumerate((7, 12, 20, 33)):
        ids[row, 0] = 49406
        ids[row, 1:length - 1] = torch.randint(1, 49406, (length - 2,), generator=gen,
                                               device="cuda")
        ids[row, length - 1] = 49407
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        hidden, pooled = clip_text_forward(tparams, tcfg, ids)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t
    if (tuple(hidden.shape) != (4, 77, 768) or tuple(pooled.shape) != (4, 768)
            or not bool(torch.isfinite(hidden).all())):
        raise AssertionError(f"[clip-text] shapes {tuple(hidden.shape)}, {tuple(pooled.shape)} "
                             "or non-finite values")
    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    cfg32 = CLIPTextConfig(dtype=torch.float32)
    params32 = tree_map(lambda x: x.float(), tparams)
    rel32, rel16, vs32 = [], [], []
    with torch.no_grad():
        pooled32 = clip_text_forward(params32, cfg32, ids)[1]
        for row in range(4):
            alone32 = clip_text_forward(params32, cfg32, ids[row:row + 1])[1][0]
            alone16 = clip_text_forward(tparams, tcfg, ids[row:row + 1])[1][0]
            rel32.append(rel(pooled32[row], alone32))
            rel16.append(rel(pooled[row], alone16))
            vs32.append(rel(alone16, alone32))
    del params32
    if not max(rel32) <= 1e-2:
        raise AssertionError(f"[clip-text] a float32 row differs from the prompt alone by "
                             f"{max(rel32)} relative (limit 1e-2)")

    vis = params["clip_vision_embedding"]["clip"]
    with torch.no_grad():
        pixels = clip_preprocess(torch.stack(images), cfg.vision.image_size)
        image_embeds = clip_pooled_output(vis, cfg.vision, clip_vision_forward(vis, cfg.vision,
                                                                                pixels))
        vproj = dense_init((cfg.vision.hidden_size, tcfg.projection_dim), torch.bfloat16, "cuda",
                           gen)
        tproj = dense_init((tcfg.hidden_size, tcfg.projection_dim), torch.bfloat16, "cuda", gen)
        logits = clip_similarity(image_embeds, pooled, vproj, tproj,
                                 torch.tensor(math.log(100.0), device="cuda")).float()
    if (tuple(logits.shape) != (len(images), 4) or not bool(torch.isfinite(logits).all())
            or float(logits.abs().max()) > 100.0 * 1.01):
        raise AssertionError(f"[clip-text] logits of shape {tuple(logits.shape)}: {logits}")
    if flash_attention.launches != 0:
        raise AssertionError(f"[clip-text] K1 launched {flash_attention.launches} times, want 0")
    log(f"[clip-text] clip_text_forward B4 x 77 (ViT-L/14 text, 12 layers, bf16): "
        f"{text_s * 1e3:.2f} ms; logits_per_image {tuple(logits.shape)} of the SDXL images in "
        f"[{float(logits.min()):.2f}, {float(logits.max()):.2f}]")
    log(f"[clip-text] pooled rows vs the prompt alone, relative: float32 "
        f"{[f'{r:.2e}' for r in rel32]} (limit 1e-2); bf16 {[f'{r:.2e}' for r in rel16]}; "
        f"bf16 alone vs float32 alone {[f'{r:.2e}' for r in vs32]}")
    return {"flash_fwd": flash_attention.launches}


CONTROLNET_STEPS, CONTROLNET_GUIDANCE = 50, 7.5  # controlnet_pipeline's defaults: DDIM, 7.5


def _edge_map(gen, side: int) -> torch.Tensor:
    """A seeded synthetic edge map ``[1, side, side, 3]`` in {0, 1}: the
    2-pixel outlines of 12 random rectangles."""
    img = torch.zeros((side, side), device="cuda")
    for _ in range(12):
        y0, x0 = torch.randint(0, side - 64, (2,), generator=gen, device="cuda").tolist()
        h, w = torch.randint(32, side // 2, (2,), generator=gen, device="cuda").tolist()
        y1, x1 = min(y0 + h, side - 2), min(x0 + w, side - 2)
        img[y0:y1 + 2, x0:x0 + 2] = img[y0:y1 + 2, x1:x1 + 2] = 1.0
        img[y0:y0 + 2, x0:x1 + 2] = img[y1:y1 + 2, x0:x1 + 2] = 1.0
    return img[None, :, :, None].expand(1, side, side, 3).contiguous()


def phase_controlnet(model, profile_dir: str | None = None) -> dict:
    """ControlNet on DreamLLM-7B's SD-2.1 head (its UNet's ``conv_out`` live
    since :func:`phase_t2i`) (``configs.controlnet_7b``,
    bf16, seeded; its zero convs and its embedder's last conv redrawn at
    their fan-in scale, so that the residuals are seen): the prompt pair of
    the t2i phase, a synthetic edge map at 512 px, ``controlnet_pipeline``
    (DDIM 50 steps, guidance 7.5) at conditioning scale 1 and 0, and
    ``sd_head_pipeline`` with the same settings and start latents, in the
    order plain, scale 1, scale 0, plain, scale 1 (the last one timed).
    Checks: the scale-1 image differs from the plain one; the scale-0 image
    is within the two plain runs' own distance of the plain one (and whether
    the bits are equal is logged); K1 launches 14 a ControlNet step (10 in
    the UNet, 4 in the encoder at 64x64 and 32x32), 10 a plain step.
    ``profile_dir``: then profile one CFG step, ControlNet and UNet (kernel
    sums only)."""
    from dreamllm_tpu_torch.configs import controlnet_7b
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.models.dreamllm import encode_prompt_embeds
    from dreamllm_tpu_torch.models.sd.controlnet import init_controlnet_params
    from dreamllm_tpu_torch.models.sd.head import controlnet_pipeline, sd_head_pipeline
    from dreamllm_tpu_torch.ops.attention import flash_attention

    params, cfg, head, head_cfg = model
    ccfg = controlnet_7b(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    with torch.no_grad():
        cn = init_controlnet_params(ccfg, generator=gen, device="cuda")
        for conv in cn["zero_convs"] + [cn["mid_zero_conv"], cn["cond_embedding"]["conv_out"]]:
            _redraw_conv(conv, gen)
    torch.cuda.synchronize()
    log(f"[controlnet] {sum(t.numel() for t in _leaves(cn)) / 1e9:.3f} B parameters built in "
        f"{time.perf_counter() - t0:.2f} s; {len(cn['zero_convs'])} zero convs + the mid one")
    side, lat = _head_side(head_cfg), head_cfg.unet.sample_size
    control = _edge_map(gen, side)
    latents = torch.randn((1, lat, lat, head_cfg.unet.in_channels), generator=gen, device="cuda")
    tok = ToyTokenizer()
    with torch.no_grad():
        cond = encode_prompt_embeds(params, cfg, tok, T2I_PROMPT + POSITIVE_SUFFIX)
        neg = encode_prompt_embeds(params, cfg, tok, NEGATIVE_PROMPT)
    unet_sites = unet_flash_sites(head_cfg.unet, 2, cfg.n_dream_queries)[0]
    cn_sites = controlnet_flash_sites(ccfg.unet, 2, cfg.n_dream_queries)

    def run(scale):
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t = time.perf_counter()
        with torch.no_grad():
            if scale is None:
                img = sd_head_pipeline(head, head_cfg, cond, neg, gen, height=side, width=side,
                                       num_inference_steps=CONTROLNET_STEPS,
                                       guidance_scale=CONTROLNET_GUIDANCE, sampler="ddim",
                                       latents=latents)
            else:
                img = controlnet_pipeline(head, head_cfg, cn, ccfg, control, cond, neg, gen,
                                          num_inference_steps=CONTROLNET_STEPS,
                                          guidance_scale=CONTROLNET_GUIDANCE,
                                          conditioning_scale=scale, latents=latents)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        want = CONTROLNET_STEPS * (unet_sites + (0 if scale is None else cn_sites))
        if flash_attention.launches != want:
            raise AssertionError(f"[controlnet] scale {scale}: K1 launched "
                                 f"{flash_attention.launches} times, want {want}")
        _check_image(img[0], "controlnet", (side, side, 3))
        return img[0], wall, flash_attention.launches

    torch.cuda.reset_peak_memory_stats()
    plain_a, plain_s, _ = run(None)
    cn_a, cn_first_s, cn_launches = run(1.0)
    zero, _, _ = run(0.0)
    plain_b, _, _ = run(None)
    cn_b, cn_s, _ = run(1.0)
    peak = torch.cuda.max_memory_allocated()
    if profile_dir:
        from dreamllm_tpu_torch.models.projector import projector_forward
        from dreamllm_tpu_torch.models.sd.controlnet import controlnet_forward
        from dreamllm_tpu_torch.models.sd.unet import unet_forward

        with torch.no_grad():
            ctx = projector_forward(head["projector"], head_cfg.projector_cfg(),
                                    torch.cat([neg, cond], dim=0))
            lat_in = torch.cat([latents, latents], dim=0).to(ctx.dtype)
            tt = torch.full((2,), 500, device="cuda")
            cimg2 = torch.cat([control, control], dim=0)

            def step():
                down, mid = controlnet_forward(cn, ccfg, lat_in, tt, ctx, cimg2)
                return unet_forward(head["unet"], head_cfg.unet, lat_in, tt, ctx,
                                    down_block_residuals=down, mid_block_residual=mid)

            _profile(step, "controlnet_cfg_step", profile_dir, trace=False, top=12)
    plain_gap = (plain_a - plain_b).abs().max().item()
    zero_gap = max((zero - plain_a).abs().max().item(), (zero - plain_b).abs().max().item())
    moved = (cn_a - plain_a).abs().mean().item()
    if not zero_gap <= plain_gap:
        raise AssertionError(f"[controlnet] scale 0 is {zero_gap} from the plain image, two plain "
                             f"runs {plain_gap} from each other")
    if not moved > 1e-3:
        raise AssertionError(f"[controlnet] the ControlNet image is {moved} (mean |delta|) from "
                             "the plain one: the residuals are not seen")
    log(f"[controlnet] controlnet_pipeline {cn_s:.3f} s for one {side}x{side} image "
        f"({CONTROLNET_STEPS} ddim steps, guidance {CONTROLNET_GUIDANCE}, CFG batch 2; the "
        f"first run {cn_first_s:.3f} s); sd_head_pipeline alone {plain_s:.3f} s; K1 "
        f"{cn_launches} a run ({unet_sites} + {cn_sites} a step); peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[controlnet] scale 1 vs plain: mean |delta| {moved:.4e}; scale 0 vs plain: max |delta| "
        f"{zero_gap:.3e} ({'equal bits' if torch.equal(zero, plain_a) else 'not equal bits'}), "
        f"plain vs plain {plain_gap:.3e} "
        f"({'equal bits' if torch.equal(plain_a, plain_b) else 'not equal bits'}); scale 1 "
        f"twice: {'equal bits' if torch.equal(cn_a, cn_b) else 'not equal bits'}")
    return {"flash_fwd": cn_launches}


# ---------------------------------------------------------------------------
# Training phases
# ---------------------------------------------------------------------------

FROZEN = ("clip_vision_embedding/clip", "sd_head/unet", "sd_head/vae")  # the SFT recipe


def _joint_batch(cfg, gen, *, batch, seq, image_px, dream_px, dtype, device):
    """``batch`` rows of ``seq`` tokens: one input image span and one dream
    span each (no dream span for a model without dream queries: LLaVA),
    labels on the text only; the last row is packed from two segments and
    ends in a padding tail."""
    st = cfg.special_tokens
    n_img, n_q = cfg.image_embed_len, cfg.n_dream_queries
    ids = torch.randint(10, 31000, (batch, seq), generator=gen, device=device)
    labels = ids.clone()
    img_at, dream_at = 9, 9 + n_img + 30
    ids[:, 0] = st.bos
    ids[:, img_at - 1], ids[:, img_at + n_img] = st.im_start, st.im_end
    ids[:, img_at:img_at + n_img] = st.im_patch
    labels[:, img_at - 1:img_at + n_img + 1] = -100
    if n_q:
        ids[:, dream_at - 1], ids[:, dream_at + n_q] = st.dream_start, st.dream_end
        ids[:, dream_at:dream_at + n_q] = st.dream
        labels[:, dream_at - 1:dream_at + n_q + 1] = -100
    seg = torch.ones((batch, seq), dtype=torch.int32, device=device)
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None].repeat(batch, 1)
    cut, pad = seq * 5 // 8, seq // 40  # second segment and padding tail of the last row
    seg[-1, cut:seq - pad] = 2
    seg[-1, seq - pad:] = 0
    pos[-1, cut:] = torch.arange(seq - cut, dtype=torch.int32, device=device)
    labels[-1, seq - pad:] = -100
    vs = cfg.vision.image_size
    out = {
        "input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos,
        "images": torch.randn((batch, 1, vs, vs, 3), generator=gen, device=device).to(dtype),
        "image_positions": torch.full((batch, 1), img_at, device=device),
    }
    if n_q:
        out["dream_positions"] = torch.full((batch, 1), dream_at, device=device)
        out["images_dm"] = (torch.rand((batch, 1, dream_px, dream_px, 3), generator=gen,
                                       device=device) * 2 - 1).to(dtype)
    return out


def _train_setup(cfg, head_cfg, params, device, opt_kw, wrap_tx=None, *, frozen=FROZEN,
                 head_loss_fn=None):
    """The training entry points assembled as a user would: freeze mask ->
    optimizer -> state -> train step. ``wrap_tx`` may wrap the optimizer the
    step calls (the state is initialised from the unwrapped one).
    ``frozen``: the recipe's frozen prefixes (the SFT recipe's by default);
    ``head_loss_fn``: the diffusion head's loss (default: the SD head's of
    ``head_cfg``; none when ``head_cfg`` is None)."""
    import dataclasses

    from dreamllm_tpu_torch.models.dreamllm import param_freeze_mask
    from dreamllm_tpu_torch.models.sd.head import make_head_loss_fn
    from dreamllm_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from dreamllm_tpu_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(cfg, frozen=frozen)
    if head_loss_fn is None and head_cfg is not None:
        head_loss_fn = make_head_loss_fn(head_cfg)
    mask = param_freeze_mask(params, cfg)
    tx = make_optimizer(OptimizerConfig(**opt_kw), trainable_mask=mask)
    state = init_train_state(params, tx, device=device)
    step_fn = make_train_step(cfg, wrap_tx(tx) if wrap_tx else tx, head_loss_fn=head_loss_fn,
                              remat=True, use_flash=True, trainable_mask=mask, device=device)
    return cfg, mask, tx, state, step_fn


def phase_small_train() -> None:
    """Three tiny float32 joint train steps (8-bit AdamW; on the card its
    float32 leaves go through the fused kernel) on the card against the same
    on the CPU: loss and grad_norm within 1e-3 relative (float32 products on
    both, summed in other orders; steps 2 and 3 also carry the updates)."""
    from dreamllm_tpu_torch.models.dreamllm import init_dreamllm_params
    from dreamllm_tpu_torch.models.sd.head import init_sd_head_params
    from dreamllm_tpu_torch.train.optim8bit import adam8bit_update_cuda

    cfg, head_cfg = _tiny_configs()
    gen = torch.Generator().manual_seed(5)
    params = init_dreamllm_params(cfg, generator=gen, device="cpu")
    params["sd_head"] = init_sd_head_params(head_cfg, generator=gen, device="cpu")
    batch = _joint_batch(cfg, gen, batch=2, seq=64, image_px=32, dream_px=16,
                         dtype=torch.float32, device="cpu")
    draws = []
    for _ in range(3):
        lat = (2, 8, 8, 4)
        draws.append({"vae_eps": torch.randn(lat, generator=gen),
                      "noise": torch.randn(lat, generator=gen),
                      "t": torch.randint(0, 1000, (2,), generator=gen),
                      "drop": torch.zeros((2, 1, 1), dtype=torch.bool)})
    opt_kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=100, optimizer_8bit=True,
                  min_8bit_size=256, fused_update=True, eps=1e-5)

    def run(device):
        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [move(v) for v in tree]
            return tree.to(device)

        _, _, _, state, step_fn = _train_setup(cfg, head_cfg, move(params), device, opt_kw)
        out = []
        for d in draws:
            state, aux = step_fn(state, move(batch), None, move(d))
            out.append((float(aux["loss"]), float(aux["grad_norm"]), float(aux["update_skipped"])))
        return out

    before = adam8bit_update_cuda.launches
    ref, got = run("cpu"), run("cuda")
    if adam8bit_update_cuda.launches == before:
        raise AssertionError("[small-train] the fused AdamW kernel did not launch on the card")
    for i, (r, g) in enumerate(zip(ref, got)):
        for name, a, b in zip(("loss", "grad_norm"), g, r):
            if not abs(a - b) <= 1e-3 * abs(b):
                raise AssertionError(f"[small-train] step {i + 1} {name}: card {a} vs CPU {b}")
        if g[2] != 0.0 or r[2] != 0.0:
            raise AssertionError(f"[small-train] step {i + 1} was skipped")
    log(f"[small-train] card == CPU over 3 steps: loss {[round(g[0], 5) for g in got]}, "
        f"grad_norm {[round(g[1], 5) for g in got]}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


SMALL_QUANT_SEED = 24  # its CPU run's smallest top-2 margin is 6.4e-3


def phase_small_quant() -> None:
    """A tiny float32 int4 decoder (hidden 256, vocab 1024: every projection
    and the head inside the w4a16 gate) on the card against the same on the
    CPU: ``generate_text`` at batch 1 and 8 (fused layout) and the engine
    with 4 slots answering 6 requests (unfused, as serve.py builds it) give
    the same greedy tokens. A near-tie would make that a coin toss, so the
    CPU run's top-2 logit margins must exceed 1e-3, ten times the float32
    tolerance of the parity tests (test_torch_generation.py)."""
    import threading

    import dreamllm_tpu_torch.generation.sampler as sampler
    import dreamllm_tpu_torch.serve.engine as engine
    from dreamllm_tpu_torch.models.llama import LlamaConfig, fuse_llama_params, init_llama_params
    from dreamllm_tpu_torch.ops.quant4 import quantize_llama_params_int4, w4_matmul_cuda

    cfg = LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    gen = torch.Generator().manual_seed(SMALL_QUANT_SEED)
    dense = init_llama_params(cfg, generator=gen, device="cpu")
    fused = quantize_llama_params_int4(fuse_llama_params(dense))
    unfused = quantize_llama_params_int4(dense)
    lens = torch.randint(10, 41, (8,), generator=gen)
    ids = torch.zeros((8, int(lens.max())), dtype=torch.long)
    for i, n in enumerate(lens.tolist()):
        ids[i, :n] = torch.randint(3, 1024, (n,), generator=gen)
    budgets = torch.randint(8, 17, (6,), generator=gen).tolist()
    scfg = sampler.SamplingConfig(greedy=True, max_new_tokens=16, eos_token_id=-1)
    ecfg = engine.EngineConfig(slots=4, prefill_len=32, max_len=128, chunk_steps=4)

    def run(device, margins):
        real = sampler.llama_logits

        def spy(*a):
            out = real(*a)
            if margins is not None:
                top2 = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
                margins.append(float((top2[:, 0] - top2[:, 1]).min()))
            return out

        sampler.llama_logits = engine.llama_logits = spy
        try:
            p_f, p_u = _to_device(fused, device), _to_device(unfused, device)
            texts = [sampler.generate_text(p_f, cfg, ids[:b], lens[:b], scfg,
                                           device=device)["tokens"].cpu().tolist()
                     for b in (1, 8)]
            eng = engine.ContinuousBatchingEngine(
                p_u, cfg, sampler.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1),
                ecfg, device=device).start()
            answers = [None] * len(budgets)

            def ask(i):
                answers[i] = eng.submit(ids[i, :lens[i]].tolist(), max_new_tokens=budgets[i])

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(budgets))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            eng.stop()
            return texts, answers
        finally:
            sampler.llama_logits = engine.llama_logits = real

    margins: list[float] = []
    ref = run("cpu", margins)
    if not min(margins) > 1e-3:
        raise AssertionError(f"[small-int4] a near-tie on the CPU: top-2 margin {min(margins)}")
    before = w4_matmul_cuda.launches
    got = run("cuda", None)
    if w4_matmul_cuda.launches == before:
        raise AssertionError("[small-int4] the w4a16 kernel did not launch on the card")
    if got != ref or any(a is None or len(a) != n for a, n in zip(got[1], budgets)):
        raise AssertionError(f"[small-int4] card {got} vs CPU {ref}")
    log(f"[small-int4] card == CPU: generate_text batch 1 and 8 ({scfg.max_new_tokens} tokens "
        f"a row), engine 4 slots x 6 requests ({sum(budgets)} tokens); smallest top-2 margin "
        f"{min(margins):.3e}; w4a16 launches {w4_matmul_cuda.launches - before}")


SMALL_QLORA_SEED = 31  # its CPU run's smallest top-2 margin: see the [small-qlora] line


def _qlora_step_fn(base, cfg, lcfg, tx):
    """The QLoRA train step, assembled from the port's entry points as a
    user would (JAX has no LoRA train-step factory, and the port adds none):
    next-token cross-entropy over the cache-free decoder (flash attention,
    full remat) through ``qlora_loss_fn``, then ``tx`` on the factors.
    Returns ``(step, lm_loss)``; ``step(lora, opt_state, tokens) -> (lora,
    opt_state, loss)``."""
    import torch.nn.functional as F

    from dreamllm_tpu_torch.models.llama import llama_forward, llama_logits
    from dreamllm_tpu_torch.train.lora import qlora_loss_fn
    from dreamllm_tpu_torch.train.optim import apply_updates
    from dreamllm_tpu_torch.train.tree import tree_map

    def lm_loss(params, tokens, rng):
        h = llama_forward(params, cfg, input_ids=tokens, use_flash=True,
                          remat=True)["last_hidden_state"]
        logits = llama_logits(params, cfg, h)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))

    loss_fn = qlora_loss_fn(base, lcfg, lm_loss)

    def step(lora, opt_state, tokens):
        lora = tree_map(lambda x: x.detach().requires_grad_(True), lora)
        loss = loss_fn(lora, tokens, None)
        loss.backward()
        with torch.no_grad():
            updates, opt_state = tx.update(tree_map(lambda x: x.grad, lora), opt_state, lora)
            lora = apply_updates(lora, updates)
        return lora, opt_state, loss.detach()

    return step, lm_loss


def phase_small_qlora() -> None:
    """A tiny float32 int4 decoder (as the small int4 phase's) with a rank-8
    LoRA adapter attached (``b`` drawn nonzero, so the correction is live)
    on the card against the same on the CPU: ``generate_text`` at batch 1
    and 8; the engine with the prefix cache (4 requests sharing a two-chunk
    prefix, then one prompt by ids and by its embeddings); a
    ``DynamicBatcher``-backed ``ModelServer`` answering 4 concurrent HTTP
    requests; all give the same greedy tokens, with the CPU run's top-2
    margins above 1e-3 as in the small int4 phase. Then one QLoRA step
    (8-bit AdamW: on the card the float32 factors go through the fused
    kernel): loss and every factor within 1e-3 relative, the tolerance of
    the small train phase."""
    import concurrent.futures as cf

    import dreamllm_tpu_torch.generation.sampler as sampler
    import dreamllm_tpu_torch.serve.engine as engine
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from dreamllm_tpu_torch.ops.quant4 import quantize_llama_params_int4, w4_matmul_cuda
    from dreamllm_tpu_torch.serve.batching import make_batched_generate_fn
    from dreamllm_tpu_torch.serve.server import ModelServer, OnlineClient
    from dreamllm_tpu_torch.train.lora import LoRAConfig, attach_lora, init_lora_params
    from dreamllm_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from dreamllm_tpu_torch.train.optim8bit import adam8bit_update_cuda
    from dreamllm_tpu_torch.train.tree import tree_leaves

    cfg = LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    gen = torch.Generator().manual_seed(SMALL_QLORA_SEED)
    base = quantize_llama_params_int4(init_llama_params(cfg, generator=gen, device="cpu"))
    lcfg = LoRAConfig()
    lora = init_lora_params(base, lcfg, generator=gen)
    for layer in lora["layers"]:
        for f in layer.values():
            f["b"] = torch.randn(f["b"].shape, generator=gen) * 0.05
    lens = torch.randint(10, 41, (8,), generator=gen)
    ids = torch.zeros((8, int(lens.max())), dtype=torch.long)
    for i, k in enumerate(lens.tolist()):
        ids[i, :k] = torch.randint(3, 1024, (k,), generator=gen)
    prefix = [1] + torch.randint(3, 1024, (63,), generator=gen).tolist()  # two 32-token chunks
    tails = [torch.randint(3, 1024, (k,), generator=gen).tolist() for k in (5, 9, 14, 20)]
    budgets = [8, 12, 10, 16]
    emb_ids = [1] + torch.randint(3, 1024, (40,), generator=gen).tolist()  # two chunks
    texts_in = [" ".join(f"w{j}" for j in torch.randint(0, 500, (k,), generator=gen).tolist())
                for k in (6, 9, 12, 15)]
    tokens = torch.randint(3, 1024, (2, 48), generator=gen)
    scfg = sampler.SamplingConfig(greedy=True, max_new_tokens=16, eos_token_id=-1)
    ecfg = engine.EngineConfig(slots=4, prefill_len=32, max_len=128, chunk_steps=4,
                               prefix_cache_entries=2)

    def run(device, margins):
        real = sampler.llama_logits
        record = [margins is not None]

        def spy(*a):
            out = real(*a)
            if record[0]:
                top2 = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
                margins.append(float((top2[:, 0] - top2[:, 1]).min()))
            return out

        sampler.llama_logits = engine.llama_logits = spy
        try:
            base_d, lora_d = _to_device(base, device), _to_device(lora, device)
            att = attach_lora(base_d, lora_d, lcfg)
            texts = [sampler.generate_text(att, cfg, ids[:b], lens[:b], scfg,
                                           device=device)["tokens"].cpu().tolist()
                     for b in (1, 8)]
            eng = engine.ContinuousBatchingEngine(
                att, cfg, sampler.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1),
                ecfg, device=device)
            record[0], on = False, record[0]  # warmup's all-zero prompts pick nothing
            eng.warmup(embeds=True).start()
            record[0] = on
            try:
                with cf.ThreadPoolExecutor(4) as ex:
                    futs = [ex.submit(eng.submit, prefix + tails[i], max_new_tokens=budgets[i],
                                      timeout=300) for i in range(4)]
                    answers = [f.result(timeout=300) for f in futs]
                by_ids = eng.submit(emb_ids, max_new_tokens=8, timeout=300)
                emb = att["embed_tokens"][torch.tensor(emb_ids, device=device)]
                by_embeds = eng.submit(prompt_embeds=emb, max_new_tokens=8, timeout=300)
                counts = (eng.prefix_hits, eng.prefix_misses)
            finally:
                eng.stop()
            batch_fn = make_batched_generate_fn(att, cfg, ToyTokenizer(vocab_size=1024),
                                                batch_size=4, max_prompt_len=32, max_new_tokens=8,
                                                eos_token_id=-1, device=device)
            server = ModelServer(generate_batch_fn=batch_fn, max_batch=4, batch_window_ms=200,
                                 port=0).start()
            try:
                client = OnlineClient(f"http://127.0.0.1:{server.port}", timeout=300)
                with cf.ThreadPoolExecutor(4) as ex:
                    http = list(ex.map(client.generate, texts_in, timeout=300))
            finally:
                server.stop()
            tx = make_optimizer(OptimizerConfig(learning_rate=1e-3, schedule="constant",
                                                optimizer_8bit=True, min_8bit_size=256,
                                                fused_update=True))
            step, _ = _qlora_step_fn(base_d, cfg, lcfg, tx)
            new, _, loss = step(lora_d, tx.init(lora_d), tokens.to(device))
            trained = (float(loss), [t.cpu() for t in tree_leaves(new)])
            return (texts, answers, by_ids, by_embeds, counts, http), trained
        finally:
            sampler.llama_logits = engine.llama_logits = real

    margins: list[float] = []
    ref, ref_train = run("cpu", margins)
    if not min(margins) > 1e-3:
        raise AssertionError(f"[small-qlora] a near-tie on the CPU: top-2 margin {min(margins)}")
    w4_before, adam_before = w4_matmul_cuda.launches, adam8bit_update_cuda.launches
    got, got_train = run("cuda", None)
    if w4_matmul_cuda.launches == w4_before or adam8bit_update_cuda.launches == adam_before:
        raise AssertionError("[small-qlora] the w4a16 or the fused AdamW kernel did not launch")
    texts, answers, by_ids, by_embeds, counts, http = got
    if (got != ref or by_ids != by_embeds or counts != (3, 2)
            or any(len(a) != k for a, k in zip(answers, budgets))):
        raise AssertionError(f"[small-qlora] card {got} vs CPU {ref}")
    if not abs(got_train[0] - ref_train[0]) <= 1e-3 * abs(ref_train[0]):
        raise AssertionError(f"[small-qlora] QLoRA loss: card {got_train[0]} vs CPU {ref_train[0]}")
    worst = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(got_train[1], ref_train[1]))
    if not worst <= 1e-3:
        raise AssertionError(f"[small-qlora] QLoRA factors after one step: card vs CPU {worst}")
    log(f"[small-qlora] card == CPU: generate_text batch 1 and 8, engine with the prefix cache "
        f"(hits, misses {counts}; the embeddings prompt gives the ids prompt's tokens), "
        f"DynamicBatcher server x 4 HTTP requests; smallest top-2 margin {min(margins):.3e}; "
        f"one QLoRA step: loss {got_train[0]:.6f} (CPU {ref_train[0]:.6f}), factors within "
        f"{worst:.2e} of the largest; w4a16 launches {w4_matmul_cuda.launches - w4_before}, "
        f"adam8bit {adam8bit_update_cuda.launches - adam_before}")


SMALL_VARIANTS_SEED = 31  # its CPU run's smallest margin is 1.37e-3
# Beam scores (a sum of 12 steps' log-probs) on the card against the CPU, as
# a share of the largest: the small QLoRA phase's loss limit. The card's
# w4a16 kernel sums in another order than its plain version (rel-RMS up to
# 3e-5 a product at 8 rows), which moves a score of -4 by about 5e-4.
SMALL_SCORE_REL = 1e-3


def _margin_spies(sampler, engine, margins):
    """Record, on the CPU run, every ``llama_logits`` call's smallest top-1
    minus top-2 gap and every beam step's gap between its k-th and (k+1)-th
    candidate (where a beam enters or leaves). Returns the undo function."""
    real_logits, real_top = sampler.llama_logits, sampler._top_k_stable

    def logits_spy(*a):
        out = real_logits(*a)
        top2 = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return out

    def top_spy(x, k):
        if x.shape[-1] > k:
            top = x.topk(k + 1, dim=-1).values
            margins.append(float((top[..., k - 1] - top[..., k]).min()))
        return real_top(x, k)

    sampler.llama_logits = engine.llama_logits = logits_spy
    sampler._top_k_stable = top_spy

    def undo():
        sampler.llama_logits = engine.llama_logits = real_logits
        sampler._top_k_stable = real_top
    return undo


def phase_small_decode_variants() -> None:
    """The decoding variants on a tiny float32 int4 decoder (as the small
    int4 phase's: every projection and the head inside the w4a16 gate), the
    card against the CPU: ``beam_search`` (4 beams at batch 2: 8 rows),
    ``generate_text_speculative`` (draft 7: an 8-row verify window) on a
    repetitive and a random prompt, and the speculative engine (2 slots, k
    3: 8 rows a verify forward; every chunk drafts) answering 4 requests
    give the same tokens, beam scores within ``SMALL_SCORE_REL``; the CPU
    run's top-2 margins (and beam entry gaps) above 1e-3, the near-tie rule
    of the small int4 phase. On the card, sampled requests answer the same through the
    adaptive speculative engine and the plain one (the CPU's generators draw
    other numbers than the card's). Last, a tiny DreamLLM's ``run_vqa`` with
    2 beams at batch 2 gives the same predictions on the card and the CPU."""
    import concurrent.futures as cf

    import dreamllm_tpu_torch.generation.sampler as sampler
    import dreamllm_tpu_torch.serve.engine as engine
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.eval.vqa import run_vqa
    from dreamllm_tpu_torch.models.dreamllm import init_dreamllm_params
    from dreamllm_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from dreamllm_tpu_torch.ops.quant4 import quantize_llama_params_int4, w4_matmul_cuda

    cfg = LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    gen = torch.Generator().manual_seed(SMALL_VARIANTS_SEED)
    base = quantize_llama_params_int4(init_llama_params(cfg, generator=gen, device="cpu"))
    chunk = torch.randint(3, 1024, (12,), generator=gen).tolist()
    repetitive = [1] + chunk * 3
    random_p = [1] + torch.randint(3, 1024, (36,), generator=gen).tolist()
    beam_ids = torch.tensor([repetitive[:30], random_p[:30]])
    beam_lens = torch.tensor([30, 24])
    budgets = [24, 20, 16, 24]
    reqs = [repetitive, random_p, repetitive[:20], random_p[:25]]
    scfg = sampler.SamplingConfig(greedy=True, max_new_tokens=24, eos_token_id=-1)
    ecfg = engine.EngineConfig(slots=2, prefill_len=32, max_len=128, chunk_steps=4,
                               speculative_k=3, speculative_adaptive=False)

    def serve(eng, kw=None):
        eng.start()
        try:
            with cf.ThreadPoolExecutor(len(reqs)) as ex:
                futs = [ex.submit(eng.submit, r, max_new_tokens=n, timeout=300, **(kw or {}))
                        for r, n in zip(reqs, budgets)]
                return [f.result(timeout=300) for f in futs]
        finally:
            eng.stop()

    def run(device):
        p = _to_device(base, device)
        beams = sampler.beam_search(p, cfg, beam_ids, beam_lens, num_beams=4, max_new_tokens=12,
                                    eos_token_id=-1, device=device)
        spec = [sampler.generate_text_speculative(p, cfg, torch.tensor([q]), torch.tensor([len(q)]),
                                                  scfg, draft_len=7, device=device)
                for q in (repetitive, random_p)]
        answers = serve(engine.ContinuousBatchingEngine(
            p, cfg, sampler.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1), ecfg,
            device=device))
        return ([beams["tokens"].cpu().tolist(), beams["scores"].cpu()],
                [[o["tokens"].cpu().tolist(), o["steps"], o["accepted"]] for o in spec], answers)

    margins: list[float] = []
    undo = _margin_spies(sampler, engine, margins)
    try:
        ref = run("cpu")
    finally:
        undo()
    if not min(margins) > 1e-3:
        raise AssertionError(f"[small-variants] a near-tie on the CPU: margin {min(margins)}")
    before = w4_matmul_cuda.launches
    got = run("cuda")
    if w4_matmul_cuda.launches == before:
        raise AssertionError("[small-variants] the w4a16 kernel did not launch on the card")
    score_err = (got[0][1] - ref[0][1]).abs().max().item()
    score_tol = SMALL_SCORE_REL * ref[0][1].abs().max().item()
    if got[0][0] != ref[0][0] or not score_err <= score_tol or got[1:] != ref[1:]:
        raise AssertionError(f"[small-variants] card {got} vs CPU {ref}")
    # sampled requests on the card: the adaptive speculative engine against the plain one
    p = _to_device(base, "cuda")
    samp = {"temperature": 0.3, "top_k": 4, "seed": 11}
    sampled = [serve(engine.ContinuousBatchingEngine(
        p, cfg, sampler.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1),
        engine.EngineConfig(slots=2, prefill_len=32, max_len=128, chunk_steps=4,
                            speculative_k=k), device="cuda"), samp) for k in (0, 3)]
    if sampled[0] != sampled[1]:
        raise AssertionError(f"[small-variants] sampled answers, plain {sampled[0]} vs "
                             f"speculative {sampled[1]}")
    (_, steps_r, acc_r), (_, steps_n, acc_n) = got[1]
    log(f"[small-variants] card == CPU: beam_search 4 beams x batch 2 (score max-abs "
        f"{score_err:.1e}, limit {score_tol:.1e}), speculative draft 7 (repetitive: {steps_r} "
        f"verify steps, {acc_r} drafts accepted; random: {steps_n} steps, {acc_n} accepted), speculative engine 2 slots "
        f"x 4 requests ({sum(budgets)} tokens); sampled answers equal through the adaptive "
        f"speculative engine and the plain one on the card; smallest margin {min(margins):.3e}; "
        f"w4a16 launches {w4_matmul_cuda.launches - before}")

    # run_vqa with 2 beams on a tiny DreamLLM
    dcfg, _ = _tiny_configs()
    dparams = init_dreamllm_params(dcfg, generator=gen, device="cpu")
    tok = ToyTokenizer(vocab_size=dcfg.llm.vocab_size)
    samples = [{"id": i, "question": f"what is in image {i}?", "answers": ["tok12"] * 10,
                "image": torch.rand((48, 48, 3), generator=gen).numpy()} for i in range(4)]
    vmargins: list[float] = []
    undo = _margin_spies(sampler, engine, vmargins)
    try:
        vref = run_vqa(dparams, dcfg, tok, samples, max_new_tokens=6, batch_size=2, num_beams=2,
                       device="cpu")
    finally:
        undo()
    if not min(vmargins) > 1e-3:
        raise AssertionError(f"[small-variants] run_vqa: a near-tie on the CPU: {min(vmargins)}")
    vgot = run_vqa(_to_device(dparams, "cuda"), dcfg, tok, samples, max_new_tokens=6,
                   batch_size=2, num_beams=2, device="cuda")
    if vgot != vref:
        raise AssertionError(f"[small-variants] run_vqa card {vgot} vs CPU {vref}")
    log(f"[small-variants] run_vqa 2 beams x batch 2, 4 samples: card == CPU (score "
        f"{vgot['score']}); smallest margin {min(vmargins):.3e}")


def _level_q_shape(unet_cfg, level: int, batch: int) -> tuple:
    """The query shape of the attentions of ``level`` at ``sample_size``
    latents."""
    side = unet_cfg.sample_size >> level
    heads = unet_cfg.num_attention_heads[level]
    return (batch, side * side, heads, unet_cfg.block_out_channels[level] // heads)


def _level_flash_sites(unet_cfg, level: int, batch: int, ctx_len: int) -> int:
    """Attentions that pass the flash rule in one attention block of
    ``level`` at ``sample_size`` latents: per transformer layer its spatial
    self-attention and its cross-attention over ``ctx_len`` context tokens
    (64 dream queries stay outside the rule; SDXL's 196 pass it)."""
    from dreamllm_tpu_torch.ops.attention import flash_eligible

    q = _level_q_shape(unet_cfg, level, batch)
    kv = (batch, ctx_len) + q[2:]
    return unet_cfg.transformer_layers_per_block[level] * (flash_eligible(q, q)
                                                           + flash_eligible(q, kv))


def unet_flash_sites(unet_cfg, batch: int, ctx_len: int) -> tuple[int, bool]:
    """How many of the UNet's attentions pass the flash rule at
    ``sample_size`` latents and ``ctx_len`` context tokens (per transformer
    layer of every attention block: its self-attention and its
    cross-attention, each where its shapes pass), and whether the UNet's
    very first self-attention is one of them."""
    from dreamllm_tpu_torch.ops.attention import flash_eligible

    sites = 0
    n = len(unet_cfg.block_out_channels)
    for i, btype in enumerate(unet_cfg.down_block_types):
        per_block = _level_flash_sites(unet_cfg, i, batch, ctx_len)
        if btype == "CrossAttnDownBlock2D":
            sites += unet_cfg.layers_per_block * per_block          # the down block
        if unet_cfg.up_block_types[n - 1 - i] == "CrossAttnUpBlock2D":
            sites += (unet_cfg.layers_per_block + 1) * per_block    # its mirror up block
    sites += _level_flash_sites(unet_cfg, n - 1, batch, ctx_len)    # mid
    q = _level_q_shape(unet_cfg, 0, batch)
    first = unet_cfg.down_block_types[0] == "CrossAttnDownBlock2D" and flash_eligible(q, q)
    return sites, first


def controlnet_flash_sites(unet_cfg, batch: int, ctx_len: int) -> int:
    """The flash sites of a ControlNet's encoder over ``unet_cfg``: those of
    the UNet's cross-attention down blocks and of its mid block."""
    n = len(unet_cfg.block_out_channels)
    return (sum(unet_cfg.layers_per_block * _level_flash_sites(unet_cfg, i, batch, ctx_len)
                for i, btype in enumerate(unet_cfg.down_block_types)
                if btype == "CrossAttnDownBlock2D")
            + _level_flash_sites(unet_cfg, n - 1, batch, ctx_len))


def unet_shallow_flash_sites(unet_cfg, batch: int, ctx_len: int) -> int:
    """How many of DeepCache's shallow forward's attentions pass the flash
    rule: those of the first down block and of the last up block, both at
    the first level (``sample_size`` latents)."""
    per_block = _level_flash_sites(unet_cfg, 0, batch, ctx_len)
    sites = 0
    if unet_cfg.down_block_types[0] == "CrossAttnDownBlock2D":
        sites += unet_cfg.layers_per_block * per_block
    if unet_cfg.up_block_types[-1] == "CrossAttnUpBlock2D":
        sites += (unet_cfg.layers_per_block + 1) * per_block
    return sites


def pipeline_flash_launches(unet_cfg, steps: int, deepcache_interval: int,
                            ctx_len: int) -> int:
    """Flash launches of one CFG pipeline run over ``ctx_len`` context
    tokens: the full UNet's sites on the steps ``i % k == 0`` (every step at
    interval 1), the shallow forward's on the others."""
    full = sum(1 for i in range(steps) if deepcache_interval <= 1 or i % deepcache_interval == 0)
    return (full * unet_flash_sites(unet_cfg, 2, ctx_len)[0]
            + (steps - full) * unet_shallow_flash_sites(unet_cfg, 2, ctx_len))


def _train_run(label: str, cfg, head_cfg, box: list, *, opt_kw: dict, frozen: tuple,
               head_loss_fn, batch: dict, steps: int, gen, flash_unet) -> dict:
    """``steps`` train steps through ``Trainer.train`` on the parameters in
    ``box`` (a one-element list, emptied, so that the caller keeps no
    reference to the first step's superseded parameters), frozen by
    ``frozen``, with full decoder remat and ``opt_kw``'s optimizer. Checks:
    every loss, ``lm``/``vm`` term and gradient norm finite, no update
    skipped, every emitted update finite and nonzero and applied wherever it
    exceeds half an ulp of its parameter, every frozen parameter unchanged
    bit for bit, the final checkpoint asked for once (recorded, not
    written), and the kernels' launches equal to the counts from the
    configuration: K1 twice and K2 once a decoder layer (remat reruns each
    layer's forward), plus ``flash_unet = (forward, backward)`` sites of
    the UNet, and K4 once per 8-bit moment leaf, each a step. Returns what
    it measured."""
    from dreamllm_tpu_torch.ops.attention import flash_attention, flash_attention_bwd_cuda
    from dreamllm_tpu_torch.train.optim import GradientTransformation, adam_state
    from dreamllm_tpu_torch.train.optim8bit import _Moment, adam8bit_update_cuda
    from dreamllm_tpu_torch.train.trainer import Trainer, TrainerConfig
    from dreamllm_tpu_torch.train.tree import tree_leaves, tree_leaves_with_path, tree_map

    dev = "cuda"
    batch_rows, seq = batch["input_ids"].shape
    # every emitted update finite and nonzero, and every leaf moved wherever
    # an update exceeds half a bf16 ulp of its parameter (parameters are bf16
    # with no float32 master copy, as in the JAX package: at lr 4e-5 a norm
    # scale of exactly 1.0, ulp 2^-7, cannot move, and most elements of a
    # weight matrix do not either). Flags are gathered on the card and read
    # once at the end.
    flags = []

    def checked(tx):
        def update(grads, opt_state, params_, *, skip=None):
            updates, new_state = tx.update(grads, opt_state, params_, skip=skip)

            def check(u, p):
                if u is not None:
                    moved = ((p + u) != p).any()
                    must = (u.float().abs() > p.float().abs() * 2.0 ** -8).any()
                    flags.append(torch.stack([torch.isfinite(u).all(), (u != 0).any(),
                                              moved | ~must, moved]))

            tree_map(check, updates, params_)
            return updates, new_state

        return GradientTransformation(tx.init, update)

    cfg, mask, tx, state, step_fn = _train_setup(cfg, head_cfg, box.pop(), dev, opt_kw, checked,
                                                 frozen=frozen, head_loss_fn=head_loss_fn)
    moments = [m for m in tree_leaves(adam_state(state.opt_state)["m"]) if isinstance(m, _Moment)]
    flat_mask = dict(tree_leaves_with_path(mask))
    n_trainable = sum(p.numel() for path, p in tree_leaves_with_path(state.params)
                      if flat_mask[path])
    log(f"[{label}] {n_trainable / 1e9:.6f} B trainable parameters, {len(moments)} 8-bit "
        f"moment leaves ({sum(m.codes.numel() for m in moments) / 1e9:.6f} B codes each for "
        f"m and v)")

    frozen_leaves = [(path, p) for path, p in tree_leaves_with_path(state.params)
                     if not flat_mask[path]]

    def checksum(p):  # exact: the sum of the raw bit patterns
        return p.contiguous().view(torch.int16 if p.element_size() == 2 else torch.int32)\
            .long().sum()

    frozen_before = torch.stack([checksum(p) for _, p in frozen_leaves])

    class Data:
        def __iter__(self):
            while True:
                yield batch

    step_s, auxes = [], []

    class Clock:
        def __init__(self):
            self.t = None

        def on_step(self, trainer, step, aux):
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_s.append(now - self.t)
            self.t = now
            auxes.append(aux)

    clock = Clock()
    saves = []

    class RecordingTrainer(Trainer):
        """Records the steps it is asked to save instead of writing them: a
        7B checkpoint with the 8-bit state is about 30 GB."""

        def save(self, step):
            saves.append(step)

    trainer = RecordingTrainer(
        TrainerConfig(max_steps=steps, log_steps=1, save_steps=0, resume=False,
                      output_dir=f"runs/chip_smoke_{label}",
                      tokens_per_batch=batch_rows * seq),
        step_fn, Data(), state, generator=gen, callbacks=[clock], device=dev)
    del state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd_cuda.launches = 0
    adam8bit_update_cuda.launches = 0
    clock.t = time.perf_counter()
    final = trainer.train()
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_attention.launches,
                "flash_bwd": flash_attention_bwd_cuda.launches,
                "adam8bit": adam8bit_update_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    losses = [[float(a[k]) for k in ("loss", "lm_loss", "vm_loss", "grad_norm", "update_skipped")]
              for a in auxes]
    for i, row in enumerate(losses):
        if not all(math.isfinite(x) for x in row) or row[4] != 0.0:
            raise AssertionError(f"[{label}] step {i + 1}: loss/lm/vm/grad_norm/skipped = {row}")
    if int(final.step) != steps or int(adam_state(final.opt_state)["count"]) != steps:
        raise AssertionError(f"[{label}] step counter or optimizer count did not reach {steps}")
    if saves != [steps]:  # save_steps=0: the final checkpoint only, as in JAX
        raise AssertionError(f"[{label}] checkpoints asked for at steps {saves}, want [{steps}]")
    got_flags = torch.stack(flags).cpu()
    n_leaves = got_flags.shape[0] // steps
    for name, col in zip(("finite", "nonzero", "applied where they exceed half an ulp"),
                         got_flags.T[:3]):
        if not bool(col.all()):
            raise AssertionError(f"[{label}] {int((~col).sum())} emitted updates were not {name}")
    moved = got_flags[:, 3].reshape(steps, n_leaves).any(dim=0)
    frozen_after = [p for path, p in tree_leaves_with_path(final.params) if not flat_mask[path]]
    if (any(a is not b for (_, a), b in zip(frozen_leaves, frozen_after))
            or not torch.equal(frozen_before, torch.stack([checksum(p) for p in frozen_after]))):
        raise AssertionError(f"[{label}] a frozen parameter changed")

    layers = cfg.llm.num_hidden_layers
    want = {"flash_fwd": steps * (2 * layers + flash_unet[0]),
            "flash_bwd": steps * (layers + flash_unet[1]),
            "adam8bit": steps * len(moments)}
    if launches != want:
        raise AssertionError(f"[{label}] kernel launches {launches}, want {want}")

    tokens = batch_rows * seq
    log(f"[{label}] {steps} steps at batch {batch_rows} x {seq}: step seconds "
        f"{[round(t, 3) for t in step_s]} (the first includes the kernels' first use)")
    log(f"[{label}] tokens/s {tokens / min(step_s):.1f} at the fastest step "
        f"({tokens / (sum(step_s[1:]) / len(step_s[1:])):.1f} over steps 2-{steps})")
    log(f"[{label}] peak memory {peak / 2**30:.2f} GiB")
    log(f"[{label}] loss {[round(r[0], 4) for r in losses]} lm {[round(r[1], 4) for r in losses]} "
        f"vm {[round(r[2], 4) for r in losses]} grad_norm {[round(r[3], 4) for r in losses]}")
    log(f"[{label}] launches over {steps} steps: {launches}; {n_leaves} trainable leaves updated "
        f"a step, {int(moved.sum())} of them changed in some element "
        f"({n_leaves - int(moved.sum())} hold updates below half a bf16 ulp everywhere), "
        f"{len(frozen_leaves)} frozen leaves unchanged")
    return {"launches": launches, "final": final, "trainer": trainer, "step_fn": step_fn,
            "mask": mask, "cfg": cfg}


def phase_train(model: list, profile_dir: str | None = None) -> dict:
    """``model``: ``[params, cfg, head, head_cfg]`` from the serving phase;
    the list is emptied, so that the first step's superseded parameters are
    freed and not kept alive by the caller. Three joint steps as the SFT
    recipe trains (:func:`_train_run`). ``profile_dir``: after the three
    steps, profile one more (kernel sums only: a step's trace is too long
    to keep)."""
    from dreamllm_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from dreamllm_tpu_torch.train.tree import tree_map

    dev = "cuda"
    steps, batch_rows, seq = 3, 2, 2048
    params, cfg, head, head_cfg = model
    model.clear()
    params = {**params, "sd_head": head}
    del head
    # the SFT recipe's optimizer (lr 4e-5, cosine over 12000 steps, clip 1.0,
    # no weight decay) with 8-bit moments; no warmup: its 200 warmup steps
    # start at lr 0, and three steps would move nothing
    opt_kw = dict(learning_rate=4e-5, schedule="cosine", warmup_steps=0, total_steps=12000,
                  weight_decay=0.0, max_grad_norm=1.0, optimizer_8bit=True, fused_update=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = _joint_batch(cfg, gen, batch=batch_rows, seq=seq, image_px=cfg.vision.image_size,
                         dream_px=512, dtype=torch.bfloat16, device=dev)
    # The UNet is not checkpointed (K1 once a flash site). It is frozen, and
    # its very first self-attention runs before any cross-attention has
    # brought the dream states in: nothing upstream of it needs a gradient,
    # so autograd rightly asks no backward of that site.
    sites, first_site = unet_flash_sites(head_cfg.unet, batch_rows, cfg.n_dream_queries)
    box = [params]
    del params
    out = _train_run("train", cfg, head_cfg, box, opt_kw=opt_kw, frozen=FROZEN,
                     head_loss_fn=None, batch=batch, steps=steps, gen=gen,
                     flash_unet=(sites, sites - int(first_site)))
    step_fn, mask, final, trainer = out["step_fn"], out["mask"], out["final"], out["trainer"]
    launches = out["launches"]
    del out

    if profile_dir:
        box = [final]

        def one_step():
            box[0], _ = step_fn(box[0], batch, gen)

        del final, trainer.state
        _profile(one_step, "train_step", profile_dir, trace=False, top=16)
        final = box.pop()

    # one full optimizer update (clip + 8-bit AdamW over every trainable
    # leaf), fused kernel against the unfused math, same state and gradients
    params_now, opt_state = final.params, final.opt_state
    del final, trainer
    grads = tree_map(lambda p, m: (torch.randn(p.shape, generator=gen, device=dev,
                                               dtype=torch.float32) * 1e-3).to(p.dtype)
                     if m else None, params_now, mask)
    torch.cuda.empty_cache()
    times = {}
    for label, fused in (("fused", True), ("unfused", False), ("fused", True), ("unfused", False)):
        tx_t = make_optimizer(OptimizerConfig(**{**opt_kw, "fused_update": fused}),
                              trainable_mask=mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tx_t.update(grads, opt_state, params_now)
        torch.cuda.synchronize()
        times.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
        del out
    log(f"[train] optimizer update, fused kernel: {min(times['fused']):.2f} ms "
        f"(runs {[round(t, 2) for t in times['fused']]})")
    log(f"[train] optimizer update, unfused: {min(times['unfused']):.2f} ms "
        f"(runs {[round(t, 2) for t in times['unfused']]})")
    return launches


# projects/dreamllm_sdxl/configs/stage1_creation.py: LLM, CLIP (trunk and
# projector), UNet and VAE frozen; the dream queries, the SD projector and the
# global projector train, diffusion loss only, lr 2e-3 cosine over 8000 steps
SDXL_FROZEN = ("llm", "clip_vision_embedding", "sd_head/unet", "sd_head/vae")


def _creation_batch(cfg, gen, *, batch: int, seq: int, dream_px: int) -> dict:
    """Creation-only rows (stage 1's i2t probability is 0): ``bos``, a
    caption, one dream span with its ``dream_px`` image and the image's
    ``add_time_ids`` (its own size, no crop), labels on the caption; the
    last row ends in a padding tail."""
    from dreamllm_tpu_torch.models.sd.sdxl import make_add_time_ids

    st, n_q, dev = cfg.special_tokens, cfg.n_dream_queries, "cuda"
    ids = torch.randint(10, 31000, (batch, seq), generator=gen, device=dev)
    ids[:, 0] = st.bos
    dream_at = seq - n_q - 24
    ids[:, dream_at - 1], ids[:, dream_at + n_q] = st.dream_start, st.dream_end
    ids[:, dream_at:dream_at + n_q] = st.dream
    labels = ids.clone()
    labels[:, dream_at - 1:] = -100
    seg = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    seg[-1, seq - seq // 40:] = 0
    side = (dream_px, dream_px)
    return {
        "input_ids": ids, "labels": labels, "segment_ids": seg,
        "positions": torch.arange(seq, dtype=torch.int32, device=dev)[None].repeat(batch, 1),
        "dream_positions": torch.full((batch, 1), dream_at, device=dev),
        "images_dm": (torch.rand((batch, 1) + side + (3,), generator=gen, device=dev) * 2
                      - 1).bfloat16(),
        "add_time_ids": make_add_time_ids(side, (0, 0), side, batch, device=dev)[:, None],
    }


def phase_sdxl_train(sdxl: list) -> dict:
    """Three DreamLLM-SDXL stage-1 creation steps (``SDXL_FROZEN``, ``lm``
    weight 0, ``vm`` 1, lr 2e-3 without the recipe's 200 warmup steps, 8-bit
    AdamW, full decoder remat) through ``Trainer.train`` (:func:`_train_run`)
    at batch 2 x 512, one 1024 px image a row (the recipe's batch 16 cut to
    fit the run). The UNet is frozen and not checkpointed: K1 and K2 once at
    each of its 140 flash sites a step (70 self- and 70 cross-attentions),
    every one of them downstream of a trainable projector (the
    cross-attentions' keys through the SD projector, every block through
    the global projector and the time embedding). ``sdxl``:
    ``[params, cfg, head, head_cfg]`` of :func:`phase_sdxl`, emptied."""
    import dataclasses

    from dreamllm_tpu_torch.models.sd.sdxl import make_sdxl_head_loss_fn

    params, cfg, head, head_cfg = sdxl
    sdxl.clear()
    params = {**params, "sd_head": head}
    del head
    cfg = dataclasses.replace(cfg, loss_weight_lm=0.0, loss_weight_vm=1.0)
    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = _creation_batch(cfg, gen, batch=2, seq=512, dream_px=_head_side(head_cfg))
    sites = unet_flash_sites(head_cfg.unet, 2, cfg.n_dream_queries)[0]
    opt_kw = dict(learning_rate=2e-3, schedule="cosine", warmup_steps=0, total_steps=8000,
                  weight_decay=0.0, max_grad_norm=1.0, optimizer_8bit=True, fused_update=True)
    box = [params]
    del params
    return _train_run("sdxl-train", cfg, head_cfg, box, opt_kw=opt_kw, frozen=SDXL_FROZEN,
                      head_loss_fn=make_sdxl_head_loss_fn(head_cfg), batch=batch, steps=3,
                      gen=gen, flash_unet=(sites, sites))["launches"]


def phase_llava_train(model) -> dict:
    """Three LLaVA-1.5-7B stage-1 steps as ``projects/llava/configs/
    pretrain.py`` trains (``configs.llava_7b``: the projector only, lr 2e-3
    without warmup, 8-bit AdamW, full decoder remat) through
    ``Trainer.train`` (:func:`_train_run`) at batch 2 x 2048, one 336 px
    image (576 tokens) a row (the recipe's batch 16 cut to fit the run). The
    decoder and the CLIP tower's layers are DreamLLM-7B's tensors
    (``model``, frozen: read only); the tower's 577 position embeddings and
    the 2-layer MLP projector are drawn from a seed. No UNet: K1 and K2 run
    in the decoder only."""
    from dreamllm_tpu_torch.configs import llava_7b
    from dreamllm_tpu_torch.models.llama import dense_init
    from dreamllm_tpu_torch.models.projector import init_projector_params

    params7 = model[0]
    cfg = llava_7b(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(10)
    vis7 = params7["clip_vision_embedding"]["clip"]
    with torch.no_grad():
        clip = {**vis7, "position_embedding": dense_init(
            (cfg.vision.seq_len, cfg.vision.hidden_size), cfg.vision.dtype, "cuda", gen, 0.02)}
        proj = init_projector_params(cfg.projector_cfg(), generator=gen, device="cuda")
    box = [{"llm": params7["llm"], "clip_vision_embedding": {"clip": clip, "projector": proj}}]
    del clip, proj
    batch = _joint_batch(cfg, gen, batch=2, seq=2048, image_px=cfg.vision.image_size,
                         dream_px=None, dtype=torch.bfloat16, device="cuda")
    opt_kw = dict(learning_rate=2e-3, schedule="cosine", warmup_steps=0, total_steps=558_000 // 16,
                  max_grad_norm=1.0, optimizer_8bit=True, fused_update=True)
    return _train_run("llava-train", cfg, None, box, opt_kw=opt_kw, frozen=cfg.frozen,
                      head_loss_fn=None, batch=batch, steps=3, gen=gen,
                      flash_unet=(0, 0))["launches"]


def _quantized_layouts(dense: dict) -> tuple[dict, dict]:
    """(unfused int4, fused int4) of a bf16 decoder, quantized layer by
    layer; the bf16 projections are dropped from ``dense`` as they go, so
    the bf16 model is never held twice. Embeddings and norms stay bf16 and
    are shared by both."""
    from dreamllm_tpu_torch.models.llama import fuse_llama_params
    from dreamllm_tpu_torch.ops.quant4 import QUANTIZED_KEYS, quantize_int4

    unfused, fused = [], []
    while dense["layers"]:
        layer = dense["layers"].pop(0)
        unfused.append({k: quantize_int4(v) if k in QUANTIZED_KEYS else v
                        for k, v in layer.items()})
        fl = fuse_llama_params({"layers": [layer]})["layers"][0]
        del layer
        fused.append({k: quantize_int4(v) if k in QUANTIZED_KEYS else v for k, v in fl.items()})
        del fl
    common = {"embed_tokens": dense["embed_tokens"], "final_norm": dense["final_norm"],
              "lm_head": quantize_int4(dense.pop("lm_head"))}
    return {**common, "layers": unfused}, {**common, "layers": fused}


def _nbytes(tree) -> int:
    return sum(t.nbytes() if hasattr(t, "packed") else t.numel() * t.element_size()
               for t in _leaves(tree))


# one decode forward launches the w4a16 kernel at every projection of every
# layer: 4 in the fused layout (wqkv, wo, w_gate_up, w_down), 7 unfused; the
# prefill (more than 8 rows) and the 32064-wide head (not a multiple of 128)
# take the dequantize product
W4_PER_LAYER = {"fused": 4, "unfused": 7}
# One 7B decode step's float32 logits, the kernel against its plain version
# in every projection. The two differ at single bf16 outputs (relative RMS
# 1e-9 to 3e-5 a launch in the kernels phase); 32 layers of random weights
# spread those flips to a few percent of the logits (1.5e-2 measured on an
# H100 80GB HBM3). The limit bounds that growth; one dropped 128-row group a
# launch (relative RMS above 0.1 a launch, compounded over 32 layers) lies far
# beyond it.
W4_STEP_REL_RMS = 5e-2


def phase_serve_int4(profile_dir: str | None = None) -> tuple[dict, dict]:
    """The quantized serving path at DreamLLM-7B's full width and depth.
    Returns the launch counts and the unfused int4 decoder, which the QLoRA
    phase trains an adapter over.

    ``generate_text`` (fused int4, 128-token prompts, 128 greedy tokens) at
    batch 1 and 8 on the bf16 cache and at batch 8 on the int8 cache, each
    also run with one new token so that the prefill's share can be taken
    out of the decode time; then the engine with serve.py's defaults on the
    unfused layout answers 16 requests, 8 submitted at once and 8 more while
    those decode. Every kernel count is set to 0 before the path and read
    after it; the w4a16 count must equal the layout's launches a forward
    times the decode forwards. Token identity is not asserted: random 7B
    weights give near-tie logits. Last, one decode step's logits with the
    kernel are held against the same step with its plain version."""
    import threading

    import dreamllm_tpu_torch.ops.quant4 as quant4
    from dreamllm_tpu_torch.configs import dreamllm_7b
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig, generate_text
    from dreamllm_tpu_torch.models.llama import (
        init_kv_cache,
        init_llama_params,
        llama_forward,
        llama_logits,
    )
    from dreamllm_tpu_torch.ops.attention import flash_attention, flash_attention_bwd_cuda
    from dreamllm_tpu_torch.serve.engine import ContinuousBatchingEngine, EngineConfig
    from dreamllm_tpu_torch.train.optim8bit import adam8bit_update_cuda

    device = "cuda"
    cfg = dreamllm_7b(torch.bfloat16)[0].llm
    gen = torch.Generator(device=device).manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize

    t0 = time.perf_counter()
    with torch.no_grad():
        dense = init_llama_params(cfg, generator=gen, device=device)
        bf16_bytes = _nbytes(dense)
        unfused, fused = _quantized_layouts(dense)
    del dense
    torch.cuda.empty_cache()
    sync()
    log(f"[serve-int4] {cfg.num_hidden_layers} layers, vocab {cfg.vocab_size}: weights "
        f"{bf16_bytes / 2**30:.3f} GiB bf16 -> {_nbytes(fused) / 2**30:.3f} GiB int4 fused "
        f"({_nbytes(unfused) / 2**30:.3f} unfused; embeddings and norms stay bf16), built and "
        f"quantized in {time.perf_counter() - t0:.2f} s")

    s_prompt, new = 128, 128
    vocab = cfg.vocab_size
    ids = torch.randint(10, min(31000, vocab), (8, s_prompt), generator=gen, device=device)
    lens = torch.full((8,), s_prompt, dtype=torch.int32, device=device)

    flash_attention.launches = flash_attention_bwd_cuda.launches = 0
    adam8bit_update_cuda.launches = quant4.w4_matmul_cuda.launches = 0
    gen_steps = 0
    for label, b, cache_dtype in (("B1 bf16 cache", 1, torch.bfloat16),
                                  ("B8 bf16 cache", 8, torch.bfloat16),
                                  ("B8 int8 cache", 8, torch.int8)):
        secs = {}
        for n_new in (1, new):
            sync()
            t = time.perf_counter()
            out = generate_text(fused, cfg, ids[:b], lens[:b],
                                SamplingConfig(greedy=True, max_new_tokens=n_new,
                                               eos_token_id=-1),
                                cache_dtype=cache_dtype, device=device)
            sync()
            secs[n_new] = time.perf_counter() - t
            toks = out["tokens"]
            if (out["steps"] != n_new or not bool((out["lengths"] == n_new).all())
                    or not bool(((toks >= 0) & (toks < vocab)).all())):
                raise AssertionError(f"[serve-int4] generate_text {label}: steps {out['steps']}, "
                                     f"lengths {out['lengths'].tolist()}")
            gen_steps += out["steps"]
        del out
        step_ms = (secs[new] - secs[1]) / (new - 1) * 1e3
        log(f"[serve-int4] generate_text {label}: {secs[new]:.3f} s for {b} x {new} tokens "
            f"({b * new / secs[new]:.1f} tokens/s, prefill included); decode {step_ms:.2f} ms a "
            f"step ({b * 1e3 / step_ms:.1f} tokens/s); prefill + 1 token {secs[1]:.3f} s")

    ecfg = EngineConfig(slots=8, prefill_len=512, max_len=1024, chunk_steps=16,
                        cache_dtype="bfloat16", bos_token_id=1)
    eng = ContinuousBatchingEngine(unfused, cfg,
                                   SamplingConfig(greedy=True, max_new_tokens=0,
                                                  eos_token_id=-1, pad_token_id=0),
                                   ecfg, device=device)
    hgen = torch.Generator().manual_seed(3)
    plens = torch.randint(64, 401, (16,), generator=hgen).tolist()
    news = torch.randint(64, 129, (16,), generator=hgen).tolist()
    reqs = [[1] + torch.randint(10, min(31000, vocab), (n - 1,), generator=hgen).tolist()
            for n in plens]
    answers, errors = [None] * 16, []

    def ask(i):
        try:
            answers[i] = eng.submit(reqs[i], max_new_tokens=news[i], timeout=900)
        except Exception as e:  # surfaced below: a kernel error must fail the run
            errors.append(e)

    t = time.perf_counter()
    eng.warmup().start()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for th in threads[:8]:
            th.start()
        if not eng.wait_for_admissions(8, timeout=600):
            raise AssertionError("[serve-int4] the engine did not admit the first 8 requests")
        for th in threads[8:]:  # the second wave arrives while the first decodes
            th.start()
        for th in threads:
            th.join(timeout=900)
    finally:
        eng.stop()
    engine_s = time.perf_counter() - t
    if errors:
        raise errors[0]
    for i, (a, n) in enumerate(zip(answers, news)):
        if a is None or len(a) != n or not all(0 <= x < vocab for x in a):
            raise AssertionError(f"[serve-int4] request {i}: {None if a is None else len(a)} "
                                 f"tokens, want {n}")
    launches = {"w4a16": quant4.w4_matmul_cuda.launches}
    others = (flash_attention.launches, flash_attention_bwd_cuda.launches,
              adam8bit_update_cuda.launches)
    layers = cfg.num_hidden_layers
    want = layers * (W4_PER_LAYER["fused"] * gen_steps + W4_PER_LAYER["unfused"] * eng.decode_steps)
    if launches["w4a16"] != want or any(others):
        raise AssertionError(f"[serve-int4] w4a16 launched {launches['w4a16']} times, want "
                             f"{want}; flash fwd/bwd, adam8bit launched {others}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve-int4] engine (8 slots, prefill 512, max_len 1024, chunk 16, unfused int4): "
        f"16 requests, prompts {min(plens)}-{max(plens)} tokens, {sum(news)} tokens generated in "
        f"{engine_s:.3f} s ({sum(news) / engine_s:.1f} tokens/s); {eng.chunks_dispatched} chunks, "
        f"{eng.decode_steps} decode forwards (warmup included, {warm_s:.3f} s); lanes busy "
        f"{sum(eng.active_history) / max(1, len(eng.active_history)):.2f} on average")
    log(f"[serve-int4] w4a16 launches {launches['w4a16']} = {layers} layers x (4 x {gen_steps} "
        f"generate_text forwards + 7 x {eng.decode_steps} engine forwards); peak memory "
        f"{peak / 2**30:.2f} GiB")

    # one decode step at batch 8, kernel against plain version, same cache
    cache = init_kv_cache(cfg, 8, s_prompt + 1, device=device)
    with torch.no_grad():
        llama_forward(fused, cfg, input_ids=ids, kv_cache=cache)
        tok = torch.randint(10, min(31000, vocab), (8, 1), generator=gen, device=device)
        snap = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}

        def step():
            c = {k: v.clone() if torch.is_tensor(v) else v for k, v in snap.items()}
            o = llama_forward(fused, cfg, input_ids=tok, kv_cache=c)
            return llama_logits(fused, cfg, o["last_hidden_state"])[:, 0]

        got = step()
        kernel = quant4.w4_matmul_cuda
        quant4.w4_matmul_cuda = lambda x, t: quant4.w4_matmul_reference(x, t)  # noqa: E731
        try:
            want_logits = step()
        finally:
            quant4.w4_matmul_cuda = kernel
        sync()
        diff = got - want_logits
        rel = (diff.norm() / want_logits.norm()).item()
        agree = (got.argmax(-1) == want_logits.argmax(-1)).float().mean().item()
        if not math.isfinite(rel) or rel > W4_STEP_REL_RMS:
            raise AssertionError(f"[serve-int4] decode-step logits, kernel vs plain: relative "
                                 f"RMS {rel} > {W4_STEP_REL_RMS}")
        log(f"[serve-int4] one decode step's logits, kernel vs plain version: relative RMS "
            f"{rel:.3e} (limit {W4_STEP_REL_RMS}), max-abs {diff.abs().max().item():.3e} of "
            f"{want_logits.abs().max().item():.3e}, argmax agrees on {agree:.0%} of 8 rows")
        if profile_dir:
            _profile(step, "int4_decode_step_b8", profile_dir, top=12)
    return launches, unfused


def _launch_counts() -> dict:
    from dreamllm_tpu_torch.ops import kernel_launches

    return kernel_launches()


def _zero_launch_counts() -> None:
    from dreamllm_tpu_torch.ops import quant4
    from dreamllm_tpu_torch.ops.attention import flash_attention, flash_attention_bwd_cuda
    from dreamllm_tpu_torch.train.optim8bit import adam8bit_update_cuda

    flash_attention.launches = flash_attention_bwd_cuda.launches = 0
    adam8bit_update_cuda.launches = quant4.w4_matmul_cuda.launches = 0


def _q4_bits(tree) -> list:
    """Copies of every int4 tensor of a decoder, to check it is unchanged."""
    return [(t.packed.clone(), t.scale.clone()) for t in _leaves(tree) if hasattr(t, "packed")]


def _dequant_ranges():
    """Wrap the int4 dequantize products (forward, and the backward's
    ``g @ dequant(W)^T``) in profiler ranges; returns the undo function."""
    from torch.profiler import record_function

    from dreamllm_tpu_torch.ops import quant4

    impl, bwd = quant4._matmul4_impl, quant4._Matmul4.backward

    def fwd_ranged(x, t):
        with record_function("int4_product_fwd"):
            return impl(x, t)

    def bwd_ranged(ctx, g):
        with record_function("int4_product_bwd"):
            return bwd(ctx, g)

    quant4._matmul4_impl, quant4._Matmul4.backward = fwd_ranged, staticmethod(bwd_ranged)

    def undo():
        quant4._matmul4_impl, quant4._Matmul4.backward = impl, staticmethod(bwd)
    return undo


# Where a decoding variant's tokens part from their plain reference on the
# card, the plain run's top-2 logit margin at the first differing position
# (teacher-forced, dequantize products and plain attention) must be below
# this: the variant rounds through other products (an 8-row K3 call or the
# dequantize product, an attention of 1 + k query rows) than plain decode,
# and one 7B decode step's logits moved by up to 7.4e-2 between K3 and its
# plain version (the serving phases' logits check); twice that. Random 7B
# weights give such near-ties often.
NEAR_TIE_7B = 0.15
# A beam's summed log-prob, from its cached decode steps (K3 products),
# against ``sequence_logprob``'s of the same tokens (one cache-free forward,
# dequantize products): at most this much apart per token. A beam whose
# cache rows were reordered wrongly reads other keys and scores its tokens
# a nat or more apart per token.
BEAM_LP_TOL = 0.05


def _forward_rows_counter():
    """Count the cached decoder forwards that the generation drivers run,
    by the rows they give each projection (batch x tokens): those of at most
    8 rows take the w4a16 kernel. Returns ``(counts, undo)``."""
    import dreamllm_tpu_torch.generation.sampler as sampler

    real = sampler.llama_forward
    counts = {"small": 0, "large": 0}

    def counting(*a, **kw):
        x = kw.get("input_ids")
        x = kw.get("inputs_embeds") if x is None else x
        if kw.get("kv_cache") is not None:
            counts["small" if x.shape[0] * x.shape[1] <= 8 else "large"] += 1
        return real(*a, **kw)

    sampler.llama_forward = counting

    def undo():
        sampler.llama_forward = real
    return counts, undo


def _first_gap(params, cfg, prompt: list, got: list, ref: list):
    """None where ``got == ref``; else (first differing position, the top-2
    logit margin of ``params`` there, teacher-forced on ``prompt + ref``)."""
    from dreamllm_tpu_torch.models.llama import llama_forward, llama_logits

    if got == ref:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))
    seq = torch.tensor([prompt + ref[:j]], device="cuda")
    with torch.no_grad():
        h = llama_forward(params, cfg, input_ids=seq, use_flash=False)["last_hidden_state"]
        top2 = llama_logits(params, cfg, h[:, -1:])[0, 0].topk(2).values
    return j, float(top2[0] - top2[1])


def _near_tie_identity(label: str, params, cfg, triples) -> int:
    """Hold each (prompt, got, plain reference) to the near-tie rule: equal,
    or parting first where the plain run's margin is under NEAR_TIE_7B.
    Prints every mismatch with its margin; returns how many are equal."""
    equal = 0
    for i, (prompt, got, ref) in enumerate(triples):
        gap = _first_gap(params, cfg, prompt, got, ref)
        if gap is None:
            equal += 1
            continue
        j, margin = gap
        log(f"[decode-variants] {label} #{i}: parts from its plain reference at token {j} of "
            f"{len(ref)}; the plain run's top-2 margin there {margin:.4f} (limit {NEAR_TIE_7B})")
        if j >= min(len(got), len(ref)) or not margin < NEAR_TIE_7B:
            raise AssertionError(f"[decode-variants] {label} #{i}: a mismatch at token {j} that "
                                 f"no near-tie explains (margin {margin})")
    return equal


def phase_decode_variants(base: dict) -> dict:
    """Decoding variants on DreamLLM-7B's unfused int4 decoder (``base``, from
    the serving phase), each path's launches counted alone and checked (224
    w4a16 launches a forward of at most 8 rows; wider forwards take the
    dequantize product):

    1. ``generate_text_speculative`` at batch 1, draft 7 (an 8-row verify
       window), 128 new tokens, on a repetitive prompt (a 64-token chunk
       twice, as ``bench.py`` builds it) and a random one of 128 tokens, in
       turns with ``generate_text`` (plain, spec, spec, plain); then draft 8
       (9 rows: the dequantize product) once, 64 tokens;
    2. ``beam_search``, 4 beams at batch 1 and 2 (4 and 8 rows), 64 tokens;
       the best beam's score against ``sequence_logprob`` of its tokens and
       of the greedy sequence's;
    3. ``run_vqa`` on 8 synthetic samples (224 px, ``ToyTokenizer``, vqav2)
       with DreamLLM-7B's CLIP tower and projector: greedy at batch 8, then
       4 beams at batch 2; both shards merged;
    4. the engine with ``bench.py``'s speculative settings (8 slots, prefill
       128, max_len 512, chunk 16, k 7): 16 repetitive prompts at once, and
       the sparse mix (12 requests, 3 at a time, repetitive and random in
       turn), 64 new tokens a request, each load under the adaptive bandit,
       static speculation and ``speculative_k=0``.

    Every speculative and beam-1 output is held to its plain reference by
    the near-tie rule. Returns the launch counts by path."""
    import concurrent.futures as cf
    import os

    from dreamllm_tpu_torch.configs import dreamllm_7b
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.eval.nlp import sequence_logprob
    from dreamllm_tpu_torch.eval.vqa import merge_prediction_shards, run_vqa
    from dreamllm_tpu_torch.generation.sampler import (
        SamplingConfig,
        beam_search,
        generate_text,
        generate_text_speculative,
    )
    from dreamllm_tpu_torch.models.clip import init_clip_vision_params
    from dreamllm_tpu_torch.models.projector import init_projector_params
    from dreamllm_tpu_torch.serve.engine import ContinuousBatchingEngine, EngineConfig

    device = "cuda"
    sync = torch.cuda.synchronize
    dcfg = dreamllm_7b(torch.bfloat16)[0]
    cfg = dcfg.llm
    vocab = cfg.vocab_size
    per_fwd = W4_PER_LAYER["unfused"] * cfg.num_hidden_layers
    gen = torch.Generator(device=device).manual_seed(6)
    hgen = torch.Generator().manual_seed(7)
    launches = {}
    torch.cuda.reset_peak_memory_stats()

    def check(path: str, want_w4: int) -> dict:
        got = _launch_counts()
        want = {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0, "w4a16": want_w4}
        if got != want:
            raise AssertionError(f"[decode-variants] {path}: launches {got}, want {want}")
        launches[path] = {k: launches.get(path, {}).get(k, 0) + v for k, v in got.items()}
        return got

    # -- 1. prompt-lookup speculation at batch 1 -------------------------------
    chunk = torch.randint(10, min(31000, vocab), (64,), generator=hgen).tolist()
    prompts = {"repetitive": chunk + chunk,
               "random": torch.randint(10, min(31000, vocab), (128,), generator=hgen).tolist()}
    new = 128
    scfg = SamplingConfig(greedy=True, max_new_tokens=new, eos_token_id=-1)
    runs: dict = {}
    for kind, prompt in prompts.items():
        ids, lens = torch.tensor([prompt], device=device), torch.tensor([len(prompt)])
        for mode in ("plain", "spec", "spec", "plain"):
            _zero_launch_counts()
            sync()
            t = time.perf_counter()
            if mode == "spec":
                out = generate_text_speculative(base, cfg, ids, lens, scfg, draft_len=7,
                                                device=device)
            else:
                out = generate_text(base, cfg, ids, lens, scfg, device=device)
            sync()
            secs = time.perf_counter() - t
            toks = out["tokens"][0, :int(out["lengths"][0])].tolist()
            if len(toks) != new or not all(0 <= x < vocab for x in toks):
                raise AssertionError(f"[decode-variants] {mode} {kind}: {len(toks)} tokens")
            check("speculative_b1", per_fwd * out["steps"])
            runs.setdefault((kind, mode), []).append(
                {"s": secs, "tokens": toks, "steps": out["steps"],
                 "accepted": out.get("accepted", 0)})
            log(f"[decode-variants] {'speculative draft 7' if mode == 'spec' else 'generate_text'} "
                f"B1 {kind}: {secs:.3f} s for {new} tokens ({new / secs:.1f} tokens/s, prefill "
                f"included); {out['steps']} " + ("verify steps, "
                                                 f"{out['accepted']} drafts accepted"
                                                 if mode == "spec" else "decode steps"))
    triples = [(prompts[kind], r["tokens"], runs[kind, "plain"][0]["tokens"])
               for kind in prompts for r in runs[kind, "spec"] + runs[kind, "plain"][1:]]
    equal = _near_tie_identity("speculative B1", base, cfg, triples)
    # JAX's default draft_len 8: a 9-row window takes the dequantize product
    kind = "repetitive"
    ids, lens = torch.tensor([prompts[kind]], device=device), torch.tensor([128])
    _zero_launch_counts()
    sync()
    t = time.perf_counter()
    out8 = generate_text_speculative(base, cfg, ids, lens,
                                     SamplingConfig(greedy=True, max_new_tokens=64,
                                                    eos_token_id=-1),
                                     draft_len=8, device=device)
    sync()
    secs8 = time.perf_counter() - t
    check("speculative_b1", 0)
    toks8 = out8["tokens"][0].tolist()
    equal8 = _near_tie_identity("speculative draft 8", base, cfg,
                                [(prompts[kind], toks8, runs[kind, "plain"][0]["tokens"][:64])])
    mean = {k: sum(r["s"] for r in v) / len(v) for k, v in runs.items()}
    rep_s, rep_p = mean["repetitive", "spec"], mean["repetitive", "plain"]
    rnd_s, rnd_p = mean["random", "spec"], mean["random", "plain"]
    log(f"[decode-variants] speculative B1 draft 7, means of two runs: repetitive "
        f"{new / rep_s:.1f} tokens/s against generate_text's {new / rep_p:.1f} "
        f"({rep_p / rep_s:.3f}x), {runs['repetitive', 'spec'][0]['steps']} verify steps a "
        f"{new} tokens; random {new / rnd_s:.1f} against {new / rnd_p:.1f} "
        f"({rnd_p / rnd_s:.3f}x), {runs['random', 'spec'][0]['steps']} steps; {equal} of {len(triples)} outputs equal "
        f"the first plain run's; draft 8 (dequantize product): {secs8:.3f} s for 64 tokens "
        f"({64 / secs8:.1f} tokens/s), {out8['steps']} verify steps, {out8['accepted']} accepted, "
        f"{equal8} of 1 equal; w4a16 launches {launches['speculative_b1']['w4a16']} = {per_fwd} x "
        f"the decode and verify forwards of at most 8 rows")

    # -- 2. beam search -------------------------------------------------------
    bprompts = torch.randint(10, min(31000, vocab), (2, 128), generator=hgen).tolist()
    bnew, beams = 64, 4
    beam_out = {}
    for b in (1, 2):
        ids = torch.tensor(bprompts[:b], device=device)
        _zero_launch_counts()
        sync()
        t = time.perf_counter()
        out = beam_search(base, cfg, ids, torch.full((b,), 128), num_beams=beams,
                          max_new_tokens=bnew, eos_token_id=-1, device=device)
        sync()
        secs = time.perf_counter() - t
        check("beam_search", per_fwd * (bnew - 1))
        beam_out[b] = out
        scores = [round(x, 4) for x in out["scores"].tolist()]
        log(f"[decode-variants] beam_search {beams} beams x batch {b} ({beams * b} rows): "
            f"{secs:.3f} s a call for {bnew} tokens ({secs / (bnew - 1) * 1e3:.1f} ms a beam "
            f"step, prefill included); scores {scores}")
    greedy = generate_text(base, cfg, torch.tensor(bprompts[:1], device=device),
                           torch.tensor([128]), SamplingConfig(greedy=True, max_new_tokens=bnew,
                                                               eos_token_id=-1),
                           device=device)["tokens"][0].tolist()
    beam_toks = beam_out[1]["tokens"][0].tolist()

    def logprob(cont):
        seq = torch.tensor([bprompts[0] + cont], device=device)
        return float(sequence_logprob(base, cfg, seq, torch.tensor([128], device=device),
                                      torch.tensor([128 + len(cont)], device=device))[0])

    lp_beam, lp_greedy = logprob(beam_toks), logprob(greedy)
    score = float(beam_out[1]["scores"][0]) * bnew  # length penalty 1, no EOS: the sum
    tol = BEAM_LP_TOL * bnew
    if not (abs(score - lp_beam) <= tol and lp_beam >= lp_greedy - tol):
        raise AssertionError(f"[decode-variants] beam score {score} against its sequence_logprob "
                             f"{lp_beam} and the greedy sequence's {lp_greedy} (tolerance {tol})")
    same_b2 = beam_out[2]["tokens"][0].tolist() == beam_toks
    log(f"[decode-variants] best beam (batch 1): summed score {score:.4f}, sequence_logprob of its "
        f"tokens {lp_beam:.4f}, of the greedy sequence {lp_greedy:.4f} (tolerance {tol:.2f}); "
        f"row 0 at batch 2 {'equals' if same_b2 else 'differs from'} batch 1's; w4a16 launches "
        f"{launches['beam_search']['w4a16']} = {per_fwd} x {2 * (bnew - 1)} beam steps")

    # -- 3. the VQA driver ----------------------------------------------------
    with torch.no_grad():
        vparams = {"llm": base, "clip_vision_embedding": {
            "clip": init_clip_vision_params(dcfg.vision, generator=gen, device=device),
            "projector": init_projector_params(dcfg.projector_cfg(), generator=gen,
                                               device=device)}}
    tok = ToyTokenizer(vocab_size=vocab)
    samples = [{"id": i, "question": f"what is the colour of object {i}?",
                "answers": ["tok20"] * 10,
                "image": torch.rand((224, 224, 3), generator=hgen).numpy()} for i in range(8)]
    out_dir = os.path.join("build", "decode_variants")
    shards, vqa = [], {}
    for label, kw in (("greedy B8", dict(batch_size=8)),
                      ("4 beams B2", dict(batch_size=2, num_beams=4))):
        shards.append(os.path.join(out_dir, f"vqa_{len(shards)}.json"))
        counts, undo = _forward_rows_counter()
        _zero_launch_counts()
        sync()
        t = time.perf_counter()
        try:
            res = run_vqa(vparams, dcfg, tok, samples, task="vqav2", out_path=shards[-1],
                          device=device, **kw)
        finally:
            undo()
        sync()
        secs = time.perf_counter() - t
        check("vqa", per_fwd * counts["small"])
        vqa[label] = res
        if not (math.isfinite(res["score"]) and 0.0 <= res["score"] <= 1.0
                and len(res["predictions"]) == 8):
            raise AssertionError(f"[decode-variants] run_vqa {label}: {res['score']}")
        log(f"[decode-variants] run_vqa {label}: {secs / 8:.3f} s a sample ({secs:.3f} s for 8, "
            f"CLIP, prompts of {counts['large']} prefills and {counts['small']} decode forwards "
            f"included); score {res['score']}; w4a16 launches {per_fwd} x {counts['small']}")
    merged = merge_prediction_shards(shards, os.path.join(out_dir, "vqa_merged.json"))
    if merged["n"] != 16 or not 0.0 <= merged["score"] <= 1.0:
        raise AssertionError(f"[decode-variants] merged shards {merged}")
    log(f"[decode-variants] shards merged: {merged}")
    del vparams

    # -- 4. the engine's per-slot speculation ---------------------------------
    def make_prompt(repetitive: bool) -> list:
        if repetitive:
            c = torch.randint(10, min(31000, vocab), (63,), generator=hgen).tolist()
            return [1] + c + c + c[:1]
        return [1] + torch.randint(10, min(31000, vocab), (127,), generator=hgen).tolist()

    loads = {"repetitive x16": ([make_prompt(True) for _ in range(16)], None),
             "sparse 12/3": ([make_prompt(i % 2 == 0) for i in range(12)], 3)}
    enew = 64
    scfg0 = SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1, pad_token_id=0)
    policies = {"plain": dict(speculative_k=0), "adaptive": dict(speculative_k=7),
                "static": dict(speculative_k=7, speculative_adaptive=False)}

    def serve(reqs, concurrency, policy):
        _zero_launch_counts()  # the warmup's plain chunk launches the kernel too
        eng = ContinuousBatchingEngine(base, cfg, scfg0, EngineConfig(
            slots=8, prefill_len=128, max_len=512, chunk_steps=16, **policies[policy]),
            device=device).warmup()
        answers = [None] * len(reqs)

        def lane(w):
            for i in range(w, len(reqs), concurrency or len(reqs)):
                answers[i] = eng.submit(reqs[i], max_new_tokens=enew, timeout=900)

        eng.start()
        try:
            t = time.perf_counter()
            with cf.ThreadPoolExecutor(concurrency or len(reqs)) as ex:
                list(ex.map(lane, range(concurrency or len(reqs)), timeout=900))
            secs = time.perf_counter() - t
        finally:
            eng.stop()
        warm_plain = 1 if eng.decode_plain_fn is not None or not eng.ecfg.speculative_k else 0
        check("engine_spec", per_fwd * eng.ecfg.chunk_steps * (eng.plain_chunks + warm_plain))
        if any(a is None or len(a) != enew for a in answers):
            raise AssertionError(f"[decode-variants] engine {policy}: answers of lengths "
                                 f"{[None if a is None else len(a) for a in answers]}")
        return eng, answers, secs

    for name, (reqs, conc) in loads.items():
        order = ("plain", "adaptive", "static") if conc is None else ("static", "adaptive", "plain")
        res = {p: serve(reqs, conc, p) for p in order}
        ref = res["plain"][1]
        parts = []
        for policy in ("adaptive", "static", "plain"):
            eng, answers, secs = res[policy]
            eq = (_near_tie_identity(f"engine {policy} {name}", base, cfg,
                                     list(zip(reqs, answers, ref))) if policy != "plain"
                  else len(reqs))
            picks = {f"{m}@{b}": round(v, 1) for (m, b), v in sorted(eng._mode_ema.items())}
            parts.append(f"{policy} {len(reqs) * enew / secs:.1f} tokens/s ({secs:.3f} s; spec "
                         f"chunks {eng.spec_chunks}, plain chunks {eng.plain_chunks}"
                         + (f"; bandit tokens/s {picks}" if picks else "")
                         + f"; {eq} of {len(reqs)} answers equal the plain engine's)")
        log(f"[decode-variants] engine 8 slots, prefill 128, max_len 512, chunk 16, k 7, "
            f"{name}, {enew} tokens a request: " + "; ".join(parts))
    log(f"[decode-variants] w4a16 launches on the engine runs {launches['engine_spec']['w4a16']} "
        f"= {per_fwd} x 16 x the plain chunks (warmup included; a verify forward of 8 x 8 rows "
        f"takes the dequantize product); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


QLORA_LR = 2e-4  # the QLoRA paper's 7B setting (Dettmers et al. 2023), constant


def phase_qlora(base: dict, profile_dir: str | None = None) -> tuple[dict, dict]:
    """QLoRA on DreamLLM-7B's int4 decoder (``base``: the unfused int4
    layout of the serving phase, 3.51 GiB), then the adapter served as
    ``projects/dreamllm/serve.py`` builds its server.

    Training: a ``LoRAConfig()`` adapter (rank 8, alpha 16, ``wq wk wv
    wo``; float32 factors from a seeded generator) takes three steps at
    batch 2 x 2048 random tokens (:func:`_qlora_step_fn`; ``make_optimizer``
    with 8-bit AdamW, fused, lr 2e-4 constant, no weight decay, clip 1.0).
    Step 1's loss must equal the bare base's on the same batch bit for bit
    (``b`` = 0 adds exact zeros); every loss finite, every ``b`` nonzero
    after the steps, the base bit-identical; the launches a step derived
    from the configuration. Serving: ``attach_lora(base, trained)`` through
    ``generate_text`` (batch 1 and 8, 128-token prompts, 128 greedy tokens,
    beside the bare base), a zero-``b`` adapter against the bare base, one
    decode step's logits with the w4a16 kernel against its plain version;
    the engine with serve.py's defaults and the prefix cache answering 16
    requests under two 512-token system prompts, against the same engine
    without the cache, and embeddings prompts against ids prompts; then
    ``ModelServer`` on 127.0.0.1 with that engine, ``/logprob`` by
    ``choice_logprobs`` and ``/chat`` through ``make_chat_fn(engine=)`` over
    DreamLLM-7B's CLIP tower and projector, called through
    ``OnlineClient``. Returns the launch counts of training and serving."""
    import concurrent.futures as cf

    import dreamllm_tpu_torch.ops.quant4 as quant4
    from dreamllm_tpu_torch.configs import dreamllm_7b
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.eval.nlp import choice_logprobs
    from dreamllm_tpu_torch.generation.chat import make_chat_fn
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig, generate_text
    from dreamllm_tpu_torch.models.clip import init_clip_vision_params
    from dreamllm_tpu_torch.models.llama import init_kv_cache, llama_forward, llama_logits
    from dreamllm_tpu_torch.models.projector import init_projector_params
    from dreamllm_tpu_torch.serve import (
        ContinuousBatchingEngine,
        EngineConfig,
        ModelServer,
        OnlineClient,
    )
    from dreamllm_tpu_torch.train.lora import LoRAConfig, attach_lora, init_lora_params
    from dreamllm_tpu_torch.train.optim import OptimizerConfig, adam_state, make_optimizer
    from dreamllm_tpu_torch.train.optim8bit import _Moment
    from dreamllm_tpu_torch.train.tree import tree_leaves

    device = "cuda"
    sync = torch.cuda.synchronize
    dcfg = dreamllm_7b(torch.bfloat16)[0]
    cfg = dcfg.llm
    vocab, layers = cfg.vocab_size, cfg.num_hidden_layers
    gen = torch.Generator(device=device).manual_seed(4)
    lcfg = LoRAConfig()
    lora = init_lora_params(base, lcfg, generator=gen)
    n_factors = sum(t.numel() for t in tree_leaves(lora))
    ocfg = OptimizerConfig(learning_rate=QLORA_LR, schedule="constant", warmup_steps=0,
                           weight_decay=0.0, max_grad_norm=1.0, optimizer_8bit=True,
                           fused_update=True)
    tx = make_optimizer(ocfg)
    opt_state = tx.init(lora)
    n_8bit = sum(isinstance(m, _Moment) for m in tree_leaves(adam_state(opt_state)["m"]))
    step, lm_loss = _qlora_step_fn(base, cfg, lcfg, tx)
    steps, rows, seq = 3, 2, 2048
    tokens = torch.randint(10, min(31000, vocab), (rows, seq), generator=gen, device=device)
    bits = _q4_bits(base)
    with torch.no_grad():
        bare_loss = lm_loss(base, tokens, None)
    log(f"[qlora] DreamLLM-7B int4 decoder ({_nbytes(base) / 2**30:.3f} GiB), adapter rank "
        f"{lcfg.rank}, alpha {lcfg.alpha}, targets {list(lcfg.targets)}: {n_factors} float32 "
        f"factor elements, {n_8bit} of {len(list(tree_leaves(lora)))} factor leaves with 8-bit "
        f"moments")

    sync()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        lora, opt_state, loss = step(lora, opt_state, tokens)
        sync()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
    train_launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if losses[0] != float(bare_loss):
        raise AssertionError(f"[qlora] step 1 loss {losses[0]!r} != the bare base's "
                             f"{float(bare_loss)!r}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[qlora] losses {losses}")
    if not all(bool(f["b"].any()) for layer in lora["layers"] for f in layer.values()):
        raise AssertionError("[qlora] a b factor is still zero after the steps")
    if any(not (torch.equal(p, q) and torch.equal(s, r))
           for (p, s), (q, r) in zip(bits, _q4_bits(base))):
        raise AssertionError("[qlora] the int4 base changed")
    # a step: remat reruns each layer's forward in the backward (K1 twice a
    # layer, K2 once); K4 once a factor leaf of min_8bit_size elements or
    # more (at 7B every factor: 2 x 4 targets x 32 layers); the 2 x 2048
    # rows take the dequantize product, never K3
    big = sum(t.numel() >= ocfg.min_8bit_size for t in tree_leaves(lora))
    want = {"flash_fwd": steps * 2 * layers, "flash_bwd": steps * layers,
            "adam8bit": steps * big, "w4a16": 0}
    if train_launches != want or n_8bit != big:
        raise AssertionError(f"[qlora] launches over {steps} steps {train_launches}, want {want} "
                             f"({n_8bit} 8-bit factor leaves)")
    ntok = rows * seq
    log(f"[qlora] {steps} steps at batch {rows} x {seq}: step seconds "
        f"{[round(x, 3) for x in step_s]} (the first includes first use); tokens/s "
        f"{ntok / min(step_s):.1f} at the fastest step ({ntok * (steps - 1) / sum(step_s[1:]):.1f}"
        f" over steps 2-{steps}); peak memory {peak / 2**30:.2f} GiB")
    log(f"[qlora] loss {[round(x, 5) for x in losses]}; step 1 == the bare int4 base's loss "
        f"{float(bare_loss)!r} bit for bit; every b nonzero; the int4 base unchanged; launches a "
        f"step {({k: v // steps for k, v in train_launches.items()})}")
    if profile_dir:
        box = [lora, opt_state]

        def one_step():
            box[0], box[1], _ = step(box[0], box[1], tokens)

        undo = _dequant_ranges()
        try:
            _profile(one_step, "qlora_step", profile_dir, trace=False, top=16,
                     ranges=("int4_product_fwd", "int4_product_bwd"))
        finally:
            undo()
        lora, opt_state = box
    del opt_state, tx

    # -- serving the adapter ---------------------------------------------------
    served = attach_lora(base, lora, lcfg)
    zero_b = attach_lora(base, {"layers": [{t: {"a": f["a"], "b": torch.zeros_like(f["b"])}
                                             for t, f in layer.items()}
                                            for layer in lora["layers"]]}, lcfg)
    s_prompt, new = 128, 128
    ids = torch.randint(10, min(31000, vocab), (8, s_prompt), generator=gen, device=device)
    lens = torch.full((8,), s_prompt, dtype=torch.int32, device=device)
    _zero_launch_counts()
    gen_steps = 0
    step_ms = {}

    def greedy(params, b, n_new):
        out = generate_text(params, cfg, ids[:b], lens[:b],
                            SamplingConfig(greedy=True, max_new_tokens=n_new, eos_token_id=-1),
                            device=device)
        if out["steps"] != n_new or not bool((out["lengths"] == n_new).all()):
            raise AssertionError(f"[qlora-serve] generate_text: steps {out['steps']}")
        return out

    # in turns (bare, attached, attached, bare): the host's speed drifts
    for b in (1, 8):
        for label, params in (("bare int4", base), ("attached", served), ("attached", served),
                              ("bare int4", base)):
            secs = {}
            for n_new in (1, new):
                sync()
                t = time.perf_counter()
                out = greedy(params, b, n_new)
                sync()
                secs[n_new] = time.perf_counter() - t
                gen_steps += out["steps"]
            ms = (secs[new] - secs[1]) / (new - 1) * 1e3
            step_ms.setdefault((label, b), []).append(ms)
            log(f"[qlora-serve] generate_text {label} B{b}: {secs[new]:.3f} s for {b} x {new} "
                f"tokens; decode {ms:.2f} ms a step ({b * 1e3 / ms:.1f} tokens/s)")
    step_ms = {k: sum(v) / len(v) for k, v in step_ms.items()}
    zero_toks, bare_toks = greedy(zero_b, 8, 32)["tokens"], greedy(base, 8, 32)["tokens"]
    gen_steps += 64
    if not torch.equal(zero_toks, bare_toks):
        raise AssertionError("[qlora-serve] a zero-b adapter changed the bare base's tokens")
    gen_launches = _launch_counts()
    if gen_launches != {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0,
                        "w4a16": 7 * layers * gen_steps}:
        raise AssertionError(f"[qlora-serve] launches {gen_launches}, want w4a16 = "
                             f"{7 * layers} x {gen_steps} decode forwards and nothing else")
    log(f"[qlora-serve] attached decode ms a step / bare int4 (means of two runs each): B1 "
        f"{step_ms['attached', 1] / step_ms['bare int4', 1]:.3f}x, B8 "
        f"{step_ms['attached', 8] / step_ms['bare int4', 8]:.3f}x; a zero-b adapter gives the "
        f"bare base's tokens at batch 8 (32 tokens a row); w4a16 launches "
        f"{gen_launches['w4a16']} = {7 * layers} x {gen_steps} decode forwards")

    # one decode step's logits over the attached tree, kernel against plain version
    cache = init_kv_cache(cfg, 8, s_prompt + 1, device=device)
    with torch.no_grad():
        llama_forward(served, cfg, input_ids=ids, kv_cache=cache)
        tok = torch.randint(10, min(31000, vocab), (8, 1), generator=gen, device=device)
        snap = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}

        def one_decode(params=served):
            c = {k: v.clone() if torch.is_tensor(v) else v for k, v in snap.items()}
            o = llama_forward(params, cfg, input_ids=tok, kv_cache=c)
            return llama_logits(params, cfg, o["last_hidden_state"])[:, 0]

        got = one_decode()
        if profile_dir:
            _profile(one_decode, "qlora_attached_decode_step_b8", profile_dir, top=12)
            _profile(lambda: one_decode(base), "int4_unfused_decode_step_b8", profile_dir,
                     top=12)
        kernel = quant4.w4_matmul_cuda
        quant4.w4_matmul_cuda = lambda x, t: quant4.w4_matmul_reference(x, t)  # noqa: E731
        try:
            want_logits = one_decode()
        finally:
            quant4.w4_matmul_cuda = kernel
        rel = ((got - want_logits).norm() / want_logits.norm()).item()
        if not math.isfinite(rel) or rel > W4_STEP_REL_RMS:
            raise AssertionError(f"[qlora-serve] attached decode-step logits, kernel vs plain: "
                                 f"relative RMS {rel} > {W4_STEP_REL_RMS}")
        log(f"[qlora-serve] one attached decode step's logits, kernel vs plain version: relative "
            f"RMS {rel:.3e} (limit {W4_STEP_REL_RMS})")
    del cache, snap

    # -- the engine with the prompt-prefix cache ------------------------------
    hgen = torch.Generator().manual_seed(5)
    systems = [[1] + torch.randint(10, min(31000, vocab), (511,), generator=hgen).tolist()
               for _ in range(2)]
    tails = torch.randint(16, 201, (16,), generator=hgen).tolist()
    news = torch.randint(64, 129, (16,), generator=hgen).tolist()
    reqs = [systems[i % 2] + torch.randint(10, min(31000, vocab), (n,), generator=hgen).tolist()
            for i, n in enumerate(tails)]
    scfg = SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1, pad_token_id=0)

    def serve_all(entries):
        eng = ContinuousBatchingEngine(
            served, cfg, scfg, EngineConfig(slots=8, prefill_len=512, max_len=1024,
                                            chunk_steps=16, cache_dtype="bfloat16",
                                            bos_token_id=1, prefix_cache_entries=entries),
            device=device).warmup(embeds=True).start()
        try:
            t = time.perf_counter()
            with cf.ThreadPoolExecutor(16) as ex:
                futs = [ex.submit(eng.submit, r, max_new_tokens=k, timeout=900)
                        for r, k in zip(reqs, news)]
                answers = [f.result(timeout=900) for f in futs]
            secs = time.perf_counter() - t
        finally:
            eng.stop()
        if any(len(a) != k or not all(0 <= x < vocab for x in a) for a, k in zip(answers, news)):
            raise AssertionError(f"[qlora-engine] answers of lengths {[len(a) for a in answers]}")
        return eng, answers, secs

    _zero_launch_counts()
    # in turns (off, on, on, off), each a fresh engine: the two settings
    # differ by 14 prefills of one chunk, less than the walls' spread
    secs = {0: [], 2: []}
    engine_steps, first = 0, None
    for entries in (0, 2, 2, 0):
        eng, answers, wall = serve_all(entries)
        secs[entries].append(wall)
        engine_steps += eng.decode_steps
        first = first or answers
        if entries and (eng.prefix_hits, eng.prefix_misses) != (14, 2):
            raise AssertionError(f"[qlora-engine] prefix hits {eng.prefix_hits}, misses "
                                 f"{eng.prefix_misses}; want 14 and 2")
        if answers != first:
            bad = [i for i, (a, b) in enumerate(zip(answers, first)) if a != b]
            raise AssertionError(f"[qlora-engine] requests {bad} answer differently with "
                                 f"prefix_cache_entries={entries}")
        if entries:
            eng_on = eng
        else:
            eng_off = eng
        del eng
    # embeddings prompts against ids prompts, on the engine without the cache
    eng_off_steps = eng_off.decode_steps
    eng_off.start()
    try:
        for n in (100, 700):
            p = [1] + torch.randint(10, min(31000, vocab), (n - 1,), generator=hgen).tolist()
            by_ids = eng_off.submit(p, max_new_tokens=32, timeout=900)
            emb = served["embed_tokens"][torch.tensor(p, device=device)]
            if eng_off.submit(prompt_embeds=emb, max_new_tokens=32, timeout=900) != by_ids:
                raise AssertionError(f"[qlora-engine] a {n}-token embeddings prompt answers "
                                     f"unlike its ids")
    finally:
        eng_off.stop()
    n_gen = sum(news)
    log(f"[qlora-engine] serve.py's defaults (8 slots, prefill 512, max_len 1024, chunk 16, bf16 "
        f"cache) over the attached tree: 16 requests under two 512-token system prompts, tails "
        f"{min(tails)}-{max(tails)} tokens, {n_gen} tokens generated; in turns off, on, on, off: "
        f"prefix cache off {[round(x, 3) for x in secs[0]]} s "
        f"({[round(n_gen / x, 1) for x in secs[0]]} tokens/s), on "
        f"{[round(x, 3) for x in secs[2]]} s ({[round(n_gen / x, 1) for x in secs[2]]} "
        f"tokens/s); hits 14, misses 2 each time the cache is on; every answer equal in all "
        f"four runs; embeddings prompts of 100 and 700 tokens equal their ids prompts")
    engine_steps += eng_off.decode_steps - eng_off_steps
    del eng_off

    # -- HTTP, as projects/dreamllm/serve.py builds its server ----------------
    tok = ToyTokenizer(vocab_size=vocab)
    with torch.no_grad():
        chat_params = {"llm": served, "clip_vision_embedding": {
            "clip": init_clip_vision_params(dcfg.vision, generator=gen, device=device),
            "projector": init_projector_params(dcfg.projector_cfg(), generator=gen,
                                               device=device)}}
    steps_before = eng_on.decode_steps
    chat_fn = make_chat_fn(chat_params, dcfg, tok, engine=eng_on, device=device)
    server = ModelServer(
        logprob_fn=lambda ctx, conts: choice_logprobs(served, cfg, tok, ctx, list(conts)),
        host="127.0.0.1", port=0, engine=eng_on, tokenizer=tok, chat_fn=chat_fn).start()
    walls = {}
    try:
        client = OnlineClient(f"http://127.0.0.1:{server.port}", timeout=900)
        t = time.perf_counter()
        if not client.healthy():
            raise AssertionError("[qlora-http] /health did not answer ok")
        walls["health"] = time.perf_counter() - t
        system_text = " ".join(f"w{i}" for i in range(300))
        prompts = [f"{system_text} question {i} " + " ".join(f"q{i}x{j}" for j in range(i + 3))
                   for i in range(16)]
        t = time.perf_counter()
        with cf.ThreadPoolExecutor(16) as ex:
            texts = list(ex.map(lambda p: client.generate(p, max_new_tokens=64), prompts,
                                timeout=900))
        walls["generate x16"] = time.perf_counter() - t
        if any(len(x.split()) != 64 for x in texts):
            raise AssertionError(f"[qlora-http] /generate words {[len(x.split()) for x in texts]}")
        t = time.perf_counter()
        streamed = "".join(client.generate_stream(prompts[3], max_new_tokens=64))
        walls["generate stream"] = time.perf_counter() - t
        if streamed != texts[3]:
            raise AssertionError("[qlora-http] the streamed text differs from /generate's")
        t = time.perf_counter()
        lps = client.logprob("the answer to the question is", [" yes", " no, it is not"])
        walls["logprob"] = time.perf_counter() - t
        if len(lps) != 2 or not all(math.isfinite(x) for x in lps):
            raise AssertionError(f"[qlora-http] /logprob {lps}")
        image = (torch.rand((224, 224, 3), generator=gen, device=device) * 255).byte().cpu()
        t = time.perf_counter()
        out = client.chat([{"role": "user", "content": "<image>\nDescribe this image."}],
                          images=[image.numpy()], max_new_tokens=64)
        walls["chat"] = time.perf_counter() - t
        if not out["text"].strip() or out["images"]:
            raise AssertionError(f"[qlora-http] /chat {out}")
    finally:
        server.stop()
    http_steps = eng_on.decode_steps - steps_before
    serve_launches = _launch_counts()
    want = {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0,
            "w4a16": 7 * layers * (engine_steps + http_steps)}
    if serve_launches != want:
        raise AssertionError(f"[qlora-http] launches over the engines and HTTP {serve_launches}, "
                             f"want {want}")
    log(f"[qlora-http] ModelServer on 127.0.0.1:{server.port} (engine with the prefix cache, "
        f"/logprob by choice_logprobs, /chat through the engine's embeddings lanes): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; /logprob {[round(x, 3) for x in lps]}; chat answered {len(out['text'].split())} "
        f"words; w4a16 launches over the engines and HTTP {serve_launches['w4a16']} = "
        f"{7 * layers} x {engine_steps + http_steps} decode forwards")
    return train_launches, {k: v + serve_launches[k] for k, v in gen_launches.items()}


# ---------------------------------------------------------------------------
# The entry points, as a user starts them
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the recipes name no dtype (float32 in both packages); the flash kernels
# take bf16 only, so every run on the card asks for bf16 by the override
# grammar. The SD-2.1 VAE is bf16 as in the main path; the SDXL head keeps
# its float32 VAE (vae_dtype) and global projector.
MODEL_BF16 = ("+model.llm.dtype=bfloat16", "+model.vision.dtype=bfloat16",
              "+model.vision_projector.dtype=bfloat16")
HEAD_BF16 = ("+sd_head.unet.dtype=bfloat16", "+sd_head.projector.dtype=bfloat16")
SD_VAE_BF16 = ("+sd_head.vae.dtype=bfloat16",)
ENTRY_T2I_STEPS = 20
ENTRY_SDXL_STEPS = 10
ENTRY_TRAIN_STEPS = 3
ENTRY_TRAIN_LAYERS = 4
_ABSENT = object()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(port: int, path: str, body: dict, timeout: float = 600.0) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _pngs(directory: str) -> list:
    import glob

    import numpy as np
    from PIL import Image

    return [np.asarray(Image.open(f)) for f in sorted(glob.glob(f"{directory}/**/*.png",
                                                                recursive=True))]


def _entry_serve(root: str, empty: str) -> dict:
    """``python -m dreamllm_tpu_torch.projects.dreamllm.serve`` on the SFT
    recipe at full width and depth, int4, 8 lanes, prefix cache for 2, random
    parameters (no checkpoint), as a subprocess on a free port."""
    import base64
    import io
    import re
    import signal
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image

    from dreamllm_tpu_torch.config import LazyConfig
    from dreamllm_tpu_torch.projects.dreamllm.train import build_model_cfg

    recipe = os.path.join(REPO, "projects/dreamllm/configs/sft.py")
    layers = build_model_cfg(LazyConfig.load(recipe))[0].llm.num_hidden_layers
    port = _free_port()
    cmd = [sys.executable, "-m", "dreamllm_tpu_torch.projects.dreamllm.serve",
           "--config_file", recipe,
           "tokenizer=toy", "+quantize=int4", "+slots=8", "+prefix_cache_entries=2",
           f"+port={port}", f"run_dir={root}/serve", f"+checkpoint={empty}", *MODEL_BF16]
    log_path = os.path.join(root, "serve.log")
    walls = {}
    t0 = time.perf_counter()
    env = dict(os.environ, WANDB_MODE="disabled")  # no network there
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=logf, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"[entry-serve] the server exited with {proc.returncode}")
            if time.perf_counter() - t0 > 600:
                raise AssertionError("[entry-serve] /health did not answer within 600 s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    if json.loads(r.read()).get("ok"):
                        break
            except OSError:
                time.sleep(0.5)
        walls["start"] = time.perf_counter() - t0

        # 8 prompts of 64 tokens (the server prepends bos to 63 words)
        prompts = [" ".join(f"p{i}w{j}" for j in range(63)) for i in range(8)]
        body = {"max_new_tokens": 32, "greedy": True}
        together = [None] * 8

        def call(i):
            together[i] = _post(port, "/generate", dict(body, prompt=prompts[i]))["text"]

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        walls["generate_x8"] = time.perf_counter() - t
        t = time.perf_counter()
        alone = [_post(port, "/generate", dict(body, prompt=p))["text"] for p in prompts]
        walls["generate_alone_x8"] = time.perf_counter() - t
        for i, (a, b) in enumerate(zip(together, alone)):
            if a is None or len(a.split()) != 32 or a != b:
                first = next((j for j, (x, y) in enumerate(zip((a or "").split(), b.split()))
                              if x != y), None)
                raise AssertionError(f"[entry-serve] prompt {i}: concurrent answer differs from "
                                     f"the same prompt alone at token {first}: {a!r} vs {b!r}")
        t = time.perf_counter()
        lps = _post(port, "/logprob", {"context": prompts[0],
                                       "continuations": ["w1 w2", "w3 w4 w5"]})["logprobs"]
        walls["logprob"] = time.perf_counter() - t
        if len(lps) != 2 or not all(math.isfinite(x) for x in lps):
            raise AssertionError(f"[entry-serve] /logprob {lps}")
        img = (np.random.default_rng(0).random((224, 224, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        t = time.perf_counter()
        chat = _post(port, "/chat", {
            "messages": [{"role": "user", "content": "<image>\nWhat is in the picture?"}],
            "images": [base64.b64encode(buf.getvalue()).decode()], "max_new_tokens": 32})
        walls["chat"] = time.perf_counter() - t
        if not isinstance(chat.get("text"), str) or not chat["text"].strip() or chat["images"]:
            raise AssertionError(f"[entry-serve] /chat {chat}")
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        walls["stop"] = time.perf_counter() - t
    except BaseException:
        log(open(log_path).read()[-4000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = open(log_path).read()
    if proc.returncode != 0:
        log(text[-4000:])
        raise AssertionError(f"[entry-serve] exit code {proc.returncode} after SIGTERM")
    m = re.search(r"stopped after (\d+) engine decode forwards; kernel launches (\{.*\})", text)
    if m is None:
        raise AssertionError("[entry-serve] no launch line in the server's log")
    steps, launches = int(m.group(1)), json.loads(m.group(2))
    # every decode forward has 8 rows: K3 on its 7 projections a layer (the
    # 32064-wide head takes the dequantize product); prefill chunks of 512
    # rows take the dequantize product
    want = {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0, "w4a16": 7 * layers * steps}
    if launches != want:
        raise AssertionError(f"[entry-serve] launches {launches}, want {want}")
    log(f"[entry-serve] python -m ...dreamllm.serve (sft.py, int4, 8 slots, prefix cache 2): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; 8 concurrent answers equal alone; /logprob {[round(x, 3) for x in lps]}; /chat "
        f"{len(chat['text'].split())} words; w4a16 launches {launches['w4a16']} = "
        f"{7 * layers} x {steps} decode forwards (warm-up included)")
    return launches


def _entry_run(label: str, fn, argv: list, want: dict | None = None) -> tuple:
    """``fn(argv)`` (an entry point's ``main``) with the launch counts zeroed
    just before and read just after; every kernel without a count in
    ``want`` must stay at 0. Returns ``(result, launches, wall seconds)``."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    _zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _launch_counts()
    log(f"[{label}] {wall:.3f} s through main(argv), card synchronised; launches {launches}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if want is not None:
        full = {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0, "w4a16": 0, **want}
        if launches != full:
            raise AssertionError(f"[{label}] launches {launches}, want {full}")
    return out, launches, wall


def phase_entry_points() -> dict:
    """The port's entry points as a user starts them, on the recipes of
    ``projects/``, random parameters from the recipes' seeds,
    ``tokenizer=toy`` and the bf16 overrides; every model at full width:

    1. serve (:func:`_entry_serve`): a ``python -m`` subprocess on the SFT
       recipe at full depth, int4, 8 lanes: ``/health``, 8 concurrent
       ``/generate`` (64-token prompts, 32 greedy tokens) each equal to the
       same prompt alone, ``/logprob``, ``/chat`` with a 224x224 image, exit
       within 30 s of SIGTERM; K3 224 a decode forward;
    2. inference through ``main(argv)`` on the SFT recipe at full depth:
       t2i (20 DPM steps, 512 px; K1 by ``pipeline_flash_launches``) and an
       interleaved document (64 new tokens; a PNG for each ``<dream_start>``
       up to 2, K1 for each); DreamLLM-SDXL t2i on its stage-1 recipe
       (10 steps, 1024 px, K1 140 a CFG UNet forward), the path the JAX
       entry breaks without a checkpoint;
    3. train on the DreamLLM stage-1 creation recipe at full width, depth
       cut to 4 layers (its final checkpoint about 4 GB), synthetic pairs,
       batch 2 x 2048, 8-bit AdamW, 3 steps: 3 finite losses in
       ``metrics.jsonl``, the frozen subtrees equal to a fresh init of the
       same recipe bit for bit, K1/K2/K4 as derived, one checkpoint; then
       inference t2i from that checkpoint;
    4. sample: ``stable_diffusion/sample.py`` on SD-2.1 base (20 DPM
       steps, 512 px).

    Everything is written under ``build/entry_points`` and deleted at the
    end. Returns the launches by path."""
    import dataclasses
    import gc
    import glob
    import shutil

    from dreamllm_tpu_torch.config import LazyArgumentParser, LazyConfig, instantiate
    from dreamllm_tpu_torch.models.dreamllm import param_freeze_mask
    from dreamllm_tpu_torch.models.sd.head import SDHeadConfig
    from dreamllm_tpu_torch.projects.dreamllm import inference, train
    from dreamllm_tpu_torch.projects.dreamllm_sdxl import inference as sdxl_inference
    from dreamllm_tpu_torch.projects.stable_diffusion import sample
    from dreamllm_tpu_torch.train.optim import adam_state
    from dreamllm_tpu_torch.train.optim8bit import _Moment
    from dreamllm_tpu_torch.train.tree import tree_leaves, tree_leaves_with_path

    # The card's machine has wandb installed and no network: the train
    # entry's MetricsLogger would start a wandb run. wandb is hidden for the
    # phase (an import of it raises), so that the entry logs to
    # metrics.jsonl, which the checks read.
    saved_wandb = sys.modules.get("wandb", _ABSENT)
    sys.modules["wandb"] = None
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(REPO, "build", "entry_points")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    empty = os.path.join(root, "no_checkpoint")  # no checkpoint: random parameters
    os.makedirs(empty)
    launches, walls = {}, {}
    recipe = {name: os.path.join(REPO, "projects", path) for name, path in (
        ("sft", "dreamllm/configs/sft.py"), ("creation", "dreamllm/configs/stage1_creation.py"),
        ("sdxl", "dreamllm_sdxl/configs/stage1_creation.py"),
        ("sd", "stable_diffusion/configs/base.py"))}
    try:
        launches["entry_serve"] = _entry_serve(root, empty)

        # ---- inference on the SFT recipe, full depth ----
        sft_cfg, sft_head = train.build_model_cfg(LazyConfig.load(recipe["sft"]))
        sd_unet = sft_head.unet
        base = ["--config_file", recipe["sft"], "tokenizer=toy", f"+checkpoint={empty}",
                *MODEL_BF16, *HEAD_BF16, *SD_VAE_BF16]
        t2i_k1 = pipeline_flash_launches(sd_unet, ENTRY_T2I_STEPS, 1, 64)
        out, launches["entry_t2i"], walls["t2i"] = _entry_run(
            "entry-t2i", inference.main,
            base + [f"run_dir={root}/t2i", "+mode=t2i",
                    f"+num_inference_steps={ENTRY_T2I_STEPS}"], {"flash_fwd": t2i_k1})
        imgs = _pngs(out)
        if len(imgs) != 1 or imgs[0].shape != (512, 512, 3):
            raise AssertionError(f"[entry-t2i] PNGs {[i.shape for i in imgs]}")

        out, got, walls["interleaved"] = _entry_run(
            "entry-interleaved", inference.main,
            base + [f"run_dir={root}/interleaved", "+mode=interleaved", "+max_new_tokens=64"])
        doc = open(os.path.join(out, "document.md")).read()
        imgs = _pngs(out)
        # the toy tokenizer writes every id as tok<id>, <dream_start> too
        n_dreams = doc.split().count(f"tok{sft_cfg.special_tokens.dream_start}")
        if (len(imgs) != min(n_dreams, 2) or doc.count("![image](") != len(imgs)
                or any(i.shape != (512, 512, 3) for i in imgs)):
            raise AssertionError(f"[entry-interleaved] {len(imgs)} PNGs, {n_dreams} "
                                 f"<dream_start>, {doc.count('![image](')} links")
        want = {"flash_fwd": len(imgs) * pipeline_flash_launches(sd_unet, 50, 1, 64)}
        if got != {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0, "w4a16": 0, **want}:
            raise AssertionError(f"[entry-interleaved] launches {got}, want {want}")
        launches["entry_interleaved"] = got

        sdxl_unet = train.build_model_cfg(LazyConfig.load(recipe["sdxl"]))[1].unet
        sdxl_k1 = pipeline_flash_launches(sdxl_unet, ENTRY_SDXL_STEPS, 1, 196)
        out, launches["entry_sdxl_t2i"], walls["sdxl_t2i"] = _entry_run(
            "entry-sdxl-t2i", sdxl_inference.main,
            ["--config_file", recipe["sdxl"], "tokenizer=toy", f"+checkpoint={empty}",
             f"run_dir={root}/sdxl", "+mode=t2i", f"+num_inference_steps={ENTRY_SDXL_STEPS}",
             *MODEL_BF16, *HEAD_BF16], {"flash_fwd": sdxl_k1})
        imgs = _pngs(out)
        if len(imgs) != 1 or imgs[0].shape != (1024, 1024, 3):
            raise AssertionError(f"[entry-sdxl-t2i] PNGs {[i.shape for i in imgs]}")

        # ---- train on the stage-1 creation recipe, then inference from its checkpoint ----
        ckpt = os.path.join(root, "train_out")
        depth = f"model.llm.num_hidden_layers={ENTRY_TRAIN_LAYERS}"
        train_argv = [
            "--config_file", recipe["creation"], depth, "tokenizer=toy",
            "data.datasets=['synthetic_pairs']", "data.ratios=null", "data.total_size=null",
            "+data.size_list=[64]", "data.batch_size=2", "+optimizer.optimizer_8bit=true",
            f"trainer.max_steps={ENTRY_TRAIN_STEPS}", "trainer.log_steps=1",
            "trainer.val_steps=0", f"trainer.output_dir={ckpt}", f"run_dir={root}/train",
            *MODEL_BF16, *HEAD_BF16, *SD_VAE_BF16]
        final, got, walls["train"] = _entry_run("entry-train", train.main, train_argv)
        _, config = LazyArgumentParser().parse(train_argv)
        cfg, head_cfg = train.build_model_cfg(config)
        rows = [json.loads(ln) for f in glob.glob(f"{root}/train/*/metrics.jsonl")
                for ln in open(f)]
        losses = [r["train/loss"] for r in rows]
        if len(losses) != ENTRY_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[entry-train] metrics.jsonl losses {losses}")
        moments = [m for m in tree_leaves(adam_state(final.opt_state)["m"])
                   if isinstance(m, _Moment)]
        # 256 px dream images: 32x32 latents at the UNet's first level
        sites, first = unet_flash_sites(dataclasses.replace(head_cfg.unet, sample_size=32), 2,
                                        cfg.n_dream_queries)
        layers = cfg.llm.num_hidden_layers
        want = {"flash_fwd": ENTRY_TRAIN_STEPS * (2 * layers + sites),
                "flash_bwd": ENTRY_TRAIN_STEPS * (layers + sites - first),
                "adam8bit": ENTRY_TRAIN_STEPS * len(moments), "w4a16": 0}
        if got != want or not moments:
            raise AssertionError(f"[entry-train] launches {got}, want {want} "
                                 f"({len(moments)} 8-bit moment leaves)")
        launches["entry_train"] = got
        fresh = train.init_params(config, cfg, head_cfg, torch.device("cuda"))
        mask = dict(tree_leaves_with_path(param_freeze_mask(fresh, cfg)))
        trained = dict(tree_leaves_with_path(final.params))
        frozen = [path for path, m in mask.items() if not m]
        if not frozen or any(not torch.equal(trained[p], leaf)
                             for p, leaf in tree_leaves_with_path(fresh) if not mask[p]):
            raise AssertionError("[entry-train] a frozen parameter changed")
        del fresh, trained, final
        saved = sorted(n for n in os.listdir(ckpt) if n.startswith("checkpoint-"))
        if saved != [f"checkpoint-{ENTRY_TRAIN_STEPS:06d}"]:
            raise AssertionError(f"[entry-train] checkpoints {saved}")
        gib = sum(os.path.getsize(f) for f in glob.glob(f"{ckpt}/*/*")) / 2**30
        log(f"[entry-train] stage1_creation.py at {layers} layers: losses "
            f"{[round(x, 4) for x in losses]}, lm "
            f"{[round(r['train/lm_loss'], 4) for r in rows]}, vm "
            f"{[round(r['train/vm_loss'], 4) for r in rows]}; {len(frozen)} frozen leaves "
            f"unchanged; launches {got}; checkpoint {saved[0]} {gib:.2f} GiB")

        out, launches["entry_t2i_from_train"], walls["t2i_from_train"] = _entry_run(
            "entry-t2i-from-train", inference.main,
            ["--config_file", recipe["creation"], depth, "tokenizer=toy",
             f"+checkpoint={ckpt}", f"run_dir={root}/t2i_trained", "+mode=t2i",
             f"+num_inference_steps={ENTRY_T2I_STEPS}", *MODEL_BF16, *HEAD_BF16,
             *SD_VAE_BF16], {"flash_fwd": t2i_k1})
        imgs = _pngs(out)
        if len(imgs) != 1 or imgs[0].shape != (512, 512, 3):
            raise AssertionError(f"[entry-t2i-from-train] PNGs {[i.shape for i in imgs]}")
        shutil.rmtree(ckpt)

        # ---- plain SD-2.1 sampling ----
        sd_cfg = LazyConfig.load(recipe["sd"])
        sample_unet = SDHeadConfig(**instantiate(sd_cfg["sd_head"])).unet
        out, launches["entry_sample"], walls["sample"] = _entry_run(
            "entry-sample", sample.main,
            ["--config_file", recipe["sd"], f"+checkpoint={empty}", f"run_dir={root}/sample",
             f"num_inference_steps={ENTRY_T2I_STEPS}", *HEAD_BF16, *SD_VAE_BF16],
            {"flash_fwd": pipeline_flash_launches(sample_unet, ENTRY_T2I_STEPS, 1,
                                                  sd_cfg["cond_len"])})
        img = _pngs(os.path.dirname(out))
        if len(img) != 1 or img[0].shape != (512, 512, 3):
            raise AssertionError(f"[entry-sample] PNGs {[i.shape for i in img]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if saved_wandb is _ABSENT:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    log("[entry] walls through main(argv), card synchronised: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    log(f"[entry] launches by path: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Conversion from the published layouts, fine-tuning from them, FID
# ---------------------------------------------------------------------------

CONVERT_T2I_STEPS = 20
CONVERT_SDXL_STEPS = 10
CONVERT_DECODE_TOKENS = 32
INCEPTION_IMAGES = 512  # the reference statistics' images, timed 3 times at batch 32
INCEPTION_BATCH = 32
INCEPTION_REPEATS = 3
PREFETCH_SHARD_PAIRS = 256
PREFETCH_BATCH = 16
CLIP_DIAG_ATOL = 1e-4  # float32 logits (scale exp(log(1/0.07)) = 14.3), card vs CPU
# the HF names of a decoder layer's leaves: (name, stored transposed)
_HF_LLAMA_LAYER = {
    "input_norm": ("input_layernorm.weight", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True), "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True), "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True), "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}
_HF_CLIP_LAYER = {
    "ln1_w": ("layer_norm1.weight", False), "ln1_b": ("layer_norm1.bias", False),
    "ln2_w": ("layer_norm2.weight", False), "ln2_b": ("layer_norm2.bias", False),
    "wq": ("self_attn.q_proj.weight", True), "bq": ("self_attn.q_proj.bias", False),
    "wk": ("self_attn.k_proj.weight", True), "bk": ("self_attn.k_proj.bias", False),
    "wv": ("self_attn.v_proj.weight", True), "bv": ("self_attn.v_proj.bias", False),
    "wo": ("self_attn.out_proj.weight", True), "bo": ("self_attn.out_proj.bias", False),
    "fc1_w": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
    "fc2_w": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False),
}


def _host_tensor(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    return (t.t() if transpose else t).contiguous().cpu()


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_hf_llama(out: str, llm: dict, cfg, layers: int, fmt: str) -> None:
    """The decoder ``llm`` (the port's tree) in ``LlamaForCausalLM``'s
    layout, its first ``layers`` layers: safetensors shards of 8 layers
    (``fmt="safetensors"``) or one ``pytorch_model.bin``."""
    from safetensors.torch import save_file

    os.makedirs(out, exist_ok=True)
    _write_json(os.path.join(out, "config.json"), {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": llm["embed_tokens"].shape[0], "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.kv_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"})
    head = {"model.embed_tokens.weight": _host_tensor(llm["embed_tokens"]),
            "model.norm.weight": _host_tensor(llm["final_norm"]),
            "lm_head.weight": _host_tensor(llm["lm_head"], True)}
    groups = [list(range(i, min(i + 8, layers))) for i in range(0, layers, 8)]
    if fmt == "bin":
        groups = [list(range(layers))]
    for g, ls in enumerate(groups):
        sd = dict(head) if g == 0 else {}
        for l in ls:
            for key, (name, tr) in _HF_LLAMA_LAYER.items():
                sd[f"model.layers.{l}.{name}"] = _host_tensor(llm["layers"][l][key], tr)
        if fmt == "bin":
            torch.save(sd, os.path.join(out, "pytorch_model.bin"))
        else:
            save_file(sd, os.path.join(out, f"model-{g + 1:05d}-of-{len(groups):05d}"
                                            ".safetensors"))
        del sd


def _hf_clip_tower(tree: dict, prefix: str, text: bool) -> dict:
    sd = {}
    if text:
        sd[prefix + "embeddings.token_embedding.weight"] = _host_tensor(tree["token_embedding"])
        sd[prefix + "final_layer_norm.weight"] = _host_tensor(tree["final_ln_w"])
        sd[prefix + "final_layer_norm.bias"] = _host_tensor(tree["final_ln_b"])
    else:
        sd[prefix + "embeddings.class_embedding"] = _host_tensor(tree["class_embedding"])
        sd[prefix + "embeddings.patch_embedding.weight"] = _host_tensor(tree["patch_embedding"])
        for ours, theirs in (("pre_ln", "pre_layrnorm"), ("post_ln", "post_layernorm")):
            sd[f"{prefix}{theirs}.weight"] = _host_tensor(tree[f"{ours}_w"])
            sd[f"{prefix}{theirs}.bias"] = _host_tensor(tree[f"{ours}_b"])
    sd[prefix + "embeddings.position_embedding.weight"] = _host_tensor(tree["position_embedding"])
    for l, layer in enumerate(tree["layers"]):
        for key, (name, tr) in _HF_CLIP_LAYER.items():
            sd[f"{prefix}encoder.layers.{l}.{name}"] = _host_tensor(layer[key], tr)
    return sd


def _clip_vision_json(vc) -> dict:
    return {"hidden_size": vc.hidden_size, "intermediate_size": vc.intermediate_size,
            "num_hidden_layers": vc.num_hidden_layers,
            "num_attention_heads": vc.num_attention_heads, "image_size": vc.image_size,
            "patch_size": vc.patch_size, "layer_norm_eps": vc.layer_norm_eps}


def _write_diffusers(out: str, unet: dict, ucfg, vae: dict, vcfg) -> None:
    from safetensors.torch import save_file

    from dreamllm_tpu_torch.convert.hf_sd import export_unet_state_dict, export_vae_state_dict

    for sub, sd, conf in (
        ("unet", export_unet_state_dict(unet), {
            "sample_size": ucfg.sample_size, "in_channels": ucfg.in_channels,
            "out_channels": ucfg.out_channels,
            "block_out_channels": list(ucfg.block_out_channels),
            "down_block_types": list(ucfg.down_block_types),
            "up_block_types": list(ucfg.up_block_types),
            "layers_per_block": ucfg.layers_per_block,
            "transformer_layers_per_block": list(ucfg.transformer_layers_per_block),
            "attention_head_dim": list(ucfg.num_attention_heads),
            "cross_attention_dim": ucfg.cross_attention_dim, "use_linear_projection": True}),
        ("vae", export_vae_state_dict(vae), {
            "block_out_channels": list(vcfg.block_out_channels),
            "layers_per_block": vcfg.layers_per_block,
            "latent_channels": vcfg.latent_channels, "scaling_factor": vcfg.scaling_factor}),
    ):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
        save_file(sd, os.path.join(out, sub, "diffusion_pytorch_model.safetensors"))
        _write_json(os.path.join(out, sub, "config.json"), conf)


def _run_cli(label: str, args: list, log_dir: str) -> tuple[float, float]:
    """``python -m dreamllm_tpu_torch.convert.cli`` as a subprocess: (wall
    seconds, peak host RSS in GiB of that process, from ``wait4``)."""
    cmd = [sys.executable, "-m", "dreamllm_tpu_torch.convert.cli", *args]
    log_path = os.path.join(log_dir, f"convert_{label}.log")
    t = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        log(open(log_path).read()[-4000:])
        raise AssertionError(f"[convert-{label}] exit code {proc.returncode}")
    return wall, usage.ru_maxrss / 2**20  # KiB -> GiB


class _ProtocolSplit:
    """Within ``with _ProtocolSplit(eval_t2i) as split:``, the entry's
    ``run_protocol`` is timed and its sampling and re-rank callables too
    (card synchronised at each edge): ``split.times`` holds ``protocol``,
    ``sampling`` and ``rerank`` seconds, so that an ``eval_t2i.main`` wall
    splits into start-up (init, checkpoint load, re-ranker and Inception
    init), sampling, re-rank and Inception + FID."""

    def __init__(self, module):
        self.module, self.orig = module, module.run_protocol
        self.times = {"protocol": 0.0, "sampling": 0.0, "rerank": 0.0}

    def _timed(self, key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.times[key] += time.perf_counter() - t
            return out
        return run

    def __enter__(self):
        def protocol(pipeline_fn, clip_score_fn, *a, **k):
            return self._timed("protocol", self.orig)(
                self._timed("sampling", pipeline_fn), self._timed("rerank", clip_score_fn),
                *a, **k)
        self.module.run_protocol = protocol
        return self

    def __exit__(self, *exc):
        self.module.run_protocol = self.orig


def _split_line(wall: float, times: dict, images: int) -> str:
    rest = times["protocol"] - times["sampling"] - times["rerank"]
    return (f"start-up (init, checkpoint load, re-ranker and Inception init) "
            f"{wall - times['protocol']:.3f} s, sampling {times['sampling']:.3f} s "
            f"({times['sampling'] / images:.3f} s an image over {images}), re-rank "
            f"{times['rerank']:.3f} s, Inception + FID {rest:.3f} s")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.to(a.device).reshape(-1).view(torch.uint8)))


def _bit_leaves(tree) -> dict:
    """Path -> tensor of a port tree, a quantized weight's fields apart."""
    import dataclasses

    from dreamllm_tpu_torch.train.tree import tree_leaves_with_path

    out = {}
    for path, x in tree_leaves_with_path(tree):
        if dataclasses.is_dataclass(x):
            out.update({path + (f.name,): getattr(x, f.name) for f in dataclasses.fields(x)})
        else:
            out[path] = x
    return out


def _check_tree(label: str, got, want) -> int:
    """Port trees equal bit for bit; returns the number of leaves."""
    want_leaves = _bit_leaves(want)
    got_leaves = _bit_leaves(got)
    if set(got_leaves) != set(want_leaves):
        raise AssertionError(f"[{label}] leaves differ: "
                             f"{sorted(set(got_leaves) ^ set(want_leaves))[:6]}")
    bad = [p for p, w in want_leaves.items() if not _same_bits(got_leaves[p], w)]
    if bad:
        raise AssertionError(f"[{label}] {len(bad)} leaves differ, first {bad[:4]}")
    return len(want_leaves)


def _mean_init(src: torch.Tensor, n_new: int, axis: int) -> torch.Tensor:
    """The new rows (axis 0) or columns (axis 1) of the vocabulary resize:
    the float32 numpy mean of the bf16 values, rounded to bf16."""
    import numpy as np

    a = src.float().cpu().numpy()
    m = a.mean(axis=axis, keepdims=True)
    reps = (n_new, 1) if axis == 0 else (1, n_new)
    return torch.from_numpy(np.tile(m, reps)).to(src.dtype)


def _expected_llm(src: dict, layers: int, vocab: int) -> dict:
    """The converted decoder: ``src``'s first ``layers`` layers, the
    vocabulary grown to ``vocab`` with mean-init rows, on the card."""
    n_new = vocab - src["embed_tokens"].shape[0]
    emb = torch.cat([src["embed_tokens"], _mean_init(src["embed_tokens"], n_new, 0).cuda()])
    head = torch.cat([src["lm_head"], _mean_init(src["lm_head"], n_new, 1).cuda()], dim=1)
    return {"embed_tokens": emb, "layers": src["layers"][:layers],
            "final_norm": src["final_norm"], "lm_head": head}


def _shards_for_prefetch(root: str, side: int) -> list:
    """2 tar shards of ``PREFETCH_SHARD_PAIRS`` JPEG/caption pairs at
    ``side`` px, written with PIL from seeded noise."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for k in range(2):
        path = os.path.join(root, f"shard{k}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(PREFETCH_SHARD_PAIRS):
                arr = rng.integers(0, 256, (side // 8, side // 8, 3), dtype=np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).resize((side, side)).save(buf, "JPEG", quality=90)
                for ext, data in (("jpg", buf.getvalue()), ("txt", f"pair {k} {i}".encode())):
                    ti = tarfile.TarInfo(f"{k}-{i:05d}.{ext}")
                    ti.size = len(data)
                    tf.addfile(ti, io.BytesIO(data))
        paths.append(path)
    return paths


def _phase_prefetch(root: str) -> dict:
    """Tar shards of 512 px JPEGs through the port's Python reader
    (``data/webdataset.py``, the native loader needs ``jpeglib.h``, which
    the card's machine lacks) in ``background_iterator``, batches of 16,
    ``device_prefetch(size=2)``: every batch equal to a synchronous
    ``.to("cuda")`` of it, bit for bit."""
    import numpy as np

    from dreamllm_tpu_torch.data.prefetch import background_iterator, device_prefetch
    from dreamllm_tpu_torch.data.webdataset import ShardStream

    paths = _shards_for_prefetch(root, 512)
    kept = []

    def batches():
        buf = []
        for s in background_iterator(ShardStream(paths, shuffle_buffer=1, resample=False)):
            buf.append(s)
            if len(buf) == PREFETCH_BATCH:
                b = {"images": torch.from_numpy(np.stack([x["image"] for x in buf])),
                     "ids": torch.tensor([int(x["txt"].split()[-1]) for x in buf])}
                kept.append(b)
                yield b
                buf = []

    torch.cuda.synchronize()
    t = time.perf_counter()
    n = 0
    for got in device_prefetch(batches(), size=2):
        want = kept[n]
        if not (_same_bits(got["images"], want["images"].to("cuda"))
                and _same_bits(got["ids"], want["ids"].to("cuda"))):
            raise AssertionError(f"[convert-prefetch] batch {n} differs from its "
                                 "synchronous copy")
        n += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    images = n * PREFETCH_BATCH
    if images != 2 * PREFETCH_SHARD_PAIRS:
        raise AssertionError(f"[convert-prefetch] {images} images, want {2 * PREFETCH_SHARD_PAIRS}")
    log(f"[convert-prefetch] {images} JPEGs at 512 px through ShardStream -> "
        f"background_iterator -> batches of {PREFETCH_BATCH} -> device_prefetch(size=2): "
        f"every batch equal to its synchronous copy; {images / wall:.1f} images/s decoded "
        f"and copied ({wall:.3f} s)")
    return {"images_per_s": images / wall}


def phase_convert_eval() -> dict:
    """Conversion, fine-tuning and FID evaluation from published layouts, at
    DreamLLM-7B's widths with random weights from a seed:

    1. the port's random 7B decoder (vocab 32000, bf16) written as Vicuna's
       ``LlamaForCausalLM`` safetensors shards (and its first 4 layers as a
       ``.bin`` dir), CLIP ViT-L/14 as ``CLIPVisionModel`` and as a
       ``CLIPModel`` dir, SD-2.1's UNet and VAE as a diffusers dir through
       the port's ``export_*``;
    2. ``python -m dreamllm_tpu_torch.convert.cli --llm --clip --sd
       --vocab_size 32064`` (bf16) and ``--llm --quantize int4``, as two
       subprocesses side by side: walls and peak host RSS;
    3. the bf16 checkpoint equal to the source trees bit for bit (the 64 new
       rows the mean init), the int4 one equal to the on-card
       ``quantize_int4`` of the same bf16 weights, and 32 greedy tokens from
       it equal to those from the on-card quantized tree (K3 224 a decode
       forward);
    4. the train entry on ``stage1_creation.py`` at 4 layers with
       ``pretrained.llm/clip/sd`` (3 steps; the converted leaves, all
       frozen there, equal the sources bit for bit; K1/K2/K4 as the
       entry-points phase's creation run);
    5. ``eval_t2i`` on ``sft.py`` from a checkpoint of the converted groups
       plus seeded plugins (4 captions, 2 seeds, the random CLIP text
       re-ranker, 20 steps, 256 px; K1 by ``pipeline_flash_launches``) and
       on the DreamLLM-SDXL ``stage1_creation.py`` (2 captions, 1 seed, 10
       steps, 1024 px; K1 1400), each wall split by :class:`_ProtocolSplit`;
       Inception's forward over 512 images at batch 32, three times, and
       one batch profiled;
    6. ``convert_clip_model_dir`` on the ``CLIPModel`` dir, then
       ``clip_similarity``'s diagonal on the card against the CPU;
    7. ``device_prefetch`` over JPEG shards (:func:`_phase_prefetch`).

    Everything is written under ``build/convert_eval`` and deleted at the
    end. Returns the launches by path."""
    import concurrent.futures as cf
    import dataclasses
    import gc
    import glob
    import shutil
    import statistics

    import numpy as np

    import dreamllm_tpu_torch.configs as configs
    from dreamllm_tpu_torch.bridge import from_jax
    from dreamllm_tpu_torch.config import LazyConfig
    from dreamllm_tpu_torch.convert.hf_clip import convert_clip_model_dir
    from dreamllm_tpu_torch.eval.fid import (
        inception_pool3,
        init_inception_params,
        save_stats_npz,
    )
    from dreamllm_tpu_torch.eval.text2img import extract_inception_features
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig, generate_text
    from dreamllm_tpu_torch.models.clip import (
        clip_pooled_output,
        clip_preprocess,
        clip_vision_forward,
        init_clip_vision_params,
    )
    from dreamllm_tpu_torch.models.clip_text import (
        CLIPTextConfig,
        clip_similarity,
        clip_text_forward,
        init_clip_text_params,
    )
    from dreamllm_tpu_torch.models.llama import init_llama_params
    from dreamllm_tpu_torch.models.projector import init_projector_params
    from dreamllm_tpu_torch.models.sd.unet import init_unet_params
    from dreamllm_tpu_torch.models.sd.vae import init_vae_params
    from dreamllm_tpu_torch.ops.quant4 import quantize_llama_params_int4
    from dreamllm_tpu_torch.projects.dreamllm import eval_t2i, train
    from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params, save_checkpoint
    from dreamllm_tpu_torch.train.tree import tree_map

    saved_wandb = sys.modules.get("wandb", _ABSENT)
    sys.modules["wandb"] = None  # no network on the card's machine (phase 10)
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(REPO, "build", "convert_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    empty = os.path.join(root, "no_checkpoint")
    os.makedirs(empty)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(110)
    cfg, head_cfg = configs.dreamllm_7b()
    vocab = cfg.llm.vocab_size  # 32064
    hf_vocab = 32000            # Vicuna-7B's
    layers = cfg.llm.num_hidden_layers
    launches, walls, rss = {}, {}, {}
    try:
        # ---- 1. published layouts from the port's random trees ----
        t = time.perf_counter()
        src_llm = init_llama_params(dataclasses.replace(cfg.llm, vocab_size=hf_vocab),
                                    generator=gen, device=dev)
        src_clip = init_clip_vision_params(cfg.vision, generator=gen, device=dev)
        src_unet = init_unet_params(head_cfg.unet, generator=gen, device=dev)
        src_vae = init_vae_params(head_cfg.vae, generator=gen, device=dev)
        d = {k: os.path.join(root, k) for k in ("llm", "llm4", "clip", "clipmodel", "sd")}
        _write_hf_llama(d["llm"], src_llm, cfg.llm, layers, "safetensors")
        _write_hf_llama(d["llm4"], src_llm, cfg.llm, ENTRY_TRAIN_LAYERS, "bin")
        from safetensors.torch import save_file

        os.makedirs(d["clip"])
        save_file(_hf_clip_tower(src_clip, "vision_model.", False),
                  os.path.join(d["clip"], "model.safetensors"))
        _write_json(os.path.join(d["clip"], "config.json"), _clip_vision_json(cfg.vision))
        tcfg = CLIPTextConfig(dtype=torch.float32)  # ViT-L/14's text tower
        src_text = init_clip_text_params(tcfg, generator=gen, device=dev)
        vproj = torch.randn((cfg.vision.hidden_size, tcfg.projection_dim), generator=gen,
                            device=dev) * cfg.vision.hidden_size ** -0.5
        tproj = torch.randn((tcfg.hidden_size, tcfg.projection_dim), generator=gen,
                            device=dev) * tcfg.hidden_size ** -0.5
        clip32 = tree_map(lambda x: x.float(), src_clip)
        sd = {**_hf_clip_tower(clip32, "vision_model.", False),
              **_hf_clip_tower(src_text, "text_model.", True),
              "visual_projection.weight": _host_tensor(vproj, True),
              "text_projection.weight": _host_tensor(tproj, True),
              "logit_scale": torch.tensor(math.log(1 / 0.07))}
        os.makedirs(d["clipmodel"])
        save_file(sd, os.path.join(d["clipmodel"], "model.safetensors"))
        _write_json(os.path.join(d["clipmodel"], "config.json"), {
            "projection_dim": tcfg.projection_dim,
            "vision_config": _clip_vision_json(cfg.vision),
            "text_config": {"vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
                            "intermediate_size": tcfg.intermediate_size,
                            "num_hidden_layers": tcfg.num_hidden_layers,
                            "num_attention_heads": tcfg.num_attention_heads,
                            "max_position_embeddings": tcfg.max_position_embeddings,
                            "layer_norm_eps": tcfg.layer_norm_eps,
                            "projection_dim": tcfg.projection_dim}})
        del sd, clip32
        _write_diffusers(d["sd"], src_unet, head_cfg.unet, src_vae, head_cfg.vae)
        walls["write_layouts"] = time.perf_counter() - t
        gib = {k: sum(os.path.getsize(f) for f in glob.glob(f"{v}/**/*.*", recursive=True))
               / 2**30 for k, v in d.items()}
        log(f"[convert-write] published layouts in {walls['write_layouts']:.3f} s: "
            + ", ".join(f"{k} {v:.2f} GiB" for k, v in gib.items()))

        # ---- 2. the converter CLI, bf16 and int4 ----
        out_bf16, out_int4 = os.path.join(root, "ck_bf16"), os.path.join(root, "ck_int4")
        # the two conversions run side by side on the host's cores: each wall
        # is that of a process sharing the host, the pair's is the phase's cost
        t = time.perf_counter()
        with cf.ThreadPoolExecutor(2) as pool:
            runs = {"convert_bf16": pool.submit(_run_cli, "bf16", [
                        "--llm", d["llm"], "--clip", d["clip"], "--sd", d["sd"],
                        "--vocab_size", str(vocab), "--out", out_bf16], root),
                    "convert_int4": pool.submit(_run_cli, "int4", [
                        "--llm", d["llm"], "--quantize", "int4", "--vocab_size", str(vocab),
                        "--out", out_int4], root)}
            for k, run in runs.items():
                walls[k], rss[k] = run.result()
        walls["convert_pair"] = time.perf_counter() - t
        log(f"[convert-cli] side by side: --llm --clip --sd --vocab_size {vocab} (bf16, source "
            f"{gib['llm'] + gib['clip'] + gib['sd']:.2f} GiB): {walls['convert_bf16']:.3f} s, "
            f"peak RSS {rss['convert_bf16']:.2f} GiB; --llm --quantize int4: "
            f"{walls['convert_int4']:.3f} s, peak RSS {rss['convert_int4']:.2f} GiB; both "
            f"{walls['convert_pair']:.3f} s")

        # ---- 3. the checkpoints against their sources ----
        ck = load_params(latest_checkpoint(out_bf16))
        want_llm = _expected_llm(src_llm, layers, vocab)
        n_leaves = _check_tree("convert-bf16 llm", ck["llm"], want_llm)
        n_leaves += _check_tree("convert-bf16 clip", ck["clip_vision_embedding"]["clip"], src_clip)
        n_leaves += _check_tree("convert-bf16 unet", ck["sd_head"]["unet"], src_unet)
        n_leaves += _check_tree("convert-bf16 vae", ck["sd_head"]["vae"], src_vae)
        q_ck = load_params(latest_checkpoint(out_int4))["llm"]
        bf16_llm = tree_map(lambda x: x.to(dev), ck["llm"])
        del ck
        q_card = quantize_llama_params_int4(bf16_llm)
        n_q = _check_tree("convert-int4", tree_map(lambda x: x.to(dev), q_ck), q_card)
        log(f"[convert-check] bf16 checkpoint: {n_leaves} leaves equal their sources bit for "
            f"bit, the {vocab - hf_vocab} new embedding rows and head columns the mean init; "
            f"int4 checkpoint: {n_q} leaves equal the on-card quantize_int4 of the bf16 weights")
        q_ck = tree_map(lambda x: x.to(dev), q_ck)
        del bf16_llm
        ids = torch.randint(10, hf_vocab, (1, 16), generator=gen, device=dev)
        lens = torch.tensor([16], device=dev)
        scfg = SamplingConfig(greedy=True, max_new_tokens=CONVERT_DECODE_TOKENS)
        outs, steps = [], 0
        for label, tree in (("checkpoint", q_ck), ("on-card", q_card)):
            out, got, _ = _entry_run(f"convert-decode-{label}", lambda _: generate_text(
                tree, cfg.llm, ids, lens, scfg, device=dev), [])
            steps = out["steps"]
            want = {"w4a16": 7 * layers * steps}
            if got != {"flash_fwd": 0, "flash_bwd": 0, "adam8bit": 0, **want}:
                raise AssertionError(f"[convert-decode] launches {got}, want {want}")
            launches[f"convert_decode_{label}"] = got
            outs.append(out["tokens"])
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError("[convert-decode] the converted int4 checkpoint's tokens "
                                 "differ from the on-card quantized tree's")
        log(f"[convert-decode] {CONVERT_DECODE_TOKENS} greedy tokens from the int4 checkpoint "
            f"equal the on-card quantized tree's; w4a16 {7 * layers} x {steps} decode forwards "
            "a run")
        del q_ck, q_card, outs
        shutil.rmtree(out_int4)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 4. fine-tuning from the converted weights ----
        creation = os.path.join(REPO, "projects/dreamllm/configs/stage1_creation.py")
        train_out = os.path.join(root, "train_out")
        train_argv = [
            "--config_file", creation, f"model.llm.num_hidden_layers={ENTRY_TRAIN_LAYERS}",
            "tokenizer=toy", "data.datasets=['synthetic_pairs']", "data.ratios=null",
            "data.total_size=null", "+data.size_list=[64]", "data.batch_size=2",
            "+optimizer.optimizer_8bit=true", f"trainer.max_steps={ENTRY_TRAIN_STEPS}",
            "trainer.log_steps=1", "trainer.val_steps=0", f"trainer.output_dir={train_out}",
            f"run_dir={root}/train", f"+pretrained.llm={d['llm4']}",
            f"+pretrained.clip={d['clip']}", f"+pretrained.sd={d['sd']}",
            *MODEL_BF16, *HEAD_BF16, *SD_VAE_BF16]
        final, got, walls["train"] = _entry_run("convert-train", train.main, train_argv)
        # as the entry-points phase's run of the same recipe and depth
        want = {"flash_fwd": 39, "flash_bwd": 24, "adam8bit": 6, "w4a16": 0}
        if got != want:
            raise AssertionError(f"[convert-train] launches {got}, want {want}")
        launches["convert_train"] = got
        n_conv = _check_tree("convert-train llm", final.params["llm"],
                             _expected_llm(src_llm, ENTRY_TRAIN_LAYERS, vocab))
        n_conv += _check_tree("convert-train clip",
                              final.params["clip_vision_embedding"]["clip"], src_clip)
        n_conv += _check_tree("convert-train unet", final.params["sd_head"]["unet"], src_unet)
        n_conv += _check_tree("convert-train vae", final.params["sd_head"]["vae"], src_vae)
        losses = [json.loads(ln)["train/loss"] for f in glob.glob(f"{root}/train/*/metrics.jsonl")
                  for ln in open(f)]
        if len(losses) != ENTRY_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[convert-train] losses {losses}")
        log(f"[convert-train] stage1_creation.py at {ENTRY_TRAIN_LAYERS} layers from "
            f"pretrained.llm/clip/sd: {walls['train']:.3f} s, losses "
            f"{[round(x, 4) for x in losses]}; the {n_conv} converted leaves (all frozen in "
            f"this recipe) equal their sources bit for bit after {ENTRY_TRAIN_STEPS} steps, so "
            f"at step 0; launches {got}; checkpoint "
            f"{os.path.basename(latest_checkpoint(train_out))}")
        del final
        shutil.rmtree(train_out)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 5. FID: the reference statistics and eval_t2i ----
        inception = init_inception_params(generator=torch.Generator(device=dev).manual_seed(2),
                                          device=dev)
        ref_imgs = np.random.default_rng(5).random(
            (INCEPTION_IMAGES, 256, 256, 3)).astype(np.float32)
        batches = torch.from_numpy(ref_imgs).to(dev).split(INCEPTION_BATCH)
        inception_pool3(inception, batches[0])  # warm-up
        fwd_rates = []
        for _ in range(INCEPTION_REPEATS):  # the forward alone: images already on the card
            torch.cuda.synchronize()
            t = time.perf_counter()
            for b in batches:
                inception_pool3(inception, b)
            torch.cuda.synchronize()
            fwd_rates.append(len(ref_imgs) / (time.perf_counter() - t))
        t = time.perf_counter()  # as eval_t2i calls it: host copies in, features out
        feats = extract_inception_features(inception, ref_imgs, batch_size=INCEPTION_BATCH)
        e2e_rate = len(ref_imgs) / (time.perf_counter() - t)
        log(f"[convert-inception] pool3 at batch {INCEPTION_BATCH}, 256 px, float32, TF32 off, "
            f"{len(ref_imgs)} images: forward alone {[round(r, 1) for r in fwd_rates]} images/s "
            f"(median {statistics.median(fwd_rates):.1f}); through "
            f"extract_inception_features (host copy and read included) {e2e_rate:.1f} images/s")
        _profile(lambda: inception_pool3(inception, batches[0]), "inception_b32", root,
                 trace=False, top=6)
        inc_rate = statistics.median(fwd_rates)
        save_stats_npz(feats, os.path.join(root, "ref.npz"))
        del inception, feats, ref_imgs, batches
        captions = ["a red bird on a branch", "a bowl of fruit on a table",
                    "a city street at night", "a dog running on a beach"]
        _write_json(os.path.join(root, "caps.json"), captions)
        _write_json(os.path.join(root, "caps2.json"), captions[:2])

        # the converted groups plus seeded plugins: one checkpoint of sft.py's tree
        sft = os.path.join(REPO, "projects/dreamllm/configs/sft.py")
        shead = train.build_model_cfg(LazyConfig.load(sft))[1]
        h = cfg.llm.hidden_size
        conv = load_params(latest_checkpoint(out_bf16))
        full_root = os.path.join(root, "ck_full")
        groups = tree_map(lambda x: x.cpu(), {
            "clip_vision_embedding": {
                "clip": conv["clip_vision_embedding"]["clip"],
                "projector": init_projector_params(cfg.projector_cfg(), generator=gen,
                                                   device=dev)},
            "dream_embedding": {"queries": (torch.randn((cfg.n_dream_queries, h), generator=gen,
                                                        device=dev) * h ** -0.5).bfloat16()},
            "sd_head": {"unet": conv["sd_head"]["unet"], "vae": conv["sd_head"]["vae"],
                        "projector": init_projector_params(head_cfg.projector_cfg(),
                                                           generator=gen, device=dev)},
        })
        del conv
        full = save_checkpoint(full_root, 0, groups)
        os.link(os.path.join(latest_checkpoint(out_bf16), "llm.pt"), os.path.join(full, "llm.pt"))
        meta = json.load(open(os.path.join(full, "meta.json")))
        meta["param_groups"] = sorted(meta["param_groups"] + ["llm"])
        _write_json(os.path.join(full, "meta.json"), meta)
        del groups
        gc.collect()

        eval_common = [f"+fid_reference={root}/ref.npz", "+sample_batch_size=2", "tokenizer=toy",
                       *MODEL_BF16, *HEAD_BF16]
        sites = pipeline_flash_launches(dataclasses.replace(shead.unet, sample_size=32),
                                        CONVERT_T2I_STEPS, 1, 64)
        n_calls = 2 * len(captions) // 2  # 2 seeds x 2 chunks of 2 captions
        with _ProtocolSplit(eval_t2i) as split_sd:
            out, got, walls["eval_t2i"] = _entry_run(
                "convert-eval-t2i", eval_t2i.main,
                ["--config_file", sft, f"+checkpoint={full_root}",
                 f"+captions_json={root}/caps.json", "+num_seeds=2",
                 "+use_random_clip_text=true", f"+num_inference_steps={CONVERT_T2I_STEPS}",
                 "+fid_image_size=256", f"run_dir={root}/eval_sd", *eval_common, *SD_VAE_BF16],
                {"flash_fwd": sites * n_calls})
        launches["convert_eval_t2i"] = got
        if out["n"] != len(captions) or not math.isfinite(out["fid"]) or \
                out["inception"] != "random":
            raise AssertionError(f"[convert-eval-t2i] {out}")
        written = glob.glob(f"{root}/eval_sd/*/fid_rank0.json")
        if len(written) != 1 or json.load(open(written[0])) != out:
            raise AssertionError(f"[convert-eval-t2i] fid_rank0.json {written}")
        fid_sd = out["fid"]
        sdxl_recipe = os.path.join(REPO, "projects/dreamllm_sdxl/configs/stage1_creation.py")
        sdxl_unet = train.build_model_cfg(LazyConfig.load(sdxl_recipe))[1].unet
        with _ProtocolSplit(eval_t2i) as split_sdxl:
            out, got, walls["eval_sdxl"] = _entry_run(
                "convert-eval-sdxl", eval_t2i.main,
                ["--config_file", sdxl_recipe, f"+checkpoint={empty}",
                 f"+captions_json={root}/caps2.json", "+num_seeds=1",
                 f"+num_inference_steps={CONVERT_SDXL_STEPS}", "+fid_image_size=1024",
                 f"run_dir={root}/eval_sdxl", *eval_common],
                {"flash_fwd": pipeline_flash_launches(sdxl_unet, CONVERT_SDXL_STEPS, 1, 196)})
        launches["convert_eval_sdxl"] = got
        if out["n"] != 2 or not math.isfinite(out["fid"]):
            raise AssertionError(f"[convert-eval-sdxl] {out}")
        log(f"[convert-eval] eval_t2i on sft.py from the converted checkpoint (4 captions x 2 "
            f"seeds, random CLIP text re-rank, {CONVERT_T2I_STEPS} steps, 256 px): "
            f"{walls['eval_t2i']:.3f} s, FID {fid_sd:.6f} (random Inception); DreamLLM-SDXL "
            f"(2 captions, {CONVERT_SDXL_STEPS} steps, 1024 px): {walls['eval_sdxl']:.3f} s, "
            f"FID {out['fid']:.6f}; Inception forward {inc_rate:.1f} images/s at batch "
            f"{INCEPTION_BATCH} (256 px, float32, TF32 off)")
        log("[convert-eval] sft.py: " + _split_line(walls["eval_t2i"], split_sd.times,
                                                   2 * len(captions)))
        log("[convert-eval] DreamLLM-SDXL: " + _split_line(walls["eval_sdxl"], split_sdxl.times, 2))
        shutil.rmtree(out_bf16)
        shutil.rmtree(full_root)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 6. the CLIPModel dir: the re-ranker's similarity, card against CPU ----
        (vcfg, vtree), (tcfg2, ttree), vp, tp, ls = convert_clip_model_dir(d["clipmodel"])
        rng = np.random.default_rng(7)
        images = torch.from_numpy(rng.random((4, 224, 224, 3)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(1, 49000, (4, 77)))
        for i, n in enumerate((5, 9, 20, 76)):
            ids[i, n] = 49407  # EOT, the largest id: the pooled position
        diags = []
        for where in ("cuda", "cpu"):
            vparams = from_jax(vtree, init_clip_vision_params(vcfg, device="meta"), device=where)
            tparams = from_jax(ttree, init_clip_text_params(tcfg2, device="meta"), device=where)
            with torch.no_grad():
                pix = clip_preprocess(images.to(where), vcfg.image_size)
                img = clip_pooled_output(vparams, vcfg, clip_vision_forward(vparams, vcfg, pix))
                _, txt = clip_text_forward(tparams, tcfg2, ids.to(where))
                sims = clip_similarity(img, txt, vp.to(where), tp.to(where), ls.to(where))
            diags.append(torch.diagonal(sims).cpu())
        err = (diags[0] - diags[1]).abs().max().item()
        if not torch.isfinite(diags[0]).all() or err > CLIP_DIAG_ATOL:
            raise AssertionError(f"[convert-clip] diagonal card {diags[0]} vs CPU {diags[1]}")
        log(f"[convert-clip] convert_clip_model_dir (ViT-L/14 towers, float32) -> "
            f"clip_similarity diagonal {[round(x, 4) for x in diags[0].tolist()]}, card vs CPU "
            f"max |diff| {err:.2e} (limit {CLIP_DIAG_ATOL})")

        # ---- 7. JPEG shards through device_prefetch ----
        rates = _phase_prefetch(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if saved_wandb is _ABSENT:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved_wandb
    log("[convert] walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; peak RSS {rss}; prefetch {rates['images_per_s']:.1f} images/s")
    log(f"[convert] launches by path: {launches}")
    return launches


def _profile(fn, label: str, out_dir: str, trace: bool = True, top: int = 8,
             ranges: tuple = ()) -> None:
    """Wall time of ``fn`` (synchronised, unprofiled), then one profiled run:
    device time summed over the CUDA kernels, the busy share, the top
    kernels, and (``trace``) a Chrome trace under ``out_dir``. ``ranges``:
    names of ``record_function`` ranges inside ``fn``; each one's kernel time
    (summed over the kernels launched inside it) and share of the device
    time are logged, and its device-side annotation is not counted as a
    kernel."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms "
        f"(busy {dev_ms / wall_ms:.1%}), {sum(e.count for e in kernels)} kernel launches")
    for e in prof.key_averages():
        if e.key in ranges and e.device_type == DeviceType.CPU:
            ms = e.device_time_total / 1e3
            log(f"[profile] {label}: range {e.key} x{e.count}: kernels {ms:.3f} ms "
                f"({ms / max(dev_ms, 1e-9):.1%} of the device time)")
    for e in sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:top]:
        log(f"[profile] {label}:   {e.device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    for e in kernels:  # the port's own kernels, wherever they rank
        if any(n in e.key for n in ("flash_", "adam8bit", "w4a16")):
            log(f"[profile] {label}: own {e.device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
                f"{e.key[:90]}")
    if trace:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{label}.json"))


def _profile_main(params, cfg, head, head_cfg, out_dir: str) -> None:
    """One CFG UNet step at 512 px, full and DeepCache-shallow, and one
    decode step over a 700-slot cache."""
    from dreamllm_tpu_torch.models.llama import init_kv_cache, llama_forward, llama_logits
    from dreamllm_tpu_torch.models.sd.unet import unet_forward, unet_forward_shallow

    gen = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((2, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    ctx = torch.randn((2, 64, 1024), generator=gen, device="cuda").bfloat16()
    ts = torch.full((2,), 500, device="cuda")
    cache = init_kv_cache(cfg.llm, 1, 700, device="cuda")
    cache["index"] = 600
    tok = torch.ones((1, 1), dtype=torch.long, device="cuda")

    def decode_step():
        cache["index"] = 600
        o = llama_forward(params["llm"], cfg.llm, input_ids=tok, kv_cache=cache)
        return llama_logits(params["llm"], cfg.llm, o["last_hidden_state"])

    with torch.no_grad():
        _profile(lambda: unet_forward(head["unet"], head_cfg.unet, lat, ts, ctx), "unet_cfg_step",
                 out_dir)
        _, deep = unet_forward(head["unet"], head_cfg.unet, lat, ts, ctx, return_deep=True)
        _profile(lambda: unet_forward_shallow(head["unet"], head_cfg.unet, lat, ts, ctx, deep),
                 "unet_shallow_cfg_step", out_dir)
        _profile(decode_step, "decode_step", out_dir)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# name -> (source, the TPU kernel body it replaces, the launch mix of its main
# path as (shape-name prefix, launches per unit of work)). flash_fwd keeps the
# serving mix (one UNet forward: 5 launches at each level); flash_bwd and
# adam8bit take one train step's (the UNet's first 64x64 site needs no
# backward, see phase_train); w4a16 one fused int4 decode step's. The QLoRA
# paths' launches (flash_fwd, flash_bwd and adam8bit on its float32 factors
# in training, w4a16 in serving) stand in ``launches_by_path``. MIXES adds
# other paths' means: one SDXL UNet forward at 1024 px (unet_flash_sites'
# 140: at 64x64 and at 32x32 10 and 60 self-attentions and as many
# cross-attentions over the 196 dream queries) and its backward in the SDXL
# creation step.
KERNELS = {
    "flash_fwd": ("dreamllm_tpu_torch/csrc/flash_fwd.cu", "dreamllm_tpu/ops/attention.py:133",
                  (("unet64x64", 5), ("unet32x32", 5))),
    "flash_bwd": ("dreamllm_tpu_torch/csrc/flash_bwd.cu", "dreamllm_tpu/ops/attention.py:369",
                  (("train causal-seg", 32), ("unet64x64", 4), ("unet32x32", 5))),
    "adam8bit": ("dreamllm_tpu_torch/csrc/adam8bit.cu", "dreamllm_tpu/train/optim8bit.py:64",
                 (("w_gate", 96), ("wq", 128), ("norm", 65))),
    # one fused 7B decode step at batch 8: 32 launches at each shape
    "w4a16": ("dreamllm_tpu_torch/csrc/w4a16.cu", "dreamllm_tpu/ops/quant4.py:114",
              (("wqkv 4096x12288 B8", 32), ("wo 4096x4096 B8", 32),
               ("w_gate_up 4096x22016 B8", 32), ("w_down 11008x4096 B8", 32))),
}


_SDXL_UNET_MIX = (("sdxl64x64 ", 10), ("sdxl32x32 ", 60), ("sdxl64x64-cross", 10),
                  ("sdxl32x32-cross", 60))
MIXES = {"flash_fwd": {"sdxl_unet_forward": _SDXL_UNET_MIX},
         "flash_bwd": {"sdxl_unet_backward": _SDXL_UNET_MIX}}


def _mix_means(rows: list, mix: tuple) -> dict:
    """``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` a launch over a
    launch mix of ``(shape-name prefix, launches)``."""
    picked = [(next(r for r in rows if r["shape"].startswith(prefix)), w) for prefix, w in mix]
    total = sum(w for _, w in picked)

    def mean(key):
        if any(r[key] is None for r, _ in picked):
            return None
        return sum(r[key] * w for r, w in picked) / total

    return {key: mean(key) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}


def kernel_line(checks: dict, launches: dict) -> dict:
    """One entry per kernel. ``ms``, ``plain_ms``, ``library_ms`` (device
    times, :func:`device_ms`) and ``bound_ms`` are means per launch over the
    kernel's main-path launch mix (``KERNELS``); ``launches`` sums the main
    paths' runs, and ``launches_by_path`` keeps them apart; ``per_shape``
    keeps every shape set, with ``call_ms`` (:func:`cuda_ms`) beside ``ms``."""
    out = []
    for name, (source, replaces, mix) in KERNELS.items():
        rows = checks[name]
        means = _mix_means(rows, mix)
        by_path = {path: counts[name] for path, counts in launches.items() if name in counts}
        extra = {"row_invariance": checks[f"{name}_row_invariance"]} \
            if f"{name}_row_invariance" in checks else {}
        if name in MIXES:
            extra["mixes"] = {label: _mix_means(rows, m) for label, m in MIXES[name].items()}
        first = next(r for r in rows if r["shape"].startswith(mix[0][0]))
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows), **means,
            "bound_by": first["bound_by"], "per_shape": rows, **extra,
        })
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-main", action="store_true",
                    help="stop after the kernel checks (no model run, serving or training)")
    alone = {"entry_points": phase_entry_points, "convert_eval": phase_convert_eval}
    ap.add_argument("--only", choices=alone,
                    help="after the build, run this phase alone (no kernel checks, no "
                         "kernels line)")
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one UNet step, full and shallow, and one decode step "
                         "(Chrome traces to DIR) and one train step, one SDXL UNet step "
                         "and one ControlNet step (kernel sums only)")
    args = ap.parse_args()

    start = time.perf_counter()
    line = phase_env()
    phase_build()
    launches = {}
    if args.only:
        alone[args.only]()
        log(f"[time] build and {args.only}: {time.perf_counter() - start:.1f} s")
        log(line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    checks = phase_kernels()
    log(f"[time] after kernels: {time.perf_counter() - start:.1f} s")
    if not args.no_main:
        phase_small_reference()
        phase_small_train()
        phase_small_quant()
        phase_small_qlora()
        phase_small_decode_variants()
        log(f"[time] after small phases: {time.perf_counter() - start:.1f} s")
        launches["serving"], model = phase_main(args.profile)
        log(f"[time] after main document: {time.perf_counter() - start:.1f} s")
        launches["t2i"], launches["t2i_deepcache2"] = phase_t2i(model)
        launches["serving_deepcache2"] = phase_document_dc2(model)
        launches["chat"] = phase_chat(model)
        log(f"[time] after t2i and chat: {time.perf_counter() - start:.1f} s")
        launches["sdxl_serving"], launches["sdxl_t2i"], sdxl, images = phase_sdxl(
            model, args.profile)
        launches["clip_text"] = phase_clip_text(model, images)
        log(f"[time] after sdxl and clip text: {time.perf_counter() - start:.1f} s")
        del images
        sdxl = list(sdxl)  # phase_sdxl_train empties it
        launches["sdxl_training"] = phase_sdxl_train(sdxl)
        log(f"[time] after sdxl training: {time.perf_counter() - start:.1f} s")
        del sdxl
        torch.cuda.empty_cache()
        launches["controlnet"] = phase_controlnet(model, args.profile)
        log(f"[time] after controlnet: {time.perf_counter() - start:.1f} s")
        torch.cuda.empty_cache()
        launches["llava_training"] = phase_llava_train(model)
        log(f"[time] after llava training: {time.perf_counter() - start:.1f} s")
        torch.cuda.empty_cache()
        model = list(model)  # phase_train empties it: nothing here keeps the parameters alive
        launches["training"] = phase_train(model, args.profile)
        log(f"[time] after training: {time.perf_counter() - start:.1f} s")
        del model
        torch.cuda.empty_cache()
        launches["quantized_serving"], int4_base = phase_serve_int4(args.profile)
        log(f"[time] after int4 serving: {time.perf_counter() - start:.1f} s")
        torch.cuda.empty_cache()
        launches.update(phase_decode_variants(int4_base))
        log(f"[time] after decode variants: {time.perf_counter() - start:.1f} s")
        torch.cuda.empty_cache()
        launches["qlora_training"], launches["qlora_serving"] = phase_qlora(int4_base,
                                                                            args.profile)
        log(f"[time] after qlora: {time.perf_counter() - start:.1f} s")
        del int4_base
        launches.update(phase_entry_points())
        log(f"[time] after entry points: {time.perf_counter() - start:.1f} s")
        launches.update(phase_convert_eval())
    log(f"[time] every phase: {time.perf_counter() - start:.1f} s")
    log(line)
    print(json.dumps(kernel_line(checks, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
