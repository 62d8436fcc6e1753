"""Multimodal chat in the PyTorch port against the JAX package, on the CPU:
the conversation templates (rendered byte for byte), the sample types and
tokenizer adapters, ``encode_chat_prompt`` (ids, image positions and CLIP
pixels within 1e-5), a text-out ``chat`` turn and an image-out one
(``head_params`` given: ``generate_interleaved``, with the same start
latents), and ``make_chat_fn`` on the same requests. Weights are JAX's
(``bridge.from_jax``), float32. Greedy tokens must be identical; every
pick's top-2 logit margin is asserted first (above 10x the logits' 1e-4
tolerance), as in the other greedy parity tests. Images within 1e-3, as in
``test_torch_generation.py``.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.data.conversation as jconv
import dreamllm_tpu.data.dataset_types as jtypes
import dreamllm_tpu.data.tokenization as jtok
import dreamllm_tpu.generation.chat as jchat
import dreamllm_tpu.generation.interleaved as jgen
import dreamllm_tpu.generation.sampler as jsamp
import dreamllm_tpu.models.sd.head as jhead
import dreamllm_tpu_torch.data.conversation as pconv
import dreamllm_tpu_torch.data.dataset_types as ptypes
import dreamllm_tpu_torch.data.tokenization as ptok
import dreamllm_tpu_torch.generation.chat as pchat
import dreamllm_tpu_torch.generation.interleaved as pgen
import dreamllm_tpu_torch.generation.sampler as psamp
import dreamllm_tpu_torch.models.sd.head as phead
from dreamllm_tpu_torch.utils.errors import ClientError
from tests._torch_port_helpers import dreamllm_params, head_params, n, t
from tests._torch_serve_helpers import logit_margins

LOGIT_TOL = 1e-4

DIALOGS = [
    [("user", "<image>\nWhat is in this picture?")],
    [("user", "Hello there"), ("assistant", "Hi! How can I help?"),
     ("user", "Describe <image> and then <image> briefly.")],
    [("system", "ignored by most templates"), ("user", "  spaced   question  ")],
]


def _msgs(mod, dialog):
    return [mod.Message(r, c) for r, c in dialog]


# ---------------------------------------------------------------------------
# Templates, sample types, tokenizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jconv.TEMPLATES))
def test_templates_render_byte_for_byte(name):
    jt, pt = jconv.TEMPLATES[name], pconv.TEMPLATES[name]
    assert dataclasses.asdict(pt) == dataclasses.asdict(jt)
    for dialog in DIALOGS:
        for system in (None, "A custom system prompt."):
            js = jconv.render_conversation(jt, _msgs(jtypes, dialog), system)
            ps = pconv.render_conversation(pt, _msgs(ptypes, dialog), system)
            assert [(s.text, s.learnable) for s in ps] == [(s.text, s.learnable) for s in js]
            assert (pconv.render_prompt(pt, _msgs(ptypes, dialog), system)
                    == jconv.render_prompt(jt, _msgs(jtypes, dialog), system))


def test_sample_types_match_jax():
    assert [(e.name, e.value) for e in ptypes.DatasetType] == [
        (e.name, e.value) for e in jtypes.DatasetType]
    for name in ("ImageTextPair", "InterleavedImageText", "InstructInterleavedImageText",
                 "ImageImagePair", "Message", "ConversationSample", "TextOnly", "VideoTextPair"):
        pf = [(f.name, str(f.default)) for f in dataclasses.fields(getattr(ptypes, name))]
        jf = [(f.name, str(f.default)) for f in dataclasses.fields(getattr(jtypes, name))]
        assert [f[0] for f in pf] == [f[0] for f in jf], name
        assert [d.split(".")[-1] for _, d in pf] == [d.split(".")[-1] for _, d in jf], name


def test_hf_tokenizer_adapters_agree(tmp_path):
    """Both adapters over one local tokenizer (a word-level vocabulary built
    here, no download): the same special-token ids, encodings, offsets and
    decodings."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<unk>", "<s>", "</s>", "a", "photo", "of", "dog", "USER:", "ASSISTANT:", "###"]
    core = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=core, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(str(tmp_path))
    jt, pt = jtok.HFTokenizer(str(tmp_path)), ptok.HFTokenizer(str(tmp_path))
    assert dataclasses.asdict(pt.special) == dataclasses.asdict(jt.special)
    assert pt.special.dream_start >= len(words) and len(pt) == len(jt) == len(words) + 7
    text = "USER: a photo of <dream_start> dog ### ASSISTANT: cat"
    assert pt.encode(text) == jt.encode(text)
    assert pt.encode_with_offsets(text) == jt.encode_with_offsets(text)
    assert pt.decode(pt.encode(text)) == jt.decode(jt.encode(text))


# ---------------------------------------------------------------------------
# encode_chat_prompt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 255.0], ids=["unit", "bytes"])
def test_encode_chat_prompt_matches_jax(scale):
    jc, pc, _, _ = dreamllm_params()
    rng = np.random.default_rng(2)
    images = [(rng.random((40, 48, 3)) * scale).astype(np.float32),
              (rng.random((20, 20, 3)) * scale).astype(np.float32)]
    dialog = DIALOGS[1]
    jids, jpix, jpos = jchat.encode_chat_prompt(jtok.ToyTokenizer(), jc, _msgs(jtypes, dialog),
                                                images)
    pids, ppix, ppos = pchat.encode_chat_prompt(ptok.ToyTokenizer(), pc, _msgs(ptypes, dialog),
                                                images, device="cpu")
    assert pids.dtype == torch.long and ppos.dtype == torch.int32
    np.testing.assert_array_equal(n(pids), np.asarray(jids))
    np.testing.assert_array_equal(n(ppos), np.asarray(jpos))
    assert tuple(ppix.shape) == (1, 2, 32, 32, 3)
    np.testing.assert_allclose(n(ppix), np.asarray(jpix), atol=1e-5)
    # a tensor image takes the same path
    _, tpix, _ = pchat.encode_chat_prompt(ptok.ToyTokenizer(), pc, _msgs(ptypes, dialog),
                                          [t(im) for im in images], device="cpu")
    assert torch.equal(tpix, ppix)


def test_encode_chat_prompt_text_only_and_count_mismatch():
    jc, pc, _, _ = dreamllm_params()
    ids, pix, pos = pchat.encode_chat_prompt(ptok.ToyTokenizer(), pc, _msgs(ptypes, DIALOGS[2]),
                                             device="cpu")
    jids, _, _ = jchat.encode_chat_prompt(jtok.ToyTokenizer(), jc, _msgs(jtypes, DIALOGS[2]))
    assert pix is None and pos is None
    np.testing.assert_array_equal(n(ids), np.asarray(jids))
    with pytest.raises(ClientError, match="placeholders"):
        pchat.encode_chat_prompt(ptok.ToyTokenizer(), pc, _msgs(ptypes, DIALOGS[0]), [],
                                 device="cpu")


# ---------------------------------------------------------------------------
# chat: text out and image out
# ---------------------------------------------------------------------------


def test_chat_text_out_matches_jax(monkeypatch):
    """One turn with an image, vicuna_v1.1, 8 greedy tokens (EOS off, so
    random weights decode the whole budget), on both packages' default
    bf16 cache."""
    jc, pc, jp, pp = dreamllm_params()
    image = np.random.default_rng(11).random((32, 32, 3)).astype(np.float32)
    kw = dict(greedy=True, max_new_tokens=8, eos_token_id=-1)
    want = jchat.chat(jp, jc, jtok.ToyTokenizer(), _msgs(jtypes, DIALOGS[0]), [image],
                      sampling=jsamp.SamplingConfig(**kw))
    margins = logit_margins(monkeypatch, psamp)
    got = pchat.chat(pp, pc, ptok.ToyTokenizer(), _msgs(ptypes, DIALOGS[0]), [image],
                     sampling=psamp.SamplingConfig(**kw), device="cpu")
    assert len(margins) == 9 and min(margins) > 10 * LOGIT_TOL, margins
    assert got == {"text": want["text"], "images": []}
    assert len(got["text"].split()) == 8


def _patched_pipelines(monkeypatch, noise):
    """Both packages' ``generate_interleaved`` calls make their images from
    the same start latents, one draw per image."""
    calls = {"jax": 0, "port": 0}
    jreal, preal = jhead.sd_head_pipeline, phead.sd_head_pipeline

    def jpipe(*a, **kw):
        calls["jax"] += 1
        return jreal(*a, latents=jnp.asarray(noise[calls["jax"] - 1]), **kw)

    def ppipe(*a, **kw):
        calls["port"] += 1
        return preal(*a, latents=t(noise[calls["port"] - 1]), **kw)

    monkeypatch.setattr(jgen, "sd_head_pipeline", jpipe)
    monkeypatch.setattr(pgen, "sd_head_pipeline", ppipe)
    return calls


def test_chat_image_out_matches_jax(monkeypatch):
    """``head_params`` given: the turn runs ``generate_interleaved`` with the
    prompt image spliced in; a scripted trigger after 4 tokens makes one
    image (2 DPM steps). Text identical, the image within 1e-3."""
    jc, pc, jp, pp = dreamllm_params()
    jhc, phc, jhp, php = head_params()
    image = np.random.default_rng(12).random((32, 32, 3)).astype(np.float32)
    noise = np.random.default_rng(13).standard_normal((1, 1, 32, 32, 4)).astype(np.float32)
    calls = _patched_pipelines(monkeypatch, noise)
    common = dict(max_new_tokens=10, max_images=1, num_inference_steps=2, guidance_scale=3.5,
                  sampler="dpm", force_image_interval=4)
    sampling = dict(greedy=True, eos_token_id=-1, max_new_tokens=10)
    want = jchat.chat(jp, jc, jtok.ToyTokenizer(), _msgs(jtypes, DIALOGS[0]), [image],
                      sampling=jsamp.SamplingConfig(**sampling), head_params=jhp, head_cfg=jhc,
                      interleaved=jgen.InterleavedConfig(**common))
    margins = logit_margins(monkeypatch, pgen)
    got = pchat.chat(pp, pc, ptok.ToyTokenizer(), _msgs(ptypes, DIALOGS[0]), [image],
                     sampling=psamp.SamplingConfig(**sampling), head_params=php, head_cfg=phc,
                     interleaved=pgen.InterleavedConfig(**common), device="cpu")
    assert min(margins) > 10 * LOGIT_TOL, margins
    assert calls == {"jax": 1, "port": 1}
    assert got["text"] == want["text"] and len(got["text"].split("\n")) == 2
    assert len(got["images"]) == len(want["images"]) == 1
    assert tuple(got["images"][0].shape) == (64, 64, 3)
    np.testing.assert_allclose(n(got["images"][0]), np.asarray(want["images"][0]), atol=1e-3)


# ---------------------------------------------------------------------------
# make_chat_fn
# ---------------------------------------------------------------------------


def test_make_chat_fn_matches_jax(monkeypatch):
    """The same JSON requests through both packages' chat functions:
    message dicts, per-request greedy budgets and templates, the stop
    handling of each template; identical text."""
    jc, pc, jp, pp = dreamllm_params()
    jfn = jchat.make_chat_fn(jp, jc, jtok.ToyTokenizer(), max_new_tokens_limit=16)
    pfn = pchat.make_chat_fn(pp, pc, ptok.ToyTokenizer(), max_new_tokens_limit=16, device="cpu")
    image = np.random.default_rng(14).random((32, 32, 3)).astype(np.float32)
    margins = logit_margins(monkeypatch, psamp)
    for req in ({"max_new_tokens": 5}, {"max_new_tokens": 4, "template": "vicuna_v0"},
                {"max_new_tokens": 3, "template": "llama2", "seed": 3}):
        msgs = json.loads(json.dumps([{"role": "user", "content": "<image> what is this?"}]))
        want, got = jfn(msgs, [image], dict(req)), pfn(msgs, [image], dict(req))
        assert got == {"text": want["text"], "images": []}, req
    assert min(margins) > 10 * LOGIT_TOL, margins


def test_make_chat_fn_through_the_engine_matches_jax(monkeypatch):
    """``make_chat_fn(engine=)``: a text-only turn through the engine's
    token lanes and image turns through its embeddings lanes give the text
    of the locked path and of JAX's chat function; the function is marked
    concurrent and warms the engine (embeddings prefill included) before it
    starts; two turns at once each keep their own tokens."""
    import concurrent.futures as cf

    import dreamllm_tpu_torch.serve.engine as pengine

    jc, pc, jp, pp = dreamllm_params()
    eos = pc.special_tokens.eos
    eng = pengine.ContinuousBatchingEngine(
        pp["llm"], pc.llm, psamp.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=eos),
        pengine.EngineConfig(slots=2, prefill_len=32, max_len=128, chunk_steps=4), device="cpu")
    warmed = []
    real_warmup = eng.warmup
    monkeypatch.setattr(eng, "warmup", lambda embeds=False: warmed.append(embeds) or
                        real_warmup(embeds=embeds))
    efn = pchat.make_chat_fn(pp, pc, ptok.ToyTokenizer(), max_new_tokens_limit=16, engine=eng,
                             device="cpu")
    assert warmed == [True] and efn.concurrent
    pfn = pchat.make_chat_fn(pp, pc, ptok.ToyTokenizer(), max_new_tokens_limit=16, device="cpu")
    jfn = jchat.make_chat_fn(jp, jc, jtok.ToyTokenizer(), max_new_tokens_limit=16)
    assert not getattr(pfn, "concurrent", False)
    rng = np.random.default_rng(21)
    images = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(2)]
    turns = [([{"role": "user", "content": "hello there, who are you?"}], [],
              {"max_new_tokens": 6}),
             ([{"role": "user", "content": "<image> what is this?"}], images[:1],
              {"max_new_tokens": 5, "template": "vicuna_v0"}),
             ([{"role": "user", "content": "compare <image> with <image>"}], images,
              {"max_new_tokens": 7})]
    margins = [logit_margins(monkeypatch, psamp), logit_margins(monkeypatch, pengine)]
    want = [jfn(m, i, dict(r)) for m, i, r in turns]
    eng.start()
    try:
        got = [efn(m, i, dict(r)) for m, i, r in turns]
        with cf.ThreadPoolExecutor(2) as ex:
            both = [f.result(timeout=120) for f in
                    [ex.submit(efn, m, i, dict(r)) for m, i, r in turns[1:]]]
    finally:
        eng.stop()
    locked = [pfn(m, i, dict(r)) for m, i, r in turns]
    assert got == locked == [{"text": w["text"], "images": []} for w in want]
    assert both == got[1:]
    assert all(margins) and min(margins[0] + margins[1]) > 10 * LOGIT_TOL, margins


def test_make_chat_fn_rejects_bad_requests_and_the_engine():
    _, pc, _, pp = dreamllm_params()
    fn = pchat.make_chat_fn(pp, pc, ptok.ToyTokenizer(), max_new_tokens_limit=8, device="cpu")
    msgs = [{"role": "user", "content": "hi"}]
    for req, match in (({"max_new_tokens": 9}, "max_new_tokens"),
                       ({"template": "nope"}, "unknown template"),
                       ({"top_p": 0.0}, "top_p"), ({"temperature": float("nan")}, "temperature")):
        with pytest.raises(ClientError, match=match):
            fn(msgs, [], {"max_new_tokens": 4, **req})
    with pytest.raises(ValueError, match="text-out only"):
        pchat.make_chat_fn(pp, pc, ptok.ToyTokenizer(), engine=object(), head_params={},
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pchat.chat(pp, pc, ptok.ToyTokenizer(), _msgs(ptypes, DIALOGS[2]))
