"""The port's HTTP serving stack on the CPU (``dreamllm_tpu_torch/serve/
server.py``, ``serve/batching.py``): ``ModelServer`` and ``OnlineClient``
with a locked function, a ``DynamicBatcher`` and an engine behind
``/generate``, server-sent-event streaming, ``/logprob`` and ``/chat``;
``make_batched_generate_fn`` against ``generate_text`` and JAX's tokens.
Every server binds 127.0.0.1 on a free port; every HTTP call and every
thread join has its own timeout, so a fault fails a test instead of
hanging the run."""

from __future__ import annotations

import concurrent.futures as cf
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import dreamllm_tpu_torch.data.tokenization as ptok
import dreamllm_tpu_torch.generation.sampler as psamp
import dreamllm_tpu_torch.serve.batching as batching
from dreamllm_tpu_torch.eval.nlp import choice_logprobs
from dreamllm_tpu_torch.serve import (
    ContinuousBatchingEngine,
    EngineConfig,
    ModelServer,
    OnlineClient,
)
from dreamllm_tpu_torch.serve.batching import DynamicBatcher, make_batched_generate_fn
from tests._torch_serve_helpers import jax_generate, serve_params

T = 60  # seconds: every HTTP call and thread join


def _client(server):
    return OnlineClient(f"http://127.0.0.1:{server.port}", timeout=T)


class _ByteTokenizer:
    """One token per character (bounded to the vocabulary)."""

    bos_token_id = 1

    def encode(self, text):
        return [2 + (ord(c) % 100) for c in text]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


# float32 weights: an int4 generate_text would take the kernel's function
# (input rounded to bf16) on a prompt of at most 8 tokens, where the engine's
# 16-row prefill takes the dequantize product
def _engine(**kw):
    _, pc, _, pp = serve_params(512, "plain")
    scfg = psamp.SamplingConfig(greedy=True, max_new_tokens=0, eos_token_id=-1, pad_token_id=0)
    ecfg = EngineConfig(slots=2, prefill_len=16, max_len=64, chunk_steps=4, **kw)
    return ContinuousBatchingEngine(pp, pc, scfg, ecfg, device="cpu")


def _ref(ids, max_new):
    _, pc, _, pp = serve_params(512, "plain")
    out = psamp.generate_text(pp, pc, torch.tensor([ids]), torch.tensor([len(ids)]),
                              psamp.SamplingConfig(greedy=True, max_new_tokens=max_new,
                                                   eos_token_id=-1), device="cpu")
    return out["tokens"][0, :int(out["lengths"][0])].tolist()


def _post(server, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=T)


# ---------------------------------------------------------------------------
# The server with plain functions (JAX: tests/test_lora_serve.py TestServe)
# ---------------------------------------------------------------------------


def test_generate_and_logprob_roundtrip():
    server = ModelServer(lambda prompt, kw: prompt.upper() + "!" * kw.get("max_new_tokens", 1),
                         lambda context, conts: [-float(len(c)) for c in conts], port=0).start()
    try:
        client = _client(server)
        assert client.healthy()
        assert client.generate("hi", max_new_tokens=3) == "HI!!!"
        assert client.logprob("c", ["a", "bbb"]) == [-1.0, -3.0]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/nothing", {})
        assert e.value.code == 404
    finally:
        server.stop()
    assert not _client(server).healthy()  # the socket is closed


def test_micro_batching_merges_concurrent_requests():
    calls = []

    def batch_gen(prompts):
        calls.append(len(prompts))
        return [p.upper() for p in prompts]

    server = ModelServer(generate_batch_fn=batch_gen, max_batch=4, batch_window_ms=150,
                         port=0).start()
    try:
        client = _client(server)
        with cf.ThreadPoolExecutor(6) as ex:
            results = list(ex.map(lambda i: client.generate(f"req{i}"), range(6), timeout=T))
        assert results == [f"REQ{i}" for i in range(6)]
        assert sum(calls) == 6 and len(calls) < 6 and max(calls) >= 2
    finally:
        server.stop()


def test_batched_generate_fn_fixed_shapes_match_generate_text_and_jax(monkeypatch):
    """Fixed-shape batches of ``batch_size`` rows through ``generate_text``:
    a short batch pads with dummy rows, a long prompt is left-truncated with
    BOS kept, and the texts decode JAX's tokens on the same rows; a window
    of five prompts through a batch-2 function is cut into three calls."""
    jc, pc, jp, pp = serve_params(512, "plain")
    tok = ptok.ToyTokenizer(vocab_size=512)
    fn = make_batched_generate_fn(pp, pc, tok, batch_size=3, max_prompt_len=16, max_new_tokens=4,
                                  eos_token_id=-1, bos_token_id=1, device="cpu")
    prompts = ["hello world", "bye", "a much longer prompt of many words that must lose its "
               "head to fit the sixteen token window"]
    got = fn(prompts[:2])
    rows = [[1] + tok.encode(p) for p in prompts]
    rows[2] = [1] + rows[2][-15:]  # left-truncated, BOS kept
    lens = np.asarray([len(r) for r in rows], np.int32)
    ids = np.zeros((3, 16), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    want = jax_generate(jc, jp, ids, lens, max_new_tokens=4, eos_token_id=-1)["tokens"]
    assert got == [tok.decode(want[i].tolist()).strip() for i in range(2)]
    assert fn(prompts) == [tok.decode(want[i].tolist()).strip() for i in range(3)]
    calls = []
    fn2 = make_batched_generate_fn(pp, pc, tok, batch_size=2, max_prompt_len=16,
                                   max_new_tokens=2, eos_token_id=-1, device="cpu")
    real = batching.generate_text

    def spy(params, cfg, input_ids, *a, **k):
        calls.append(tuple(input_ids.shape))
        return real(params, cfg, input_ids, *a, **k)

    monkeypatch.setattr(batching, "generate_text", spy)
    assert len(fn2([f"p {i}" for i in range(5)])) == 5
    assert calls == [(2, 16)] * 3


def test_batcher_error_propagates_to_all_waiters():
    gate = threading.Event()

    def bad(items):
        gate.wait(T)
        raise ValueError(f"kaput {len(items)}")

    b = DynamicBatcher(bad, max_batch=4, window_ms=200).start()
    try:
        with cf.ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(b.submit, i, timeout=T) for i in range(3)]
            gate.set()
            errs = [f.exception(timeout=T) for f in futs]
        assert all(isinstance(e, ValueError) and "kaput" in str(e) for e in errs)
    finally:
        b.stop(join_timeout=T)
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit("late", timeout=T)


def test_error_handling():
    def gen(prompt, kw):
        raise RuntimeError("boom")

    server = ModelServer(gen, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/generate", {"prompt": "x"})
        assert e.value.code == 500 and "boom" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/generate",
                                         data=b"{not json", method="POST")
            urllib.request.urlopen(req, timeout=T)
        assert e.value.code == 400
    finally:
        server.stop()


def test_chat_endpoint_roundtrips_images():
    seen = {}

    def chat_fn(messages, images, req):
        seen.update(messages=messages, images=images, req=req)
        return {"text": "ok", "images": [torch.ones((4, 4, 3)) * 0.5]}

    server = ModelServer(chat_fn=chat_fn, port=0).start()
    try:
        img = (np.random.default_rng(0).random((8, 8, 3)) * 255).astype(np.uint8)
        out = _client(server).chat([{"role": "user", "content": "see <image>"}], images=[img],
                                   max_new_tokens=4)
        assert out["text"] == "ok" and out["images"][0].shape == (4, 4, 3)
        assert int(out["images"][0][0, 0, 0]) == 127
        np.testing.assert_array_equal(seen["images"][0], img)  # PNG is lossless
        assert seen["req"] == {"max_new_tokens": 4}
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Engine-backed /generate (JAX: tests/test_engine.py)
# ---------------------------------------------------------------------------


def test_engine_backed_http_server():
    tok = _ByteTokenizer()
    server = ModelServer(engine=_engine(), tokenizer=tok, port=0).start()
    try:
        client = _client(server)
        assert client.healthy()
        assert client.generate("hi", max_new_tokens=6) == tok.decode(
            _ref([1] + tok.encode("hi"), 6)).strip()
        prompts = ["a", "bb", "ccc", "dddd"]
        with cf.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda p: client.generate(p, max_new_tokens=5), prompts,
                               timeout=T))
        assert outs == [tok.decode(_ref([1] + tok.encode(p), 5)).strip() for p in prompts]
        assert isinstance(client.generate("hi", max_new_tokens=5, temperature=1.2, top_k=6), str)
    finally:
        server.stop()


def test_engine_http_sse_streaming():
    """``stream=true`` yields deltas that assemble to the greedy text; bad
    sampling values are a JSON 400 before any event; two streams at once
    keep their own tokens."""
    tok = _ByteTokenizer()
    server = ModelServer(engine=_engine(), tokenizer=tok, port=0).start()
    try:
        client = _client(server)
        deltas = list(client.generate_stream("hello", max_new_tokens=8))
        assert len(deltas) > 1
        assert "".join(deltas) == tok.decode(_ref([1] + tok.encode("hello"), 8))
        with pytest.raises(urllib.error.HTTPError) as e:
            list(client.generate_stream("x", max_new_tokens=4, top_p=0.0))
        assert e.value.code == 400
        with cf.ThreadPoolExecutor(2) as ex:
            futs = {p: ex.submit(lambda p=p: "".join(client.generate_stream(p, max_new_tokens=6)))
                    for p in ("aa", "bbbb")}
            for p, fut in futs.items():
                assert fut.result(timeout=T) == tok.decode(_ref([1] + tok.encode(p), 6))
    finally:
        server.stop()


def test_engine_sse_holds_back_incomplete_chars():
    """A tokenizer that decodes token PAIRS to one character gives U+FFFD
    for a trailing odd token; the stream holds such deltas back and still
    assembles to the final text."""

    class PairTokenizer:
        bos_token_id = 1

        def encode(self, text):
            return [t for c in text for t in (2 + ord(c) % 50, 60 + ord(c) % 50)]

        def decode(self, ids):
            s = "".join(chr(97 + (ids[i] + ids[i + 1]) % 26) for i in range(0, len(ids) - 1, 2))
            return s + ("�" if len(ids) % 2 else "")

    server = ModelServer(engine=_engine(), tokenizer=PairTokenizer(), port=0).start()
    try:
        client = _client(server)
        deltas = list(client.generate_stream("hi", max_new_tokens=9))
        assert all("�" not in d for d in deltas[:-1])
        assert "".join(deltas).strip() == client.generate("hi", max_new_tokens=9)
    finally:
        server.stop()


def test_engine_server_with_prefix_cache_logprob_and_chat():
    """The server as ``projects/dreamllm/serve.py`` builds it: an engine
    with the prefix cache behind ``/generate``, ``choice_logprobs`` behind
    ``/logprob``; the engine's counters see the shared prefix."""
    _, pc, _, pp = serve_params(512, "plain")
    tok = ptok.ToyTokenizer(vocab_size=512)
    eng = _engine(prefix_cache_entries=2).warmup()
    server = ModelServer(engine=eng, tokenizer=tok, port=0,
                         logprob_fn=lambda ctx, conts: choice_logprobs(pp, pc, tok, ctx,
                                                                       list(conts))).start()
    try:
        client = _client(server)
        system = " ".join(f"w{i}" for i in range(20))  # 21 tokens with BOS: one full chunk
        texts = [client.generate(f"{system} q{i}", max_new_tokens=4) for i in range(3)]
        assert texts == [tok.decode(_ref([1] + tok.encode(f"{system} q{i}"), 4)).strip()
                         for i in range(3)]
        assert (eng.prefix_misses, eng.prefix_hits) == (1, 2)
        lps = client.logprob("the answer is", [" yes", " no"])
        assert len(lps) == 2 and all(np.isfinite(lps))
        np.testing.assert_allclose(lps, choice_logprobs(pp, pc, tok, "the answer is",
                                                        [" yes", " no"]), rtol=1e-6)
    finally:
        server.stop()
