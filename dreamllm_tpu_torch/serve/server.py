"""Model-serving shim and its HTTP client (port of
``dreamllm_tpu/serve/server.py``; stdlib ``http.server``, one JSON
contract):

    POST /generate  {"prompt": str, "max_new_tokens": int, ...} -> {"text": str}
                    (with "stream": true on an engine: server-sent events)
    POST /logprob   {"context": str, "continuations": [str]}    -> {"logprobs": [...]}
    POST /chat      {"messages": [{"role","content"}], "images": [b64], ...}
                                         -> {"text": str, "images": [b64 PNG]}
    GET  /health                                                -> {"ok": true}

``chat_fn=`` (``generation.chat.make_chat_fn``) serves multimodal chat:
images ride the JSON body base64-encoded, ``<image>`` placeholders in the
messages mark their places, and a model with its SD head may answer with
images.

The server owns one model. /generate runs in one of three modes, by
construction argument:

  * ``engine=``: continuous batching (``serve/engine.py``): requests join
    per-slot KV lanes mid-decode;
  * ``generate_batch_fn=``: window micro-batching (``serve/batching.py``):
    requests arriving within a window run as one fixed-shape decode;
  * ``generate_fn=``: one request at a time under a lock.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from dreamllm_tpu_torch.generation.sampler import validate_sampling
from dreamllm_tpu_torch.serve.batching import DynamicBatcher
from dreamllm_tpu_torch.utils.errors import ClientError
from dreamllm_tpu_torch.utils.image import base64_to_image, image_to_base64
from dreamllm_tpu_torch.utils.logging import get_logger, warning_once

logger = get_logger("dreamllm_tpu_torch.serve")


class ModelServer:
    def __init__(
        self,
        generate_fn: Callable[[str, dict], str] | None = None,
        logprob_fn: Callable[[str, list[str]], list[float]] | None = None,
        host: str = "127.0.0.1",
        port: int = 8300,
        *,
        generate_batch_fn: Callable[[list[str]], list[str]] | None = None,
        max_batch: int = 8,
        batch_window_ms: float = 10.0,
        engine=None,               # ContinuousBatchingEngine (serve/engine.py)
        tokenizer=None,            # required with engine=
        chat_fn: Callable[[list, list, dict], dict] | None = None,
    ):
        self.generate_fn = generate_fn
        self.logprob_fn = logprob_fn
        self._chat_fn = chat_fn
        self.host, self.port = host, port
        self._lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._batcher = None
        self._engine = engine
        self._tokenizer = tokenizer
        if engine is not None and tokenizer is None:
            raise ValueError("engine= requires tokenizer=")
        if generate_batch_fn is not None:
            self._batcher = DynamicBatcher(
                generate_batch_fn, max_batch=max_batch, window_ms=batch_window_ms
            )

    def _engine_prepare(self, prompt: str, req: dict):
        """→ (prompt_ids, submit kwargs). Validates client sampling params
        up front (raises ClientError) so the streaming path can reject a bad
        request with a clean 400 BEFORE any SSE bytes go out."""
        tok = self._tokenizer
        ids = tok.encode(prompt)
        # this repo's tokenizer adapters expose .special.bos (HFTokenizer /
        # ToyTokenizer), raw HF tokenizers expose .bos_token_id — check both
        # before the LLaMA default of 1
        sp = getattr(tok, "special", None)
        bos = getattr(sp, "bos", None) if sp is not None else None
        if bos is None:
            bos = getattr(tok, "bos_token_id", 1)
        if bos is not None and (not ids or ids[0] != bos):
            ids = [bos] + list(ids)
        kw = {"max_new_tokens": int(req.get("max_new_tokens", 128))}
        # per-request sampling rides the engine's per-row sampler — lanes
        # with different settings share one decode
        if "greedy" in req:
            kw["greedy"] = bool(req["greedy"])
        if "temperature" in req:
            kw["temperature"] = float(req["temperature"])
        if "top_k" in req:
            kw["top_k"] = int(req["top_k"])
        if "top_p" in req:
            kw["top_p"] = float(req["top_p"])
        if "seed" in req:
            kw["seed"] = int(req["seed"])  # reproducible sampling stream
        validate_sampling(kw.get("temperature", 1.0), kw.get("top_k", 0),
                          kw.get("top_p", 1.0))
        return ids, kw

    def _engine_generate(self, prompt: str, req: dict) -> str:
        ids, kw = self._engine_prepare(prompt, req)
        out = self._engine.submit(ids, **kw)
        return self._tokenizer.decode(out).strip()

    def _engine_generate_stream(self, ids: list[int], kw: dict, write_event) -> None:
        """Drive one engine request, emitting SSE events as tokens land.

        The engine's stream callback fires on the SCHEDULER thread — writing
        to the socket there would stall every lane on one slow client, so
        tokens hop through a queue and THIS handler thread does the socket
        writes. Events: {"delta": text} per decoded increment, then
        {"done": true, "text": full} (or {"error": msg}).

        Incremental detokenization is NOT prefix-stable in general: byte-
        level BPE decodes a half-emitted multi-byte character to U+FFFD,
        and the next token rewrites it. Deltas are therefore held back
        while the decode ends in U+FFFD (or the prefix shifted), and any
        residue flushes before the final done event — streamed deltas
        always assemble to the authoritative text."""
        tok = self._tokenizer
        q: queue.Queue = queue.Queue()
        result: dict = {}

        def run():
            try:
                result["tokens"] = self._engine.submit(ids, stream=q.put, **kw)
            except Exception as e:  # surfaced as an SSE error event below
                result["error"] = e
            finally:
                q.put(None)

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        toks: list[int] = []
        sent = ""
        alive = True  # client still connected; a failed write stops
        # emission but the loop keeps draining so the worker can finish
        # (in-flight engine requests have no cancel)
        while True:
            item = q.get()
            if item is None:
                break
            toks.append(int(item))
            if not alive:
                continue  # drain silently — no decode work for a dead client
            full = tok.decode(toks)
            if full.endswith("�") or not full.startswith(sent):
                continue  # incomplete multi-byte char; wait for more tokens
            delta = full[len(sent):]
            if delta:
                try:
                    write_event({"delta": delta})
                    sent = full
                except OSError:
                    alive = False
        worker.join()
        if not alive:
            return
        try:
            if "error" in result:
                write_event({"error": str(result["error"])})
                return
            full = tok.decode(result["tokens"])
            if full.startswith(sent) and len(full) > len(sent):
                write_event({"delta": full[len(sent):]})  # flush residue
            write_event({"done": True, "text": full.strip()})
        except OSError:
            pass  # client left between the last delta and the final event

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": "not found"})

            def _sse(self, prompt: str, req: dict):
                """Server-sent-events streaming for the engine path.
                Sampling params are validated BEFORE headers go out so a bad
                request still gets a JSON 400; once headers are sent, any
                failure becomes an SSE error event — never a second HTTP
                status line injected into the stream."""
                try:
                    ids, kw = server._engine_prepare(prompt, req)
                except ClientError as e:
                    self._send(400, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

                def write_event(payload: dict):
                    self.wfile.write(
                        b"data: " + json.dumps(payload).encode() + b"\n\n")
                    self.wfile.flush()

                try:
                    server._engine_generate_stream(ids, kw, write_event)
                except Exception as e:
                    logger.exception("stream failed")
                    try:
                        write_event({"error": str(e)})
                    except OSError:
                        pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    if self.path == "/generate" and server._engine is not None:
                        # continuous batching: the engine schedules lanes
                        # itself; handler threads block on their own request
                        if req.get("stream"):
                            self._sse(req.pop("prompt", ""), req)
                            return
                        text = server._engine_generate(req.pop("prompt", ""), req)
                        self._send(200, {"text": text})
                        return
                    if self.path == "/generate" and server._batcher is not None:
                        # micro-batched path: no lock — the batcher serializes
                        # model access itself and merges concurrent requests
                        prompt = req.pop("prompt", "")
                        if req:  # fixed batch shape: per-request knobs
                            # (max_new_tokens, temperature, ...) can't vary
                            warning_once(
                                "batched /generate ignores per-request fields "
                                f"{sorted(req)} — the batch shape and sampling "
                                "config are fixed at server construction"
                            )
                        text = server._batcher.submit(prompt)
                        self._send(200, {"text": text})
                        return
                    if self.path == "/chat" and server._chat_fn is not None:
                        msgs = req.pop("messages", [])
                        imgs = [base64_to_image(s) for s in req.pop("images", [])]
                        if getattr(server._chat_fn, "concurrent", False):
                            # engine-routed chat batches its own requests
                            out = server._chat_fn(msgs, imgs, req)
                        else:
                            with server._lock:  # model is a single resource
                                out = server._chat_fn(msgs, imgs, req)
                        self._send(200, {
                            "text": out["text"],
                            "images": [image_to_base64(a)
                                       for a in out.get("images", [])],
                        })
                        return
                    with server._lock:  # model is a single resource
                        if self.path == "/generate" and server.generate_fn:
                            text = server.generate_fn(req.pop("prompt", ""), req)
                            self._send(200, {"text": text})
                        elif self.path == "/logprob" and server.logprob_fn:
                            lps = server.logprob_fn(
                                req.get("context", ""), req.get("continuations", [])
                            )
                            self._send(200, {"logprobs": [float(x) for x in lps]})
                        else:
                            self._send(404, {"error": "not found"})
                except ClientError as e:
                    # invalid client input (out-of-range sampling params,
                    # unknown template, placeholder mismatch) — 400, no
                    # server-side stack trace needed
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    # everything else — including a plain ValueError from a
                    # model-side shape bug — is a server fault: log it
                    logger.exception("request failed")
                    self._send(500, {"error": str(e)})

        return Handler

    def start(self, background: bool = True):
        if self._batcher is not None:
            self._batcher.start()
        if self._engine is not None:
            self._engine.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
            logger.info("serving on %s:%d", self.host, self.port)
        else:
            self._httpd.serve_forever()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()  # shutdown() alone leaks the listen fd
            self._httpd = None
        if self._batcher is not None:
            self._batcher.stop()
        if self._engine is not None:
            self._engine.stop()


class OnlineClient:
    """HTTP client for a ModelServer. ``timeout``: seconds each call may
    wait for its answer (``/health``: at most 5)."""

    def __init__(self, base_url: str, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def generate(self, prompt: str, **kw) -> str:
        return self._post("/generate", {"prompt": prompt, **kw})["text"]

    def generate_stream(self, prompt: str, **kw):
        """Yield text deltas as the engine decodes (SSE). The final event
        carries the complete text; iterate, or ``"".join(...)`` for the
        assembled stream. Requires an engine-backed server."""
        req = urllib.request.Request(
            self.base_url + "/generate",
            data=json.dumps({"prompt": prompt, "stream": True, **kw}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            for raw in r:
                line = raw.strip()
                if not line.startswith(b"data: "):
                    continue
                event = json.loads(line[len(b"data: "):])
                if "error" in event:
                    raise RuntimeError(event["error"])
                if event.get("done"):
                    return
                yield event["delta"]

    def chat(self, messages: list, images: list = (), **kw) -> dict:
        """Multimodal chat turn. ``messages``: [{"role","content"}] with
        ``<image>`` placeholders; ``images``: HWC arrays (base64-encoded on
        the wire) or pre-encoded base64 strings. Returns {"text", "images"}
        with any generated images decoded back to uint8 HWC arrays."""
        payload_images = [
            img if isinstance(img, str) else image_to_base64(img)
            for img in images
        ]
        out = self._post("/chat", {"messages": list(messages),
                                   "images": payload_images, **kw})
        out["images"] = [base64_to_image(s) for s in out.get("images", [])]
        return out

    def logprob(self, context: str, continuations: list[str]) -> list[float]:
        return self._post("/logprob", {"context": context, "continuations": continuations})[
            "logprobs"
        ]

    def healthy(self) -> bool:
        try:
            with urllib.request.urlopen(self.base_url + "/health",
                                        timeout=min(5.0, self.timeout)) as r:
                return json.loads(r.read()).get("ok", False)
        except Exception:
            return False
