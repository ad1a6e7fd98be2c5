"""Online serving (the port of mobilequant_tpu/runtime/server.py): the
continuous batcher made live, and a stdlib HTTP front end over it.

Threading: all device work runs on one worker thread that owns the
ContinuousBatcher (the batcher is not thread-safe, and one device queue
serialises the work anyway). Producers put (prompt, options, handle) into an
inbox under a lock; before each tick the worker drains the inbox into the
batcher, runs `ContinuousBatcher.step()`, and completes the handles of
retired requests. With nothing to do the worker waits on a condition
variable, which a submit wakes.

HTTP (ThreadingHTTPServer):
  POST /generate  {"prompt_ids": [int, ...], "max_new_tokens": int}
                  -> {"completion_ids": [...]}
  POST /generate  {"prompt": str, ...} -> {"completion": str} (needs a
                  tokenizer: any object with encode(text, prefix=[...]) and
                  decode(ids), and piece_to_id for chat templates)
  optional sampling fields on /generate: "temperature", "top_p", "top_k",
  "greedy" (temperature 0 means greedy); requests with different settings
  share ticks.
  GET  /health   -> {"ok": true}
  GET  /stats    -> the batcher's counters
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from mobilequant_tpu_torch.runtime.chat import apply_chat_template_ids
from mobilequant_tpu_torch.runtime.sampling import SamplerConfig


class _Pending:
    __slots__ = ("prompt", "max_new_tokens", "sampler", "event", "result", "error")

    def __init__(self, prompt, max_new_tokens, sampler=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.sampler = sampler       # Optional[SamplerConfig], per request
        self.event = threading.Event()
        self.result: Optional[list] = None
        self.error: Optional[str] = None


class InferenceServer:
    """Owns a ContinuousBatcher and its worker thread; submit() is
    thread-safe."""

    def __init__(self, batcher):
        self.cb = batcher
        self._inbox: list = []
        self._by_rid: dict = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._started = False

    def start(self) -> "InferenceServer":
        if not self._started:
            self._started = True
            self._worker.start()
        return self

    def close(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify()
        if self._started:
            self._worker.join(timeout=30)

    def submit(self, prompt_ids, max_new_tokens: int = 128, sampler=None) -> _Pending:
        """-> a handle whose .event fires when .result (or .error) is set.
        sampler: an optional per-request SamplerConfig."""
        p = _Pending(np.asarray(prompt_ids, np.int32), max_new_tokens, sampler)
        with self._wake:
            self._inbox.append(p)
            self._wake.notify()
        return p

    def generate(self, prompt_ids, max_new_tokens: int = 128,
                 timeout: Optional[float] = None, sampler=None) -> list:
        p = self.submit(prompt_ids, max_new_tokens, sampler=sampler)
        if not p.event.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if p.error is not None:
            raise ValueError(p.error)
        return p.result

    def _fail_all(self, err: str) -> None:
        """A failed tick: fail every request in flight and every queued one,
        on a fresh cache (a failed call may have left it half written)."""
        cb = self.cb
        cb.cache = cb._mod.init_kv_cache(cb.ecfg, cb.B, device=cb.device)
        for slot in list(cb.active):
            cb._retire(slot)
        reqs = [cb.done.pop(rid) for rid in list(cb.done)] + list(cb.queue)
        cb.queue.clear()
        for req in reqs:
            p = self._by_rid.pop(req.rid, None)
            if p is not None and p.result is None:
                p.error = err
                p.event.set()

    def _loop(self) -> None:
        while True:
            with self._wake:
                while not (self._inbox or self.cb.queue or self.cb.active or self._stop):
                    self._wake.wait()
                if self._stop and not (self._inbox or self.cb.queue or self.cb.active):
                    return
                inbox, self._inbox = self._inbox, []
            for p in inbox:
                # a prompt the batcher refuses fails its own request, not the loop
                try:
                    rid = self.cb.submit(p.prompt, p.max_new_tokens, sampler=p.sampler)
                except ValueError as e:
                    p.error = str(e)
                    p.event.set()
                    continue
                self._by_rid[rid] = p
            try:
                self.cb.step()
            except Exception as e:                       # noqa: BLE001
                # one bad tick fails the requests in flight, and the loop
                # goes on taking new ones
                self._fail_all(f"scheduler tick failed: {e!r}")
                continue
            for rid in list(self.cb.done):
                req = self.cb.done.pop(rid)
                p = self._by_rid.pop(rid, None)
                if p is not None:
                    p.result = list(req.out)
                    p.event.set()


def _sampler_of(req: dict) -> Optional[SamplerConfig]:
    if not any(f in req for f in ("temperature", "top_p", "top_k", "greedy")):
        return None
    temp = float(req.get("temperature", 1.0))
    return SamplerConfig(temperature=temp, top_p=float(req.get("top_p", 1.0)),
                         top_k=int(req.get("top_k", 0)),
                         greedy=bool(req.get("greedy", temp == 0.0)))


def make_http_server(server: InferenceServer, tokenizer=None, host: str = "127.0.0.1",
                     port: int = 8000, bos_id: int = -1, eos_id: int = -1,
                     chat_family: Optional[str] = None,
                     default_max_new_tokens: int = 128) -> ThreadingHTTPServer:
    """A stdlib HTTP front end over an InferenceServer (port 0: an ephemeral
    port, read back from .server_address). Without a tokenizer only
    `prompt_ids` requests are taken."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):       # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._send(200, {"ok": True})
            if self.path == "/stats":
                return self._send(200, dict(server.cb.stats) | {
                    "active": len(server.cb.active), "queued": len(server.cb.queue),
                    "host_syncs": server.cb.host_syncs})
            return self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                mnt = int(req.get("max_new_tokens", default_max_new_tokens))
                sampler = _sampler_of(req)
                if "prompt_ids" in req:
                    ids = [int(t) for t in req["prompt_ids"]]
                elif "prompt" not in req:
                    return self._send(400, {"error": "need prompt or prompt_ids"})
                elif tokenizer is None:
                    return self._send(400, {"error": "no tokenizer loaded; send prompt_ids"})
                elif chat_family:
                    ids = apply_chat_template_ids(
                        tokenizer.encode(req["prompt"]), chat_family, tokenizer.encode,
                        getattr(tokenizer, "piece_to_id", lambda _: -1))
                    ids = ([bos_id] if bos_id >= 0 else []) + ids
                else:
                    ids = tokenizer.encode(req["prompt"],
                                           prefix=[bos_id] if bos_id >= 0 else [])
            except (ValueError, TypeError, KeyError) as e:      # malformed input
                return self._send(400, {"error": f"bad request: {e!r}"})
            try:
                out = server.generate(ids, mnt, sampler=sampler)
            except ValueError as e:                      # a rejected request
                return self._send(400, {"error": str(e)})
            except Exception as e:                       # noqa: BLE001
                return self._send(500, {"error": repr(e)})
            if "prompt_ids" in req:
                return self._send(200, {"completion_ids": out})
            if eos_id >= 0 and eos_id in out:
                out = out[:out.index(eos_id)]
            return self._send(200, {"completion": tokenizer.decode(out)})

    return ThreadingHTTPServer((host, port), Handler)
