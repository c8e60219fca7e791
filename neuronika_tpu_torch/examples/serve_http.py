"""A minimal HTTP text-generation server on the continuous batcher (twin
of the JAX package's `examples/serve_http.py`).

    POST /generate  {"prompt": "...", "max_new": 32, "temperature": 0.8,
                     "top_k": 40, "top_p": 0.95, "seed": 1, "adapter": 0}
                    -> {"text": "..."}
    GET  /stats     -> {"running": n, "queued": n, "free_slots": n}

Sampling keys are optional (greedy by default); `adapter` selects a LoRA
adapter registered on the batcher (0 = the base model). One background
thread drives `ContinuousBatcher.step()`; handlers only enqueue requests
and wait for their completion, so concurrent clients share decode steps.
Standard library only (`http.server`, `threading`) and the port's
`BpeTokenizer`; the model is pre-trained for a few steps on a toy corpus.

    python -m neuronika_tpu_torch.examples.serve_http
    curl -s localhost:8777/generate -d '{"prompt": "the sun", "max_new": 16}'
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from neuronika_tpu_torch.config import config
from neuronika_tpu_torch.data import BpeTokenizer, lm_windows
from neuronika_tpu_torch.device import resolve
from neuronika_tpu_torch.models import transformer as T
from neuronika_tpu_torch.serving import ContinuousBatcher

PORT = 8777
CORPUS = (
    "the sun rose over the quiet valley and the river kept moving. "
    "a traveler walked the long road toward the distant town. "
) * 50


class Engine:
    """Batcher, stepping thread and per-request completion events."""

    def __init__(self, device=None, train_steps: int = 30, seed: int = 0):
        dev = resolve(config.device if device is None else device)
        self.tok = BpeTokenizer.train([CORPUS], vocab_size=384)
        cfg = T.GPTConfig(vocab_size=self.tok.vocab_size, n_layer=2,
                          n_head=4, d_model=128, d_ff=256, max_seq=128,
                          dtype=torch.float32)
        params = T.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                               dev)
        # a quick pre-train, so that generations echo the corpus
        toks, tgts = lm_windows(np.array(self.tok.encode(CORPUS)), 64)
        step = T.make_train_step(cfg)
        opt = T.adam_init(params)
        lr = torch.tensor(3e-3)
        self.losses = []
        for _ in range(train_steps):
            params, opt, loss = step(params, opt,
                                     torch.from_numpy(toks[:16]).to(dev),
                                     torch.from_numpy(tgts[:16]).to(dev), lr)
            self.losses.append(float(loss))
        self.cb = ContinuousBatcher(params, cfg, n_slots=8, device=dev)
        self.lock = threading.Lock()
        self.events: dict[int, threading.Event] = {}
        self.results: dict[int, np.ndarray] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def _drive(self):
        while not self._stop.is_set():
            with self.lock:
                running, queued, _ = self.cb.stats
                busy = bool(running or queued)
                if busy:
                    # per-token steps keep finish detection (and response
                    # latency) tight; a throughput deployment would drive
                    # step_many(k) and batch bursts under defer_admission()
                    self.cb.step()
                    for rid, toks in list(self.cb._finished.items()):
                        ev = self.events.get(rid)
                        if ev is not None and not ev.is_set():
                            self.results[rid] = self.cb._finished.pop(rid)
                            ev.set()
            if not busy:
                time.sleep(0.005)

    def generate(self, prompt: str, max_new: int, **sampling) -> str:
        ids = self.tok.encode(prompt) or [0]
        ev = threading.Event()
        with self.lock:
            rid = self.cb.submit(ids, max_new=max_new, **sampling)
            self.events[rid] = ev
        ev.wait(timeout=120)
        with self.lock:
            out = self.results.pop(rid, np.zeros(0, np.int32))
            self.events.pop(rid, None)
        return self.tok.decode(np.asarray(out).tolist())

    def stats(self):
        with self.lock:
            running, queued, free = self.cb.stats
        return {"running": running, "queued": queued, "free_slots": free}

    def close(self):
        """Stop the stepping thread."""
        self._stop.set()
        self._thread.join(timeout=10)


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._json(200, engine.stats())
            self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                sampling = {}
                for k, cast in (("temperature", float), ("top_k", int),
                                ("top_p", float), ("min_p", float),
                                ("seed", int), ("adapter", int)):
                    if k in req:
                        sampling[k] = cast(req[k])
                text = engine.generate(str(req.get("prompt", "")),
                                       int(req.get("max_new", 32)),
                                       **sampling)
                self._json(200, {"text": text})
            except Exception as e:  # a demo server: report, don't die
                self._json(500, {"error": str(e)})

        def log_message(self, *a):
            pass

    return Handler


def main(device=None, port: int = PORT):
    engine = Engine(device)
    srv = ThreadingHTTPServer(("127.0.0.1", port), make_handler(engine))
    print(f"serving on http://127.0.0.1:{port}  (POST /generate, "
          f"GET /stats)")
    try:
        srv.serve_forever()
    finally:
        engine.close()


if __name__ == "__main__":
    main()
