"""Batched model worker: concurrent requests share one BatchEngine
(PyTorch port of ``awq_tpu/serve/batch_worker.py``).

A scheduler thread drives ``BatchEngine.step()`` continuously and N HTTP
streams are fed from per-request token queues: requests join and leave the
batch mid-flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

from awq_tpu_torch.config import GenConfig
from awq_tpu_torch.runtime.batch_engine import BatchEngine
from awq_tpu_torch.serve.http import JsonHTTPServer, post_json

_DONE = object()


class BatchWorker:
    def __init__(
        self,
        engine: BatchEngine,
        tokenizer,
        model_name: str,
        controller_url: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        stop_ids: Optional[List[int]] = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.controller_url = controller_url
        self.stop_ids = list(stop_ids or [])
        self._queues: Dict[int, queue.Queue] = {}
        self._signaled: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()

        self.server = JsonHTTPServer(host, port)
        self.server.route("/worker_generate_stream", self.generate_stream)
        self.server.route("/worker_get_status", self.get_status)

    @property
    def url(self) -> str:
        return f"http://{self.server.host}:{self.server.port}"

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        self._thread = threading.Thread(target=self._schedule, daemon=True)
        self._thread.start()
        if self.controller_url:
            post_json(self.controller_url + "/register_worker", {
                "worker_name": self.url,
                "model_names": [self.model_name],
                "queue_length": 0,
            })

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self.server.stop()

    # ---- scheduler thread --------------------------------------------------

    def _schedule(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                busy = bool(self.engine.waiting) or self.engine.n_active > 0
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            with self._lock:
                out = self.engine.step()
                finished = {rid for rid in self.engine.finished
                            if rid in self._queues
                            and rid not in self._signaled}
                self._signaled.update(finished)
            for rid, tok in out.items():
                q = self._queues.get(rid)
                if q is not None:
                    # a speculative step (spec_k) emits a list of accepted
                    # ids a rid: one put a token, in order
                    for t in (tok if isinstance(tok, list) else [tok]):
                        q.put(t)
            for rid in finished:
                q = self._queues.get(rid)
                if q is not None:
                    q.put(_DONE)

    # ---- endpoints ---------------------------------------------------------

    def get_status(self, p: dict) -> dict:
        with self._lock:
            return {
                "model_names": [self.model_name],
                "queue_length": len(self.engine.waiting),
                "active": self.engine.n_active,
                "slots": self.engine.n_slots,
            }

    def generate_stream(self, p: dict) -> Iterator[dict]:
        if "input_ids" in p:
            ids = list(map(int, p["input_ids"]))
        else:
            ids = self.tokenizer.encode(p["prompt"])
        gen = GenConfig(
            temperature=float(p.get("temperature", 0.7)),
            top_p=float(p.get("top_p", 0.9)),
            top_k=int(p.get("top_k", 40)),
            max_new_tokens=int(p.get("max_new_tokens", 256)),
            greedy=bool(p.get("greedy", False)),
        )
        q: queue.Queue = queue.Queue()
        with self._lock:
            rid = self.engine.submit(
                ids, gen, stop_ids=p.get("stop_token_ids", self.stop_ids)
            )
            self._queues[rid] = q
        self._wake.set()
        out_ids: List[int] = []
        interval = int(p.get("stream_interval", 2))
        t0 = time.time()
        try:
            while True:
                item = q.get(timeout=float(p.get("timeout", 300)))
                if item is _DONE:
                    break
                out_ids.append(item)
                if len(out_ids) % interval == 0:
                    yield {"error_code": 0, "finished": False,
                           "ids": list(out_ids),
                           "text": self.tokenizer.decode(out_ids)}
            with self._lock:
                req = self.engine.finished.get(rid)
            final_ids = req.out_ids if req else out_ids
            yield {"error_code": 0, "finished": True,
                   "ids": list(final_ids),
                   "text": self.tokenizer.decode(final_ids),
                   "timing": {"total_s": time.time() - t0,
                              "new_tokens": len(final_ids)}}
        except queue.Empty:
            yield {"error_code": 2, "text": "generation timeout"}
        finally:
            with self._lock:
                self._queues.pop(rid, None)
                self._signaled.discard(rid)
