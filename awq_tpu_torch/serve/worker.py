"""Model worker: owns one engine, streams generations, heartbeats
(PyTorch port of ``awq_tpu/serve/worker.py``).

Counterpart of ``tinychat/serve/model_worker_new.py:86-396``: register with
the controller, heartbeat every 15 s, semaphore-limited
``/worker_generate_stream`` emitting NUL-delimited JSON chunks, and
``/worker_get_status``. Errors during generation surface as an error chunk
(the reference catches ``torch.cuda.CudaError`` similarly,
``model_worker_new.py:338-367``).

A round streams through ``InferenceEngine.stream`` (on a card, replays of
the engine's captured decode step) and continues the
dialogue as ``InferenceEngine.generate`` does: an id that a round returned
but never fed is fed first in the next round. Without a tokenizer
(``transformers`` is not installed, or ``--model_path`` names none) the
worker serves ``input_ids`` requests and returns ``text: null``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Iterator, List, Optional

from awq_tpu_torch.config import GenConfig
from awq_tpu_torch.serve.http import JsonHTTPServer, post_json

HEART_BEAT_INTERVAL = 15.0  # constants.py:24-26


class ModelWorker:
    def __init__(
        self,
        engine,                      # awq_tpu_torch.runtime.engine.InferenceEngine
        model_name: str,
        controller_url: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        limit_concurrency: int = 1,
        stop_ids: Optional[List[int]] = None,
    ):
        self.engine = engine
        self.model_name = model_name
        self.controller_url = controller_url
        self.worker_id = uuid.uuid4().hex[:8]
        self.sem = threading.Semaphore(limit_concurrency)
        self.queue_length = 0
        self.stop_ids = list(stop_ids or [])
        self._hb_stop = threading.Event()

        self.server = JsonHTTPServer(host, port)
        self.server.route("/worker_generate_stream", self.generate_stream)
        self.server.route("/worker_generate", self.generate)
        self.server.route("/worker_get_status", self.get_status)

    @property
    def url(self) -> str:
        return f"http://{self.server.host}:{self.server.port}"

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        if self.controller_url:
            self.register()
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()

    def stop(self) -> None:
        self._hb_stop.set()
        self.server.stop()

    def register(self) -> None:
        post_json(self.controller_url + "/register_worker", {
            "worker_name": self.url,
            "model_names": [self.model_name],
            "speed": 1.0,
            "queue_length": self.queue_length,
        })

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(HEART_BEAT_INTERVAL):
            try:
                ok = post_json(self.controller_url + "/receive_heart_beat", {
                    "worker_name": self.url,
                    "queue_length": self.queue_length,
                })
                if not ok.get("exist"):
                    self.register()  # controller restarted (worker re-adds)
            except Exception:
                pass  # controller down; keep serving, retry next beat

    # ---- endpoints --------------------------------------------------------

    def get_status(self, p: dict) -> dict:
        return {
            "model_names": [self.model_name],
            "speed": 1.0,
            "queue_length": self.queue_length,
            "worker_id": self.worker_id,
        }

    def _gen_config(self, p: dict) -> GenConfig:
        return GenConfig(
            temperature=float(p.get("temperature", 0.7)),
            top_p=float(p.get("top_p", 0.9)),
            top_k=int(p.get("top_k", 40)),
            repetition_penalty=float(p.get("repetition_penalty", 1.0)),
            max_new_tokens=int(p.get("max_new_tokens", 256)),
            greedy=bool(p.get("greedy", False)),
        )

    def generate_stream(self, p: dict) -> Iterator[dict]:
        self.queue_length += 1
        acquired = self.sem.acquire(timeout=float(p.get("queue_timeout", 120)))
        try:
            if not acquired:
                yield {"error_code": 1, "text": "worker busy"}
                return
            tok = self.engine.tokenizer
            if "input_ids" in p:
                ids = list(map(int, p["input_ids"]))
            elif tok is None:
                raise ValueError("this worker has no tokenizer: send input_ids")
            else:
                ids = tok.encode(p["prompt"])
            if not p.get("continue_dialogue"):
                self.engine.reset()
            gen = self._gen_config(p)
            ids = self.engine.round_ids(ids, gen.max_new_tokens)
            stream = self.engine.stream(
                gen, stop_ids=p.get("stop_token_ids", self.stop_ids),
                stream_interval=int(p.get("stream_interval", 2)),
            )
            for chunk in stream(ids, start_pos=self.engine.start_pos):
                out = {"error_code": 0, "text": chunk.get("text"),
                       "ids": chunk["ids"], "finished": chunk["finished"]}
                if chunk["finished"]:
                    out["timing"] = chunk["timing"]
                    # the cache is the engine's, written in place
                    self.engine.start_pos = chunk["new_start_pos"]
                    self.engine._pending = chunk["pending"]
                yield out
        except Exception as e:
            yield {"error_code": 2, "text": f"{type(e).__name__}: {e}"}
        finally:
            if acquired:
                self.sem.release()
            self.queue_length -= 1

    def generate(self, p: dict) -> dict:
        """Non-streaming convenience endpoint."""
        last = {}
        for chunk in self.generate_stream(p):
            last = chunk
        return last


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("awq_tpu_torch.serve.worker")
    ap.add_argument("--load_quant", required=True,
                    help="a checkpoint's path (<path>.safetensors and <path>.json)")
    ap.add_argument("--model_path", default=None,
                    help="tokenizer source (needs transformers; without it the worker "
                         "serves input_ids)")
    ap.add_argument("--model_name", default=None)
    ap.add_argument("--controller", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--max_seq_len", type=int, default=2048)
    ap.add_argument("--limit_concurrency", type=int, default=1)
    ap.add_argument("--q_head", action="store_true",
                    help="W4-quantize the fp16 lm_head (decode's head GEMV "
                         "then rides the megakernel; slight logit change)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="'dp,tp' (or 'tp'): tensor-parallel serving, not in the "
                         "port's worker yet (ROADMAP queue A, item 17b)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prefill_w8", action="store_true",
                    help="TTFT mode: int8 prefill weight cache (pure int8 "
                         "MXU prefill dots; ~1 extra HBM byte per weight)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("the worker over a tensor-parallel group (--mesh) is "
                                  "ROADMAP queue A, item 17b")

    from awq_tpu_torch.config import RuntimeConfig
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from awq_tpu_torch.runtime.prompts import get_stop_token_ids
    from awq_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg, _ = load_checkpoint(args.load_quant, device=args.device)
    tok = None
    if args.model_path:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.model_path, use_fast=True,
                                            trust_remote_code=True)
    # InferenceEngine fuses (and optionally head-quantizes) on construction
    engine = InferenceEngine(
        cfg, params,
        RuntimeConfig(max_seq_len=args.max_seq_len, quantize_head=args.q_head,
                      prefill_w8=args.prefill_w8),
        device=args.device, tokenizer=tok,
    )
    engine.warmup()
    w = ModelWorker(
        engine, args.model_name or cfg.arch, args.controller,
        args.host, args.port, args.limit_concurrency,
        stop_ids=get_stop_token_ids(args.model_path or cfg.arch, tok),
    )
    w.start()
    print(f"[worker] {w.url} serving '{w.model_name}'", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        w.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
