"""The port's single-stream worker (``awq_tpu_torch/serve/worker.py``) over a
CPU engine against the JAX package's ``ModelWorker``, both over HTTP on
localhost: ``/worker_generate_stream`` gives the same chunk ids for an
``input_ids`` request (greedy, one round), a busy worker answers with the
busy chunk, and a failing request with the error chunk. A second round
through the port's worker continues the dialogue as
``InferenceEngine.generate`` does. Importing the new modules loads no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen
from awq_tpu_torch.serve.http import post_json, post_stream
from awq_tpu_torch.serve.worker import ModelWorker as TWorker

from test_torch_engine import _engines

torch.set_num_threads(1)


def _stream(worker, payload):
    return list(post_stream(worker.url + "/worker_generate_stream", payload, timeout=300))


@pytest.fixture(scope="module")
def workers():
    from awq_tpu.serve.worker import ModelWorker as JWorker

    jeng, teng = _engines(src_fused=False)
    jw, tw = JWorker(jeng, "tiny", port=0), TWorker(teng, "tiny", port=0)
    jw.start()
    tw.start()
    try:
        yield jw, tw
    finally:
        jw.stop()
        tw.stop()


def test_stream_ids_equal_jax_worker(workers):
    jw, tw = workers
    prompt = np.random.default_rng(5).integers(0, 512, 12).tolist()
    req = dict(input_ids=prompt, greedy=True, max_new_tokens=10, stream_interval=3)
    j, t = _stream(jw, req), _stream(tw, req)
    assert [c["error_code"] for c in t] == [0] * len(t)
    assert [(c["ids"], c["finished"]) for c in t] == [(c["ids"], c["finished"]) for c in j]
    assert t[-1]["text"] is None and len(t[-1]["ids"]) == 10
    assert set(t[-1]["timing"]) >= {"ttft_s", "token_times_s", "ms_per_token", "loop"}
    status = post_json(tw.url + "/worker_get_status", {})
    assert status["model_names"] == ["tiny"] and status["queue_length"] == 0


def test_dialogue_continues_as_generate(workers):
    """Two rounds through the port's worker (the second with
    ``continue_dialogue``) give the ids of two ``engine.generate`` rounds,
    whose first leaves its last id pending."""
    _, tw = workers
    _, ref = _engines(src_fused=False, jax_side=False)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, 8).tolist(), rng.integers(0, 512, 4).tolist()]
    for rnd, prompt in enumerate(prompts):
        req = dict(input_ids=prompt, greedy=True, max_new_tokens=7, stream_interval=2,
                   continue_dialogue=rnd > 0)
        got = _stream(tw, req)[-1]["ids"]
        want = ref.generate(prompt, TGen(greedy=True, max_new_tokens=7))["output_ids"]
        assert got == want.tolist()
        assert tw.engine.start_pos == ref.start_pos and tw.engine._pending == ref._pending


def test_busy_and_error_chunks(workers):
    jw, tw = workers
    for w in (jw, tw):
        assert w.sem.acquire(timeout=5)
        try:
            busy = _stream(w, dict(input_ids=[1, 2, 3], queue_timeout=0.05))
        finally:
            w.sem.release()
        assert busy == [{"error_code": 1, "text": "worker busy"}]
        # no tokenizer: a text prompt fails inside the stream, as an error chunk
        err = _stream(w, dict(prompt="hello", max_new_tokens=2))
        assert len(err) == 1 and err[0]["error_code"] == 2 and err[0]["text"]
        assert w.queue_length == 0


def test_worker_mesh_raises_naming_17b():
    from awq_tpu_torch.serve.worker import main

    with pytest.raises(NotImplementedError, match="17b"):
        main(["--load_quant", "unused", "--mesh", "1,2"])


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import awq_tpu_torch.runtime.prompts, awq_tpu_torch.utils.checkpoint\n"
        "import awq_tpu_torch.utils.load_quant, awq_tpu_torch.native\n"
        "import awq_tpu_torch.serve.worker, awq_tpu_torch.runtime.generate\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'awq_tpu' or m.startswith('awq_tpu.')\n"
        "       or m == 'awq_tpu_torch._build']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
