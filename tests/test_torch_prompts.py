"""The port's chat templates (``awq_tpu_torch/runtime/prompts.py``, its own
copy) equal the JAX package's: every template, the prompter routing of the
model names ``tests/test_generate.py`` uses, the prompts a dialogue builds
(full and delta) and the stop ids a tokenizer gives."""

import dataclasses

import pytest
import torch

from awq_tpu.runtime import prompts as jp
from awq_tpu_torch.runtime import prompts as tp

torch.set_num_threads(1)

# (model_type, model_path) as tests/test_generate.py:102-126 route them
ROUTES = [("llama", "llama-3-8b"), ("llama", "llava-v1.5-7b"), ("llama", "VILA-7b"),
          ("llama", "llava-llama-3-8b"), ("nvila", "NVILA-8B"),
          ("internvl3", "InternVL3-8B"), ("llama", "vicuna-7b"), ("llama", "llama-2-7b"),
          ("mistral", "mistral-7b"), ("qwen2", "qwen2-7b"), ("falcon", "falcon-7b")]


def test_templates_equal():
    assert sorted(tp.TEMPLATES) == sorted(jp.TEMPLATES)
    for name, t in tp.TEMPLATES.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(jp.TEMPLATES[name]), name


@pytest.mark.parametrize("model_type,path", ROUTES)
def test_prompter_dialogue_equal(model_type, path):
    """Routing, then two rounds: the full and delta prompts after each."""
    a, b = jp.get_prompter(model_type, path), tp.get_prompter(model_type, path)
    assert a.name == b.name
    for msg, reply in (("hi <image>\nwhat is this?", "hello!"), ("bye", "see you")):
        a.insert_prompt(msg)
        b.insert_prompt(msg)
        assert b.delta_prompt() == a.delta_prompt()
        assert b.full_prompt == a.full_prompt
        a.update_template(reply)
        b.update_template(reply)
    assert b.full_prompt == a.full_prompt


class _Tok:
    """A tokenizer's two calls that ``get_stop_token_ids`` makes."""

    eos_token_id = 2

    def convert_tokens_to_ids(self, s):
        return -1 if s.startswith("</") else 1000 + len(s)


@pytest.mark.parametrize("model_type,path", ROUTES)
def test_stop_ids_equal(model_type, path):
    for tok in (None, _Tok()):
        assert tp.get_stop_token_ids(path, tok) == jp.get_stop_token_ids(path, tok)
        assert tp.get_stop_token_ids(model_type, tok) == jp.get_stop_token_ids(model_type, tok)
