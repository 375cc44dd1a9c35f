"""Chat prompt templates (the port's own copy of ``awq_tpu/runtime/prompts.py``,
which the port does not import).

Counterpart of ``tinychat/utils/prompt_templates.py:28-399`` (BasePrompter
subclasses + get_prompter/get_stop_token_ids factories). Templates are
data, not classes; the prompter tracks the conversation and — key for
chunked prefill — can emit only the *delta* text added since the last
round, so the engine prefills just the new tokens on top of reused
history KV.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    system_fmt: str          # format(system=...)
    user_fmt: str            # format(msg=...)
    assistant_prefix: str    # generation primer
    assistant_suffix: str    # appended after model reply
    default_system: str = ""
    stop_strs: Tuple[str, ...] = ()


TEMPLATES: Dict[str, ChatTemplate] = {
    "llama2": ChatTemplate(
        system_fmt="[INST] <<SYS>>\n{system}\n<</SYS>>\n\n",
        user_fmt="{msg} [/INST]",
        assistant_prefix=" ",
        assistant_suffix=" </s><s>[INST] ",
        default_system=(
            "You are a helpful, respectful and honest assistant."
        ),
    ),
    "llama3": ChatTemplate(
        system_fmt=(
            "<|begin_of_text|><|start_header_id|>system<|end_header_id|>"
            "\n\n{system}<|eot_id|>"
        ),
        user_fmt=(
            "<|start_header_id|>user<|end_header_id|>\n\n{msg}<|eot_id|>"
        ),
        assistant_prefix="<|start_header_id|>assistant<|end_header_id|>\n\n",
        assistant_suffix="<|eot_id|>",
        default_system="You are a helpful assistant.",
        stop_strs=("<|eot_id|>",),
    ),
    "vicuna": ChatTemplate(
        system_fmt="{system} ",
        user_fmt="USER: {msg} ",
        assistant_prefix="ASSISTANT: ",
        assistant_suffix="</s>",
        default_system=(
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        ),
    ),
    "chatml": ChatTemplate(  # qwen/qwen2
        system_fmt="<|im_start|>system\n{system}<|im_end|>\n",
        user_fmt="<|im_start|>user\n{msg}<|im_end|>\n",
        assistant_prefix="<|im_start|>assistant\n",
        assistant_suffix="<|im_end|>\n",
        default_system="You are a helpful assistant.",
        stop_strs=("<|im_end|>",),
    ),
    "falcon": ChatTemplate(
        system_fmt="{system}",
        user_fmt="User: {msg}\n",
        assistant_prefix="Assistant:",
        assistant_suffix="\n",
    ),
    "mpt": ChatTemplate(
        system_fmt="<|im_start|>system\n{system}<|im_end|>\n",
        user_fmt="<|im_start|>user\n{msg}<|im_end|>\n",
        assistant_prefix="<|im_start|>assistant\n",
        assistant_suffix="<|im_end|>\n",
    ),
    "raw": ChatTemplate(
        system_fmt="{system}", user_fmt="{msg}",
        assistant_prefix="", assistant_suffix="",
    ),
    # ---- VLM conversations (``tinychat/serve/llava_conv.py`` +
    # ``tinychat/utils/prompt_templates.py:197-342``). Prompts carry
    # ``<image>`` / ``<vila/video>`` placeholders that the VLM tokenizers
    # turn into media sentinels (models/vlm.py::tokenizer_image_token).
    "llava": ChatTemplate(  # LlavaLlamaPrompter (:226)
        system_fmt="{system}",
        user_fmt=" USER: {msg}",
        assistant_prefix=" ASSISTANT: ",
        assistant_suffix="</s>",
        default_system=(
            "A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."
        ),
    ),
    "llava-llama3": ChatTemplate(  # LlavaLlama3Prompter (:237)
        system_fmt=(
            "<|begin_of_text|><|start_header_id|>system<|end_header_id|>"
            "\n\n{system}<|eot_id|>"
        ),
        user_fmt=(
            "<|start_header_id|>user<|end_header_id|>\n\n{msg}<|eot_id|>"
        ),
        assistant_prefix="<|start_header_id|>assistant<|end_header_id|>\n\n",
        assistant_suffix="<|eot_id|>",
        default_system=(
            "You are a helpful language and vision assistant. You are able "
            "to understand the visual content that the user provides, and "
            "assist the user with a variety of tasks using natural language."
        ),
        stop_strs=("<|eot_id|>", "<|end_of_text|>"),
    ),
    "nvila": ChatTemplate(  # NVILAPrompter (:318) — chatml-decorated
        system_fmt="<|im_start|>system\n{system}<|im_end|>\n",
        user_fmt="<|im_start|>user\n{msg}<|im_end|>\n",
        assistant_prefix="<|im_start|>assistant\n",
        assistant_suffix="<|im_end|>\n",
        default_system="You are a helpful assistant",
        stop_strs=("<|im_end|>",),
    ),
    "internvl": ChatTemplate(  # InternVL3Prompter (:330)
        system_fmt="<|im_start|>system\n{system}<|im_end|>\n",
        user_fmt="<|im_start|>user\n{msg}<|im_end|>\n",
        assistant_prefix="<|im_start|>assistant\n",
        assistant_suffix="<|im_end|>\n",
        default_system=(
            "你是书生·万象，英文名是InternVL，是由上海人工智能实验室、清华大学及"
            "多家合作单位联合开发的多模态大语言模型。你可以理解用户提供的视觉内容，"
            "并使用自然语言帮助用户完成各种任务。"
        ),
        stop_strs=("<|im_end|>",),
    ),
}


class Prompter:
    """Conversation state with whole/delta rendering."""

    def __init__(self, template: str, system: Optional[str] = None):
        self.t = TEMPLATES[template]
        self.name = template
        self.system = self.t.default_system if system is None else system
        self._text = self.t.system_fmt.format(system=self.system)
        self._consumed = 0  # chars already prefillled (delta mode)

    def insert_prompt(self, msg: str) -> None:
        self._text += self.t.user_fmt.format(msg=msg) + self.t.assistant_prefix

    def update_template(self, reply: str) -> None:
        """Record the model's reply (reference BasePrompter.update_template)."""
        self._text += reply + self.t.assistant_suffix

    @property
    def full_prompt(self) -> str:
        return self._text

    def delta_prompt(self) -> str:
        """Text added since the last call — tokenize this for chunked
        prefill on top of reused history KV."""
        d = self._text[self._consumed:]
        self._consumed = len(self._text)
        return d

    def reset(self) -> None:
        self._text = self.t.system_fmt.format(system=self.system)
        self._consumed = 0


def get_prompter(model_type: str, model_path: str = "", system=None) -> Prompter:
    """Pick a template from model family/path (counterpart of
    ``get_prompter``, ``prompt_templates.py:343-399``)."""
    p = (model_path or model_type).lower()
    if "nvila" in p:
        return Prompter("nvila", system)
    if "internvl" in p:
        return Prompter("internvl", system)
    if ("llava" in p or "vila" in p) and ("llama-3" in p or "llama3" in p):
        return Prompter("llava-llama3", system)
    if "llava" in p or "vila" in p:
        return Prompter("llava", system)
    if "llama-3" in p or "llama3" in p:
        return Prompter("llama3", system)
    if "vicuna" in p:
        return Prompter("vicuna", system)
    if "qwen" in p or "deepseek" in p:
        return Prompter("chatml", system)
    if "mpt" in p:
        return Prompter("mpt", system)
    if "falcon" in p:
        return Prompter("falcon", system)
    if "llama" in p or "codellama" in p:
        return Prompter("llama2", system)
    return Prompter("raw", system)


def get_stop_token_ids(model_type: str, tokenizer=None) -> List[int]:
    p = model_type.lower()
    ids: List[int] = []
    if tokenizer is not None and tokenizer.eos_token_id is not None:
        ids.append(int(tokenizer.eos_token_id))
    if tokenizer is not None:
        for s in TEMPLATES.get(
            "nvila" if ("nvila" in p or "internvl" in p)
            else "llava-llama3" if (("llava" in p or "vila" in p)
                                    and ("llama-3" in p or "llama3" in p))
            else "llama3" if "llama-3" in p or "llama3" in p
            else "chatml" if "qwen" in p else "raw"
        ).stop_strs:
            try:
                tid = tokenizer.convert_tokens_to_ids(s)
                if tid is not None and tid >= 0:
                    ids.append(int(tid))
            except Exception:
                pass
    return sorted(set(ids))
