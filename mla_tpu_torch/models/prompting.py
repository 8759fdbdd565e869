"""Prompt builders for each LLM family.

Counterpart of mla_tpu/models/prompting.py, the port's own copy: the
multi-turn builders that give each backbone family its exact
training-time string format. The VLA path uses PurePromptBuilder ("In:
{msg}\nOut: " turns); the VLM finetune stage (vla/vlm_datasets.py) builds
its dialogs through `get_prompt_builder(model_family)`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Type


class PromptBuilder(ABC):
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        self.model_family = model_family
        self.system_prompt = system_prompt

    @abstractmethod
    def add_turn(self, role: str, message: str) -> str: ...

    @abstractmethod
    def get_potential_prompt(self, user_msg: str) -> str: ...

    @abstractmethod
    def get_prompt(self) -> str: ...


class PurePromptBuilder(PromptBuilder):
    """Llama-2 'pure' (non-chat) format: In:/Out: turns, </s> after gpt."""

    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(model_family, system_prompt)
        self.bos, self.eos = "<s>", "</s>"
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        wrapped = f"In: {message}\nOut: " if self.turn_count % 2 == 0 else f"{message}{self.eos}"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        return (self.prompt + f"In: {message}\nOut: ").removeprefix(self.bos).rstrip()

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.bos).rstrip()


class LLaMa2ChatPromptBuilder(PromptBuilder):
    """[INST] chat format with the <<SYS> system block (reference
    llama2_chat_prompter.py). Byte-level parity notes: the opening tag is
    the reference's literal '<<SYS>' (single closing '>', a typo preserved
    in its training data); the default prismatic system prompt is
    substituted when none is given; turns carry NO per-turn '<s>' (the
    tokenizer auto-inserts BOS once)."""

    SYS = "<<SYS>\n{}\n<</SYS>>\n\n"
    DEFAULT_SYSTEM = (
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    )

    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(model_family, system_prompt)
        self.bos, self.eos = "<s>", "</s>"
        self.system = self.SYS.format((system_prompt or self.DEFAULT_SYSTEM).strip())
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count % 2 == 0:
            sys_block = self.system if self.turn_count == 0 else ""
            wrapped = f"[INST] {sys_block}{message} [/INST] "
        else:
            # reference wrap_gpt: empty assistant turns become ' '
            wrapped = f"{message if message != '' else ' '}{self.eos}"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        sys_block = self.system if self.turn_count == 0 else ""
        return (self.prompt + f"[INST] {sys_block}{message.strip()} [/INST] ").removeprefix(self.bos).rstrip()

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.bos).rstrip()


class VicunaV15PromptBuilder(PromptBuilder):
    """Vicuna v1.5: SYSTEM + 'USER: ... ASSISTANT:' turns."""

    DEFAULT_SYSTEM = (
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    )

    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(model_family, system_prompt)
        self.bos, self.eos = "<s>", "</s>"
        self.system = (system_prompt or self.DEFAULT_SYSTEM).strip() + " "
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count % 2 == 0:
            prefix = self.system if self.turn_count == 0 else ""
            wrapped = f"{prefix}USER: {message} ASSISTANT: "
        else:
            # reference wrap_gpt: empty assistant turns become ' '
            wrapped = f"{message if message != '' else ' '}{self.eos}"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        prefix = self.system if self.turn_count == 0 else ""
        return (self.prompt + f"{prefix}USER: {message.strip()} ASSISTANT: ").removeprefix(self.bos).rstrip()

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.bos).rstrip()


class MistralInstructPromptBuilder(PromptBuilder):
    """Mistral-instruct [INST] format (no system block)."""

    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(model_family, system_prompt)
        self.bos, self.eos = "<s>", "</s>"
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        wrapped = (
            f"[INST] {message} [/INST] "
            if self.turn_count % 2 == 0
            # reference wrap_gpt: empty assistant turns become ' '
            else f"{message if message != '' else ' '}{self.eos}"
        )
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        return (self.prompt + f"[INST] {message.strip()} [/INST] ").removeprefix(self.bos).rstrip()

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.bos).rstrip()


class PhiPromptBuilder(PromptBuilder):
    """Phi-2 format: 'Input: ...\nOutput: ' with <|endoftext|> separators."""

    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(model_family, system_prompt)
        self.bos = self.eos = "<|endoftext|>"
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count % 2 == 0:
            # the CodeGen tokenizer does NOT auto-insert BOS — the reference
            # prepends it to the FIRST human turn explicitly (phi_prompter.py)
            bos = self.bos if self.turn_count == 0 else ""
            wrapped = f"{bos}Input: {message}\nOutput: "
        else:
            # reference wrap_gpt: empty assistant turns become ' '
            wrapped = f"{message if message != '' else ' '}\n{self.eos}"
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        return (self.prompt + f"Input: {message.strip()}\nOutput: ").rstrip()

    def get_prompt(self) -> str:
        return self.prompt.rstrip()


PROMPT_BUILDERS: dict[str, Type[PromptBuilder]] = {
    "llama2-pure": PurePromptBuilder,
    "llama2-chat": LLaMa2ChatPromptBuilder,
    "vicuna-v15": VicunaV15PromptBuilder,
    "mistral-instruct": MistralInstructPromptBuilder,
    "phi-2": PhiPromptBuilder,
    "openvla": PurePromptBuilder,
}


def get_prompt_builder(family: str, system_prompt: Optional[str] = None) -> PromptBuilder:
    return PROMPT_BUILDERS[family](family, system_prompt)
