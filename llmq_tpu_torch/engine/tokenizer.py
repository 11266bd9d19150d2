"""Tokenizer interface: HF tokenizers + a dependency-free byte fallback.

The reference got tokenization and chat-template application from vLLM's
``engine.get_tokenizer()`` (``vllm_worker.py:146,175-177``). Here the engine
owns the tokenizer directly: a thin protocol with two implementations —
HuggingFace ``AutoTokenizer`` for real checkpoints, and ``ByteTokenizer``
for tests/benchmarks with random-weight models (vocab 256, no downloads).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple


class Tokenizer(Protocol):
    eos_token_ids: Tuple[int, ...]

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def apply_chat_template(self, messages: List[Dict[str, str]]) -> List[int]: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens; id 0 is reserved as EOS.

    Bytes shift up by one (token = byte + 1) so EOS can't collide with a
    NUL byte; fits any model with vocab_size >= 257 (``ModelConfig.tiny``).
    """

    eos_token_ids: Tuple[int, ...] = (0,)

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 1 for i in ids if 0 < i <= 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[Dict[str, str]]) -> List[int]:
        text = "".join(
            f"{m.get('role', 'user')}: {m.get('content', '')}\n" for m in messages
        )
        return self.encode(text + "assistant: ")


class HFTokenizer:
    """Wraps ``transformers.AutoTokenizer`` (incl. the model's chat template)."""

    def __init__(self, model_path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_path)
        eos: List[int] = []
        if self._tok.eos_token_id is not None:
            eos.append(int(self._tok.eos_token_id))
        self.eos_token_ids = tuple(eos)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[Dict[str, str]]) -> List[int]:
        return list(self._tok.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True, return_dict=False
        ))

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        tid = self._tok.convert_tokens_to_ids(token)
        unk = getattr(self._tok, "unk_token_id", None)
        return None if tid is None or tid == unk else int(tid)
