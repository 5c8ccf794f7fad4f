"""Token streamers: a copy of ``paddlenlp_tpu/generation/streamers.py``
(``TextStreamer`` and ``TextIteratorStreamer``). ``put`` takes a numpy array
of ids: ``generate`` hands it the prompt, then each position's column. The
tokenizer is any object with ``decode(ids, **kwargs)``.
"""

from __future__ import annotations

from queue import Queue
from typing import Optional

__all__ = ["BaseStreamer", "TextStreamer", "TextIteratorStreamer"]


class BaseStreamer:
    def put(self, value):
        raise NotImplementedError

    def end(self):
        raise NotImplementedError


class TextStreamer(BaseStreamer):
    """Decode and print tokens as they arrive (word-boundary buffered)."""

    def __init__(self, tokenizer, skip_prompt: bool = False, **decode_kwargs):
        self.tokenizer = tokenizer
        self.skip_prompt = skip_prompt
        self.decode_kwargs = decode_kwargs
        self.token_cache = []
        self.print_len = 0
        self.next_tokens_are_prompt = True

    def put(self, value):
        import numpy as np

        value = np.asarray(value).reshape(-1)
        if self.skip_prompt and self.next_tokens_are_prompt:
            self.next_tokens_are_prompt = False
            return
        self.token_cache.extend(int(v) for v in value)
        text = self.tokenizer.decode(self.token_cache, **self.decode_kwargs)
        if text.endswith("\n"):
            printable = text[self.print_len :]
            self.token_cache = []
            self.print_len = 0
        elif len(text) > 0 and _ends_mid_char(text):
            printable = ""
        else:
            printable = text[self.print_len : text.rfind(" ") + 1] if " " in text[self.print_len :] else ""
            self.print_len += len(printable)
        if printable:
            self.on_finalized_text(printable)

    def end(self):
        if self.token_cache:
            text = self.tokenizer.decode(self.token_cache, **self.decode_kwargs)
            printable = text[self.print_len :]
        else:
            printable = ""
        self.token_cache = []
        self.print_len = 0
        self.next_tokens_are_prompt = True
        self.on_finalized_text(printable, stream_end=True)

    def on_finalized_text(self, text: str, stream_end: bool = False):
        print(text, flush=True, end="" if not stream_end else None)


def _ends_mid_char(text: str) -> bool:
    return text.endswith("�")


class TextIteratorStreamer(TextStreamer):
    """Streamer exposing an iterator interface (for serving)."""

    def __init__(self, tokenizer, skip_prompt: bool = False, timeout: Optional[float] = None, **decode_kwargs):
        super().__init__(tokenizer, skip_prompt, **decode_kwargs)
        self.queue: Queue = Queue()
        self.stop_signal = None
        self.timeout = timeout

    def on_finalized_text(self, text: str, stream_end: bool = False):
        if text:
            self.queue.put(text, timeout=self.timeout)
        if stream_end:
            self.queue.put(self.stop_signal, timeout=self.timeout)

    def __iter__(self):
        return self

    def __next__(self):
        value = self.queue.get(timeout=self.timeout)
        if value == self.stop_signal:
            raise StopIteration
        return value
