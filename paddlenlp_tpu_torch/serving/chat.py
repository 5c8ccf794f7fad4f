"""Chat-completions surface: conversation → token-id rendering.

The ``/v1/chat/completions`` endpoint (api.py) is a thin shape adapter over
the existing completion pipeline — what makes multi-turn chat *cheap* is the
hierarchical prefix cache underneath it, and that only works if rendering is
**prefix-stable**: turn N+1's rendered prompt must begin with turn N's
rendered prompt followed byte-for-byte by turn N's completion ids. The
:class:`ChatTemplate` here guarantees that by construction:

- every message renders as ``[role_marker] + content_ids + [sep]``;
- the render ends with a bare ``[assistant_marker]`` (the generation prompt);
- the model's completion then streams exactly where the next turn's history
  will replay it: turn N's ``... [assistant] <completion> [sep] ...`` starts
  with turn N's prompt (``... [assistant]``) + its sampled ids.

Because the engine registers a finished request's prompt AND generated
blocks in the prefix cache (and the host tier keeps them across HBM
pressure), turn N+1 re-prefills only its new user message — the
``cached_tokens`` usage field covers turn N's prompt and completion.

Assistant-message ``content`` SHOULD be the token ids the server streamed
(the ``token_ids`` field of the previous response): re-encoding decoded text
is not guaranteed to reproduce the sampled ids, which silently downgrades
the cache hit to the longest re-tokenized match. Both list-of-ints and
string content are accepted; strings go through the server's tokenizer.

The default marker ids are small reserved ids (1..4) — tokenizer-less
deployments (token-id payloads, the test/bench configuration) must keep
real content clear of them, and tokenizer deployments should construct the
template from their special-token ids instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

__all__ = ["ChatTemplate", "ROLES"]

#: accepted ``role`` values, in the only order a well-formed conversation
#: can interleave them (system first if present, then user/assistant turns)
ROLES = ("system", "user", "assistant")


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    """Prefix-stable chat rendering (see module docstring for the invariant
    the prefix cache depends on). Marker defaults are reserved low ids so the
    tokenizer-less test configuration (vocab 96) can use them directly."""

    system_token_id: int = 1
    user_token_id: int = 2
    assistant_token_id: int = 3
    sep_token_id: int = 4

    def role_token(self, role: str) -> int:
        if role == "system":
            return self.system_token_id
        if role == "user":
            return self.user_token_id
        if role == "assistant":
            return self.assistant_token_id
        raise ValueError(f"message role must be one of {'/'.join(ROLES)}, got {role!r}")

    def render(self, messages: Sequence[dict],
               encode: Callable[[str], List[int]]) -> List[int]:
        """Render a conversation to prompt token ids ending in the assistant
        generation marker. ``encode`` maps string content to ids (the
        server's tokenizer path); list content passes through as ids."""
        if not isinstance(messages, (list, tuple)) or not messages:
            raise ValueError("messages must be a non-empty list of "
                             "{'role', 'content'} objects")
        ids: List[int] = []
        for i, msg in enumerate(messages):
            if not isinstance(msg, dict):
                raise ValueError(f"messages[{i}] must be an object, got {type(msg).__name__}")
            role = str(msg.get("role", ""))
            marker = self.role_token(role)
            if role == "system" and i != 0:
                raise ValueError("a system message is only valid as messages[0]")
            content = msg.get("content")
            if isinstance(content, str):
                content_ids = [int(t) for t in encode(content)]
            elif isinstance(content, (list, tuple)):
                content_ids = [int(t) for t in content]
            else:
                raise ValueError(
                    f"messages[{i}].content must be a string or a token-id "
                    f"list, got {type(content).__name__}")
            if not content_ids:
                raise ValueError(f"messages[{i}].content is empty")
            ids.append(marker)
            ids.extend(content_ids)
            ids.append(self.sep_token_id)
        if messages[-1].get("role") == "assistant":
            raise ValueError("the last message must not be from the assistant "
                             "(nothing to generate)")
        ids.append(self.assistant_token_id)  # the generation prompt
        return ids
