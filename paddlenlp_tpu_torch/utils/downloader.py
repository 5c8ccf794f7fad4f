"""Checkpoint and artifact resolution, local only.

Port of ``paddlenlp_tpu/utils/downloader.py:29-63``. A name resolves, in
order, to:

1. a local directory (or, for one file, a local file path);
2. the local framework cache, ``MODEL_HOME/<name>``.

The port never calls a hub: where the JAX package would try
``huggingface_hub`` last, a name found nowhere raises ``FileNotFoundError``
naming the paths searched, as the JAX one does once its hub attempt fails.
``get_path_from_url`` raises, because the port downloads nothing.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .env import MODEL_HOME

__all__ = ["resolve_file", "resolve_model_dir", "get_path_from_url"]


def _cache_dir(name: str) -> str:
    return os.path.join(MODEL_HOME, *name.split("/"))


def resolve_model_dir(pretrained_model_name_or_path: str, cache_dir: Optional[str] = None) -> str:
    """Return a local directory holding the artifacts for ``name``; raise if unresolvable."""
    name = str(pretrained_model_name_or_path)
    if os.path.isdir(name):
        return name
    local = cache_dir or _cache_dir(name)
    if os.path.isdir(local):
        return local
    raise FileNotFoundError(
        f"'{name}' is not a local directory and is not present in the cache ({local}). "
        "Download it with huggingface_hub or place files there manually."
    )


def resolve_file(
    pretrained_model_name_or_path: str, filename: str, cache_dir: Optional[str] = None, required: bool = True
) -> Optional[str]:
    """Resolve one artifact file (config.json, model.safetensors, ...) to a local path."""
    name = str(pretrained_model_name_or_path)
    if os.path.isfile(name):
        return name
    candidates: List[str] = []
    if os.path.isdir(name):
        candidates.append(os.path.join(name, filename))
    candidates.append(os.path.join(cache_dir or _cache_dir(name), filename))
    for c in candidates:
        if os.path.isfile(c):
            return c
    if required:
        raise FileNotFoundError(f"cannot resolve '{filename}' for '{name}' (searched {candidates})")
    return None


def get_path_from_url(url: str, root_dir: str) -> str:
    """The JAX package fetches ``url`` into ``root_dir``; the port downloads
    nothing, so a file already there is returned and anything else raises."""
    fname = os.path.join(root_dir, url.split("/")[-1])
    if os.path.isfile(fname):
        return fname
    raise FileNotFoundError(f"{fname} is not present and the port downloads nothing ({url}); "
                            "place the file there manually")
