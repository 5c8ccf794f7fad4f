"""Unified checkpoint, reader half: the commit manifest check.

Part of ``paddlenlp_tpu/trainer/unified_checkpoint.py``. A committed
checkpoint directory holds a ``commit.json`` manifest (file list, sizes and
sha256 per file) written last, after every payload file, and renamed into
place with its directory: a directory without a valid manifest is torn or
uncommitted. :func:`validate_checkpoint` is what ``POST /admin/weights``
gates a live weight swap on. The writer half (save at ``save_steps``, resume,
rotation) is ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from ..utils.log import logger

__all__ = ["COMMIT_MANIFEST", "validate_checkpoint"]

COMMIT_MANIFEST = "commit.json"


def _sha256_file(path: str, chunk_bytes: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def validate_checkpoint(ckpt_dir: str, verify_hashes: bool = True) -> Optional[str]:
    """None when ``ckpt_dir`` holds a committed, consistent checkpoint;
    otherwise a human-readable reason it must not be trusted.

    Size validation always runs (cheap; catches truncation). Content-hash
    validation runs when the manifest carries ``sha256`` entries and
    ``verify_hashes`` is true (full re-read; catches bit rot). Manifests
    written before the hash field (version 1) still validate — with a warning
    that integrity is size-only."""
    manifest_path = os.path.join(ckpt_dir, COMMIT_MANIFEST)
    if not os.path.isfile(manifest_path):
        return f"no {COMMIT_MANIFEST} (save never committed)"
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        return f"unreadable {COMMIT_MANIFEST}: {e}"
    hashes = manifest.get("sha256") or {}
    if verify_hashes and not hashes:
        # only worth saying when the caller ASKED for hash validation —
        # is_committed() (rotation, per dir per save) explicitly opts out
        logger.warning(
            f"checkpoint {ckpt_dir}: manifest has no content hashes (written by a "
            "pre-hash trainer); validating sizes only — truncation is caught, bit rot is not")
    for rel, size in manifest.get("files", {}).items():
        p = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(p):
            return f"manifest file missing: {rel}"
        actual = os.path.getsize(p)
        if actual != size:
            return f"size mismatch for {rel}: manifest {size}, on disk {actual}"
        if verify_hashes and rel in hashes:
            digest = _sha256_file(p)
            if digest != hashes[rel]:
                return (f"content hash mismatch for {rel}: manifest sha256 "
                        f"{hashes[rel][:12]}…, on disk {digest[:12]}… (bit rot?)")
    return None


def is_committed(ckpt_dir: str) -> bool:
    """Commit-status check (manifest present + sizes match). Skips the full
    content-hash re-read: rotation calls this per dir on every save, and
    bit-rot detection belongs to the load/resume path, not the reaper."""
    return os.path.isdir(ckpt_dir) and validate_checkpoint(ckpt_dir, verify_hashes=False) is None
