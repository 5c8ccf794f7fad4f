"""Unified checkpoint: safetensors save and resume with an atomic commit protocol.

Port of ``paddlenlp_tpu/trainer/unified_checkpoint.py``, in the JAX package's
file layout byte for byte, so a checkpoint written by either package resumes
in the other:

- the model under HF keys through ``model.save_pretrained`` (parameters in
  ``jax.tree_util``'s sorted-path order);
- the optimizer in ``optimizer.safetensors`` (sharded with an index past 5 GB,
  as ``shard_checkpoint`` does) under the optax chain's leaf paths
  (``AdamW.state_dict``) plus ``__step__``;
- ``trainer_state.json``.

**Commit protocol.** A crash mid-save must never leave a directory that
resume will mistake for a checkpoint. Every save writes into a
``<ckpt_dir>.tmp`` staging directory, fsyncs the payload, writes a
``commit.json`` manifest (file list, sizes, sha256, step) and only then
``os.replace``'s the staging dir into place: rename is the commit point. The
observable states are: no dir, a ``*.tmp`` staging dir (ignored by the
``checkpoint-<step>`` regex), or a fully committed dir. ``load`` validates the
manifest; :func:`get_last_committed_checkpoint` is the resume auto-discovery
that skips torn dirs; :func:`rotate_checkpoints` never deletes an uncommitted
dir or the newest committed one (the resume fallback). :func:`validate_checkpoint`
is also what ``POST /admin/weights`` gates a live weight swap on.

``async_save`` copies the state to host memory first, then hands the write to
a non-daemon writer thread; a writer's exception surfaces at
:func:`join_pending_saves`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

import torch

from ..transformers.conversion_utils import flatten_params, unflatten_params
from ..utils.faults import FaultPoint
from ..utils.fileio import atomic_write, fsync_dir, fsync_file
from ..utils.log import logger
from ..utils.safetensors_io import SafeFile, save_file, shard_checkpoint
from .trainer_utils import _re_checkpoint

__all__ = [
    "save_unified_checkpoint",
    "load_unified_checkpoint",
    "validate_checkpoint",
    "is_committed",
    "get_last_committed_checkpoint",
    "get_last_legacy_checkpoint",
    "rotate_checkpoints",
    "join_pending_saves",
    "wait_for_pending_saves",
    "CorruptCheckpointError",
    "COMMIT_MANIFEST",
]

OPTIMIZER_NAME = "optimizer.safetensors"
TRAINER_STATE_NAME = "trainer_state.json"
COMMIT_MANIFEST = "commit.json"
STAGING_SUFFIX = ".tmp"

_F_WRITE_SHARD = FaultPoint("ckpt.write_shard")
_F_COMMIT = FaultPoint("ckpt.commit")

_pending_saves: List[threading.Thread] = []
_pending_lock = threading.Lock()


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory failed commit-manifest validation (torn write)."""


def _flatten_opt_state(optimizer) -> Dict[str, torch.Tensor]:
    """The optimizer's leaves under the JAX optax chain's paths, plus the
    train step as ``__step__`` (int32 scalars, as the JAX trainer stores them)."""
    flat = dict(optimizer.state_dict())
    flat["__step__"] = torch.tensor(optimizer.count, dtype=torch.int32)
    return flat


# --------------------------------------------------------------------- commit
def _manifest_files(ckpt_dir: str) -> Dict[str, int]:
    """Relative path → size for every payload file under ``ckpt_dir``."""
    files: Dict[str, int] = {}
    for root, _dirs, names in os.walk(ckpt_dir):
        for name in names:
            if name == COMMIT_MANIFEST:
                continue
            p = os.path.join(root, name)
            files[os.path.relpath(p, ckpt_dir)] = os.path.getsize(p)
    return files


def _sha256_file(path: str, chunk_bytes: int = 8 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _sha256_files(root: str, rels: Iterable[str]) -> Dict[str, str]:
    """sha256 of each file, one thread a file (``hashlib`` releases the GIL
    while it hashes: a checkpoint's shards hash side by side)."""
    rels = list(rels)
    with ThreadPoolExecutor(max(1, min(len(rels), os.cpu_count() or 1))) as pool:
        return dict(zip(rels, pool.map(lambda rel: _sha256_file(os.path.join(root, rel)), rels)))


def _commit_checkpoint(staging: str, final: str, step: Optional[int]):
    """Manifest + fsync + rename: the all-or-nothing commit point.

    Everything before the ``os.replace`` can crash with zero effect on
    ``final``; everything after it is durable (parent dir fsync'd). The
    manifest carries per-file sha256 alongside sizes: sizes catch truncation,
    hashes catch bit rot / partial rsync that preserves length."""
    files = _manifest_files(staging)
    for rel in files:
        fsync_file(os.path.join(staging, rel))
    hashes = _sha256_files(staging, files)
    _F_COMMIT.fire(step=step)
    commit_t = time.time()
    with atomic_write(os.path.join(staging, COMMIT_MANIFEST)) as f:
        json.dump({"version": 2, "step": step, "time": commit_t, "files": files,
                   "sha256": hashes}, f, indent=2, sort_keys=True)
    if os.path.isdir(final):
        # re-saving the same step: drop the old dir so rename can land. The
        # vulnerable window (old gone, new not yet renamed) only affects the
        # step being overwritten, never other checkpoints.
        shutil.rmtree(final)
    os.replace(staging, final)
    fsync_dir(os.path.dirname(final) or ".")
    # stamp the training metrics plane (ckpt_last_commit_age_seconds); never
    # let an observability hiccup fail a landed commit
    try:
        from .integrations import note_checkpoint_commit

        note_checkpoint_commit(step=step, t=commit_t)
    except Exception as e:  # pragma: no cover - defensive
        logger.warning(f"checkpoint commit-time stamp failed: {e!r}")


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
    files = manifest.get("files", {})
    for rel, size in files.items():
        p = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(p):
            return f"manifest file missing: {rel}"
        actual = os.path.getsize(p)
        if actual != size:
            return f"size mismatch for {rel}: manifest {size}, on disk {actual}"
    if verify_hashes:
        digests = _sha256_files(ckpt_dir, [rel for rel in files if rel in hashes])
        for rel, digest in digests.items():
            if digest != hashes[rel]:
                return (f"content hash mismatch for {rel}: manifest sha256 "
                        f"{hashes[rel][:12]}…, on disk {digest[:12]}… (bit rot?)")
    return None


def is_committed(ckpt_dir: str) -> bool:
    """Commit-status check (manifest present + sizes match). Skips the full
    content-hash re-read: rotation calls this per dir on every save, and
    bit-rot detection belongs to the load/resume path, not the reaper."""
    return os.path.isdir(ckpt_dir) and validate_checkpoint(ckpt_dir, verify_hashes=False) is None


def _checkpoint_dirs(folder: str) -> List[str]:
    """``checkpoint-<step>`` dirs under ``folder``, oldest step first."""
    if not os.path.isdir(folder):
        return []
    steps = sorted((int(m.group(1)), d) for d in os.listdir(folder)
                   if (m := _re_checkpoint.match(d)) and os.path.isdir(os.path.join(folder, d)))
    return [os.path.join(folder, d) for _step, d in steps]


def get_last_committed_checkpoint(folder: str) -> Optional[str]:
    """Resume auto-discovery: newest ``checkpoint-<step>`` dir that passes
    manifest validation. Torn/uncommitted dirs are skipped with a warning —
    the fallback order is strictly newest-committed-first."""
    for path in reversed(_checkpoint_dirs(folder)):
        reason = validate_checkpoint(path)
        if reason is None:
            return path
        logger.warning(f"resume: skipping torn checkpoint {path}: {reason}")
    return None


def get_last_legacy_checkpoint(folder: str) -> Optional[str]:
    """Newest checkpoint dir with NO commit manifest at all — written by a
    pre-protocol trainer, loadable via the legacy path. A dir that HAS a
    manifest which fails validation is a torn post-protocol save and is never
    returned (loading it would raise CorruptCheckpointError)."""
    for path in reversed(_checkpoint_dirs(folder)):
        if not os.path.isfile(os.path.join(path, COMMIT_MANIFEST)):
            return path
    return None


def rotate_checkpoints(folder: str, limit: Optional[int],
                       best_model_checkpoint: Optional[str] = None) -> List[str]:
    """Delete stale ``checkpoint-*`` dirs beyond ``limit``, never touching:

    - the best-model checkpoint (paths realpath-normalized — a relative
      ``best_model_checkpoint`` must still protect the absolute dir);
    - uncommitted dirs (an in-progress async save or a torn dir a human may
      want for diagnosis — either way not ours to reap);
    - the newest committed checkpoint (the resume fallback target).

    Returns the deleted paths. Pending async saves must be joined by the
    caller first (``Trainer._rotate_checkpoints`` does) so an in-flight save's
    staging dir has landed before we decide what is stale."""
    if limit is None or limit <= 0:
        return []
    ckpts = _checkpoint_dirs(folder)
    if len(ckpts) <= limit:
        return []
    best = os.path.realpath(best_model_checkpoint) if best_model_checkpoint else None
    fallback = get_last_committed_checkpoint(folder)
    fallback = os.path.realpath(fallback) if fallback else None
    deleted: List[str] = []
    for path in ckpts[:-limit]:
        real = os.path.realpath(path)
        if best is not None and real == best:
            continue
        if fallback is not None and real == fallback:
            logger.info(f"rotation: keeping {path} (newest committed checkpoint; resume fallback)")
            continue
        if not is_committed(path):
            logger.warning(f"rotation: keeping uncommitted dir {path} (in-progress or torn save)")
            continue
        logger.info(f"rotating old checkpoint {path}")
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
    return deleted


# --------------------------------------------------------------------- save
def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later in-place updates of ``t`` cannot reach."""
    return t.detach().to("cpu", copy=True)


def save_unified_checkpoint(ckpt_dir: str, model, optimizer=None, trainer_state=None, tokenizer=None,
                            async_save: bool = False, after_commit=None):
    """Save ``model``'s parameters, ``optimizer``'s state (an ``AdamW``) and
    ``trainer_state`` to ``ckpt_dir`` and commit it. The state is copied to
    host memory (the trainer state serialized) before this returns; with ``async_save`` a writer thread
    writes and commits it. ``after_commit`` (no-arg callable) runs right
    after the rename lands, on the writer thread for an async save:
    rotation hooks in here so an async save stays async instead of being
    joined just to rotate."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(os.path.dirname(ckpt_dir) or ".", exist_ok=True)
    if trainer_state is not None:
        step = int(trainer_state.global_step)
    elif optimizer is not None:
        step = int(optimizer.count)
    else:
        step = None

    staging = ckpt_dir + STAGING_SUFFIX

    def _write(host_params, host_opt):
        # stale staging from an earlier crashed save: ours to reclaim (the
        # committed dir, if any, is untouched by anything below until commit)
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        model.save_pretrained(staging, params=host_params)
        if host_opt:
            shards, index = shard_checkpoint(host_opt, weights_name=OPTIMIZER_NAME)
            for fname, shard in shards:
                path = os.path.join(staging, fname)
                save_file(shard, path, metadata={"format": "np"})
                _F_WRITE_SHARD.fire(file=path, shard=fname)
            if index is not None:
                with atomic_write(os.path.join(staging, OPTIMIZER_NAME + ".index.json")) as f:
                    json.dump(index, f)
        if state_json is not None:
            with atomic_write(os.path.join(staging, TRAINER_STATE_NAME)) as f:
                f.write(state_json)
        if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(staging)
        _commit_checkpoint(staging, ckpt_dir, step)
        logger.info(f"unified checkpoint saved to {ckpt_dir} (step {step}, committed)")
        if after_commit is not None:
            after_commit()

    # everything the writer writes is taken now, on the calling thread: the
    # training loop goes on changing the live state (global_step, log_history)
    # while an async writer runs
    state_json = trainer_state.to_json_string() if trainer_state is not None else None
    host_params = unflatten_params({k: _to_host(v) for k, v in flatten_params(model.params).items()})
    host_opt = {k: _to_host(v) for k, v in _flatten_opt_state(optimizer).items()} if optimizer is not None else {}
    if async_save:
        t = threading.Thread(target=_writer_main, args=(_write, host_params, host_opt, ckpt_dir),
                             name=f"ckpt-save-{step}", daemon=False)
        t.start()
        with _pending_lock:
            _pending_saves.append(t)
    else:
        _write(host_params, host_opt)


def _writer_main(write_fn, host_params, host_opt, ckpt_dir):
    """Async-writer thread body: record the exception for join_pending_saves
    to surface — a save that died must not fail silently."""
    try:
        write_fn(host_params, host_opt)
    except BaseException as e:  # noqa: BLE001 - re-surfaced at join
        threading.current_thread()._ckpt_exc = e
        logger.error(f"async checkpoint save to {ckpt_dir} failed: {e!r} "
                     f"(staging dir left uncommitted; previous checkpoint still valid)")


def join_pending_saves(timeout: Optional[float] = None) -> int:
    """Join async writer threads and prune finished ones from the module list.

    Returns the number of saves still running after ``timeout`` (0 = drained).
    Exceptions raised inside writer threads are logged here; the checkpoint
    they belonged to is simply absent/uncommitted on disk."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with _pending_lock:
        threads = list(_pending_saves)
    for t in threads:
        remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
        t.join(timeout=remaining)
        exc = getattr(t, "_ckpt_exc", None)
        if exc is not None and not t.is_alive():
            logger.error(f"pending checkpoint save {t.name} failed: {exc!r}")
            t._ckpt_exc = None
    with _pending_lock:
        _pending_saves[:] = [t for t in _pending_saves if t.is_alive()]
        return len(_pending_saves)


def wait_for_pending_saves():
    """Back-compat alias: block until every async save finishes."""
    join_pending_saves(timeout=None)


# --------------------------------------------------------------------- load
def _resolve_optimizer_files(ckpt_dir: str) -> List[str]:
    """Single optimizer.safetensors OR sharded optimizer-XXXXX-of-NNNNN via index."""
    index_path = os.path.join(ckpt_dir, OPTIMIZER_NAME + ".index.json")
    if os.path.isfile(index_path):
        with open(index_path) as f:
            index = json.load(f)
        return [os.path.join(ckpt_dir, f) for f in sorted(set(index["weight_map"].values()))]
    single = os.path.join(ckpt_dir, OPTIMIZER_NAME)
    return [single] if os.path.isfile(single) else []


@torch.no_grad()
def load_unified_checkpoint(ckpt_dir: str, model, optimizer=None):
    """Restore ``model``'s parameters and ``optimizer``'s state from
    ``ckpt_dir``, copying into the existing tensors (their devices, dtypes
    and order stay), and return the checkpoint's ``TrainerState`` (None when
    it has no ``trainer_state.json``). A checkpoint that lacks a leaf of
    ``model`` raises ValueError.

    The commit manifest is validated first: a dir with a manifest that does not
    match the bytes on disk raises :class:`CorruptCheckpointError` (use
    :func:`get_last_committed_checkpoint` to auto-skip such dirs). A dir with
    no manifest at all is accepted as a legacy pre-protocol checkpoint, with a
    warning — it predates crash-safety, so its integrity is on the operator."""
    from .trainer_callback import TrainerState

    if os.path.isfile(os.path.join(ckpt_dir, COMMIT_MANIFEST)):
        reason = validate_checkpoint(ckpt_dir)
        if reason is not None:
            raise CorruptCheckpointError(f"checkpoint {ckpt_dir} failed validation: {reason}")
    else:
        logger.warning(f"checkpoint {ckpt_dir} has no {COMMIT_MANIFEST}; loading as legacy "
                       "(pre-commit-protocol) checkpoint without integrity validation")

    if hasattr(model, "trainable_mask"):
        # a PEFT facade saves only its own leaves (the JAX package's resume
        # calls the facade's from_pretrained with a model's keywords and fails)
        loaded = model.saved_leaves(ckpt_dir)
        lacking = [p for p, on in flatten_params(model.trainable_mask()).items() if on and p not in loaded]
        if lacking:
            raise ValueError(f"checkpoint {ckpt_dir} lacks {lacking}")
        live = flatten_params(model.params)
        for path, t in loaded.items():
            live[path].copy_(t)
    else:
        loaded = flatten_params(type(model).from_pretrained(ckpt_dir, device="cpu", config=model.config,
                                                             param_dtype=model.param_dtype, strict=True).params)
        for path, t in flatten_params(model.params).items():
            t.copy_(loaded.pop(path))
    del loaded

    opt_files = _resolve_optimizer_files(ckpt_dir)
    if optimizer is not None and opt_files:
        files = [SafeFile(f) for f in opt_files]
        try:
            by_key = {k: sf for sf in files for k in sf.keys()}
            optimizer.load_state_dict({k: by_key[k].get_torch(k) for k in optimizer.state_dict() if k in by_key})
        finally:
            for sf in files:
                sf.close()

    ts_path = os.path.join(ckpt_dir, TRAINER_STATE_NAME)
    return TrainerState.load_from_json(ts_path) if os.path.isfile(ts_path) else None
