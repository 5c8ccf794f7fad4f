"""Durable usage ledger: append-only JSONL segments with atomic sealing.

Billing needs a record that survives the process: the in-memory rolling
aggregate (``GET /debug/usage``) answers "who is burning tokens right now",
but an invoice is built from files that are still correct after a kill -9
mid-write. This module provides the storage half of usage metering
(``serving/tenancy/metering.py`` builds the records; this file persists
them) with the same commit-protocol discipline as the checkpoint writer:

- records append to an **open segment** (``usage-<replica>-<seq>.open.jsonl``),
  one JSON object per line, flushed per record — a crash loses at most the
  torn tail of the open segment, never a sealed byte;
- segments **seal** by size or age: the full segment content is rewritten
  through :func:`utils.fileio.atomic_write` (temp file + fsync + rename) to
  ``usage-<replica>-<seq>.jsonl`` and the open file is removed — a sealed
  segment is immutable and torn-proof;
- **reload is tolerant**: sealed segments parse strictly in spirit (a corrupt
  line is dropped and counted — never raises), open segments drop + count a
  torn last line; a sealed/open twin pair (crash between rename and unlink)
  reads the sealed copy only.

The ``usage.seal`` fault point sits between the open segment's last append
and the seal's rename-commit so chaos tests can kill the process at the
exact torn-tail window (``action="partial"`` truncates the open segment
mid-line first — the classic torn write).

Stdlib-only on purpose: ``tools/usage_report.py`` re-implements the read
side without importing the package (no torch off-box), and this module is the
reference semantics it mirrors.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.faults import FaultPoint
from ..utils.fileio import atomic_write

__all__ = [
    "RECORD_SCHEMA_VERSION",
    "UsageLedger",
    "empty_aggregate",
    "fold_record",
    "load_ledger_dir",
    "merge_aggregates",
]

#: bumped on any backwards-incompatible record-field change; every record
#: carries it so an offline aggregator can refuse mixed-schema merges
RECORD_SCHEMA_VERSION = 1

OPEN_SUFFIX = ".open.jsonl"
SEALED_SUFFIX = ".jsonl"

#: the numeric record fields every aggregate view sums (per tenant, per
#: adapter, and fleet-total) — shared by the rolling aggregate, the router
#: fold, and (by mirrored definition) tools/usage_report.py
SUM_FIELDS = (
    "prompt_tokens",
    "cached_tokens",
    "completion_tokens",
    "useful_tokens",
    "spec_drafted",
    "spec_accepted",
    "kv_block_seconds",
    "adapter_slot_seconds",
)

_F_SEAL = FaultPoint("usage.seal")

#: disambiguates default replica names within one process — an in-process
#: fleet (tests, bench) runs several ledgers under one pid, and two ledgers
#: sharing a replica name in one directory would collide on segment files
_REPLICA_SEQ = itertools.count()


def empty_aggregate() -> Dict:
    return {"records": 0, "totals": {k: 0 for k in SUM_FIELDS},
            "tenants": {}, "adapters": {}}


def _fold_into(bucket: Dict, record: Dict):
    bucket["records"] = bucket.get("records", 0) + 1
    for k in SUM_FIELDS:
        v = record.get(k) or 0
        bucket[k] = round(bucket.get(k, 0) + v, 6) if isinstance(v, float) \
            else bucket.get(k, 0) + v


def fold_record(agg: Dict, record: Dict):
    """Fold one usage record into an aggregate doc (in place): fleet totals
    plus per-tenant and per-adapter buckets (``None`` adapter bills to the
    ``"base"`` key — base-model tokens are a billable class too)."""
    agg["records"] += 1
    for k in SUM_FIELDS:
        v = record.get(k) or 0
        t = agg["totals"]
        t[k] = round(t[k] + v, 6) if isinstance(v, float) else t[k] + v
    tenant = record.get("tenant") or "default"
    adapter = record.get("adapter_id") or "base"
    _fold_into(agg["tenants"].setdefault(tenant, {}), record)
    _fold_into(agg["adapters"].setdefault(adapter, {}), record)


def merge_aggregates(docs: Iterable[Dict]) -> Dict:
    """Sum N aggregate docs (the router's fleet fold). Missing keys read as
    zero so a replica running an older schema shrinks the fold, not breaks
    it."""
    out = empty_aggregate()
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        out["records"] += int(doc.get("records") or 0)
        for k in SUM_FIELDS:
            v = (doc.get("totals") or {}).get(k) or 0
            out["totals"][k] = round(out["totals"][k] + v, 6) \
                if isinstance(v, float) else out["totals"][k] + v
        for key in ("tenants", "adapters"):
            for name, bucket in (doc.get(key) or {}).items():
                dst = out[key].setdefault(name, {})
                for f, v in (bucket or {}).items():
                    if isinstance(v, (int, float)):
                        dst[f] = round(dst.get(f, 0) + v, 6) \
                            if isinstance(v, float) else dst.get(f, 0) + v
    return out


class UsageLedger:
    """Append-only usage-record store for ONE replica (see module docstring).

    Thread-safe: the engine loop appends, HTTP threads snapshot stats, and
    shutdown seals — all through one lock (every path is cold)."""

    def __init__(self, directory: str, replica: Optional[str] = None,
                 max_segment_records: int = 256,
                 max_segment_age_s: float = 300.0):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.replica = replica or f"pid{os.getpid()}n{next(_REPLICA_SEQ)}"
        self.max_segment_records = max(int(max_segment_records), 1)
        self.max_segment_age_s = float(max_segment_age_s)
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None  # open-segment file handle
        self._open_path: Optional[str] = None
        self._lines: List[str] = []  # the open segment's records, serialized
        self._opened_t: Optional[float] = None
        self._sealed_segments = 0
        self._records_total = 0
        self._closed = False
        # resume past any segments an earlier incarnation left behind (same
        # replica name restarting into the same dir must not collide)
        try:
            for name in os.listdir(self.dir):
                if name.startswith(f"usage-{self.replica}-"):
                    stem = name.split("-")[-1].split(".")[0]
                    if stem.isdigit():
                        self._seq = max(self._seq, int(stem) + 1)
        except OSError:
            pass

    # ----------------------------------------------------------------- write
    def _segment_stem(self) -> str:
        return os.path.join(self.dir, f"usage-{self.replica}-{self._seq:06d}")

    def append(self, record: Dict):
        """Durably append one record (flushed line in the open segment) and
        seal the segment when it crosses the size/age rotation bounds."""
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._closed:
                raise RuntimeError("usage ledger is closed")
            if self._fh is None:
                self._open_path = self._segment_stem() + OPEN_SUFFIX
                self._fh = open(self._open_path, "a", encoding="utf-8")
                self._opened_t = time.time()
            self._fh.write(line + "\n")
            self._fh.flush()
            self._lines.append(line)
            self._records_total += 1
            if (len(self._lines) >= self.max_segment_records
                    or time.time() - self._opened_t >= self.max_segment_age_s):
                self._seal_locked()

    def seal(self):
        """Seal the open segment now (rotation, shutdown, or a test forcing
        durable state). No-op with nothing buffered."""
        with self._lock:
            self._seal_locked()

    def _seal_locked(self):
        if self._fh is None:
            return
        open_path, lines = self._open_path, self._lines
        # the chaos window: a crash HERE leaves only the open segment (whose
        # tail "partial" may have torn) — reload must drop + count the tail
        # and lose nothing sealed
        _F_SEAL.fire(file=open_path)
        self._fh.close()
        self._fh = None
        sealed_path = open_path[: -len(OPEN_SUFFIX)] + SEALED_SUFFIX
        with atomic_write(sealed_path, mode="w", encoding="utf-8") as f:
            f.write("".join(l + "\n" for l in lines))
        try:
            os.unlink(open_path)
        except OSError:
            pass  # twin tolerated: reload prefers the sealed copy
        self._open_path = None
        self._lines = []
        self._opened_t = None
        self._seq += 1
        self._sealed_segments += 1

    def close(self):
        """Seal whatever is buffered and refuse further appends."""
        with self._lock:
            self._seal_locked()
            self._closed = True

    # ----------------------------------------------------------------- read
    def stats(self) -> Dict:
        with self._lock:
            return {
                "dir": self.dir,
                "replica": self.replica,
                "sealed_segments": self._sealed_segments,
                "open_records": len(self._lines),
                "records_total": self._records_total,
            }


def _parse_lines(path: str, open_segment: bool) -> Tuple[List[Dict], int]:
    """Parse one segment tolerantly: returns (records, dropped_lines). A bad
    LAST line of an open segment is the expected torn tail; any other bad
    line is corruption — both drop + count, neither raises."""
    records: List[Dict] = []
    dropped = 0
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            raw = f.read().split("\n")
    except OSError:
        return records, dropped
    lines = [l for l in raw if l.strip()]
    for line in lines:
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
            records.append(rec)
        except ValueError:
            dropped += 1
    return records, dropped


def load_ledger_dir(directory: str) -> Tuple[List[Dict], Dict]:
    """Read every segment under ``directory``. Returns ``(records, report)``
    where report counts sealed/open segments, torn-tail and corrupt lines
    dropped, and sealed/open twins skipped. Never raises on bad content."""
    report = {"sealed_segments": 0, "open_segments": 0, "records": 0,
              "torn_lines_dropped": 0, "twins_skipped": 0}
    records: List[Dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return records, report
    sealed_stems = {n[: -len(SEALED_SUFFIX)] for n in names
                    if n.endswith(SEALED_SUFFIX) and not n.endswith(OPEN_SUFFIX)}
    for name in names:
        path = os.path.join(directory, name)
        if name.endswith(OPEN_SUFFIX):
            if name[: -len(OPEN_SUFFIX)] in sealed_stems:
                # crash between rename-commit and unlink: the sealed copy is
                # authoritative, the leftover open file is a stale twin
                report["twins_skipped"] += 1
                continue
            recs, dropped = _parse_lines(path, open_segment=True)
            report["open_segments"] += 1
        elif name.endswith(SEALED_SUFFIX):
            recs, dropped = _parse_lines(path, open_segment=False)
            report["sealed_segments"] += 1
        else:
            continue
        records.extend(recs)
        report["torn_lines_dropped"] += dropped
    report["records"] = len(records)
    return records, report
