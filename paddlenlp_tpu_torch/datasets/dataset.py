"""Dataset loading: ``load_dataset`` registry + Map/Iter dataset wrappers.

Port of ``paddlenlp_tpu/datasets/dataset.py`` (host code over numpy; the
reference's ``paddlenlp/datasets/dataset.py`` :781 is a name->builder registry
over ~80 dataset scripts plus ``hf_datasets`` loaders). The registry resolves,
in order:

1. registered builders (``register_dataset`` — user/task code registers loaders);
2. local files or directories (json/jsonl/csv/tsv/txt, with split inference from
   file names: train/dev|validation/test);
3. ``datasets`` (HF) if installed and the name resolves from its local cache,
   in offline mode.

Builders yield dicts; results wrap in ``MapDataset`` (random access + ``map``/
``filter``/``shuffle``) or ``IterDataset`` (streaming ``map``/``filter``).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np


__all__ = ["load_dataset", "register_dataset", "MapDataset", "IterDataset", "DATASET_REGISTRY"]

DATASET_REGISTRY: Dict[str, Callable] = {}

SPLIT_ALIASES = {
    "train": ("train",),
    "dev": ("dev", "validation", "valid", "eval"),
    "validation": ("dev", "validation", "valid", "eval"),
    "test": ("test",),
}


def register_dataset(name: str):
    """Decorator: ``@register_dataset("my_corpus")`` over
    ``def build(split, **kwargs) -> iterable[dict]``."""

    def deco(fn):
        DATASET_REGISTRY[name] = fn
        return fn

    return deco


class MapDataset:
    """Random-access dataset with chainable eager transforms
    (reference MapDataset: ``map``/``filter``/``shuffle``)."""

    def __init__(self, data: Sequence):
        self.data = list(data) if not isinstance(data, list) else data

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]

    def __iter__(self):
        return iter(self.data)

    def map(self, fn: Callable, lazy: bool = False) -> "MapDataset":
        if lazy:
            return _LazyMapDataset(self, fn)
        self.data = [fn(x) for x in self.data]
        return self

    def filter(self, fn: Callable) -> "MapDataset":
        self.data = [x for x in self.data if fn(x)]
        return self

    def shuffle(self, seed: int = 0) -> "MapDataset":
        order = np.random.default_rng(seed).permutation(len(self.data))
        self.data = [self.data[i] for i in order]
        return self


class _LazyMapDataset(MapDataset):
    def __init__(self, base: MapDataset, fn: Callable):
        self.base = base
        self.fn = fn

    def __len__(self):
        return len(self.data) if "data" in self.__dict__ else len(self.base)

    def __getitem__(self, idx):
        if "data" in self.__dict__:
            return self.data[idx]
        return self.fn(self.base[idx])

    def __iter__(self):
        if "data" in self.__dict__:
            return iter(self.data)
        return (self.fn(x) for x in self.base)

    def _materialize(self) -> None:
        """Eager transforms chained after a lazy map (filter/shuffle/eager map)
        operate on self.data — realize it once, then behave like MapDataset."""
        if "data" not in self.__dict__:
            self.data = [self.fn(x) for x in self.base]

    def map(self, fn: Callable, lazy: bool = False) -> "MapDataset":
        if lazy:
            return _LazyMapDataset(self, fn)
        self._materialize()
        return MapDataset.map(self, fn)

    def filter(self, fn: Callable) -> "MapDataset":
        self._materialize()
        return MapDataset.filter(self, fn)

    def shuffle(self, seed: int = 0) -> "MapDataset":
        self._materialize()
        return MapDataset.shuffle(self, seed)


class IterDataset:
    """Streaming dataset: lazy ``map``/``filter`` over a generator factory."""

    def __init__(self, generator_fn: Callable[[], Iterable]):
        self._gen = generator_fn
        self._transforms: List = []

    def map(self, fn: Callable) -> "IterDataset":
        self._transforms.append(("map", fn))
        return self

    def filter(self, fn: Callable) -> "IterDataset":
        self._transforms.append(("filter", fn))
        return self

    def __iter__(self):
        it = iter(self._gen())
        for kind, fn in self._transforms:
            if kind == "map":
                it = map(fn, it)
            else:
                it = filter(fn, it)
        return it


# ------------------------------------------------------------------ file readers
def _read_file(path: str) -> List[dict]:
    ext = os.path.splitext(path)[1].lower()
    rows: List[dict] = []
    if ext in (".json", ".jsonl"):
        with open(path, encoding="utf-8") as f:
            head = f.read(1)
            f.seek(0)
            if head == "[":
                rows = json.load(f)
            else:
                rows = [json.loads(line) for line in f if line.strip()]
    elif ext in (".csv", ".tsv"):
        delim = "\t" if ext == ".tsv" else ","
        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f, delimiter=delim))
    elif ext == ".txt":
        with open(path, encoding="utf-8") as f:
            rows = [{"text": line.rstrip("\n")} for line in f if line.strip()]
    else:
        raise ValueError(f"unsupported dataset file type {ext!r} ({path})")
    return rows


def _find_split_file(directory: str, split: str) -> Optional[str]:
    names = sorted(os.listdir(directory))
    for alias in SPLIT_ALIASES.get(split, (split,)):
        for n in names:
            stem = os.path.splitext(n)[0].lower()
            if stem == alias or stem.startswith(alias + ".") or stem.startswith(alias + "_"):
                return os.path.join(directory, n)
    return None


def load_dataset(
    path_or_name: str,
    name: Optional[str] = None,
    splits: Union[str, Sequence[str], None] = None,
    data_files: Union[str, Dict[str, str], None] = None,
    lazy: bool = False,
    **kwargs,
):
    """Resolve a dataset by registry name, local path, or HF-datasets cache.

    Returns one dataset, or a list matching ``splits`` when several are asked.
    """
    single = isinstance(splits, str) or splits is None
    split_list = [splits] if isinstance(splits, str) else list(splits or ["train"])

    def wrap(rows):
        return MapDataset(rows)

    # 1. registered builder
    if path_or_name in DATASET_REGISTRY:
        builder = DATASET_REGISTRY[path_or_name]
        out = []
        for sp in split_list:
            rows = builder(split=sp, name=name, **kwargs)
            out.append(rows if isinstance(rows, (MapDataset, IterDataset)) else wrap(list(rows)))
        return out[0] if single else out

    # 2. explicit data_files
    if data_files is not None:
        if isinstance(data_files, str):
            ds = wrap(_read_file(data_files))
            return ds if single else [ds]
        out = [wrap(_read_file(data_files[sp])) for sp in split_list]
        return out[0] if single else out

    # 3. local file / directory
    if os.path.isfile(path_or_name):
        ds = wrap(_read_file(path_or_name))
        return ds if single else [ds]
    if os.path.isdir(path_or_name):
        out = []
        for sp in split_list:
            f = _find_split_file(path_or_name, sp)
            if f is None:
                raise FileNotFoundError(
                    f"no file for split {sp!r} in {path_or_name} "
                    f"(looked for {SPLIT_ALIASES.get(sp, (sp,))} with json/jsonl/csv/tsv/txt)"
                )
            out.append(wrap(_read_file(f)))
        return out[0] if single else out

    # 4. HF datasets local cache, in offline mode (the port downloads
    # nothing): without it a machine with no network would burn ~30s of
    # connection retries before erroring.
    try:
        _prev = os.environ.get("HF_DATASETS_OFFLINE")
        os.environ["HF_DATASETS_OFFLINE"] = "1"
        try:
            import datasets as hf_datasets  # type: ignore

            out = []
            for sp in split_list:
                d = hf_datasets.load_dataset(path_or_name, name, split=sp, **kwargs)
                out.append(wrap(list(d)))
            return out[0] if single else out
        finally:
            if _prev is None:
                os.environ.pop("HF_DATASETS_OFFLINE", None)
            else:
                os.environ["HF_DATASETS_OFFLINE"] = _prev
    except ImportError:
        pass
    except Exception as e:
        raise FileNotFoundError(
            f"dataset {path_or_name!r}: not a registered builder, not a local path, and the "
            f"hf-datasets fallback failed ({e}); register a builder with "
            f"register_dataset({path_or_name!r}) or pass data_files"
        ) from e
    raise FileNotFoundError(
        f"dataset {path_or_name!r}: not a registered builder and no such local path; "
        f"register a builder with register_dataset({path_or_name!r}) or pass data_files"
    )
