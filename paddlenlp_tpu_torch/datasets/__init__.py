"""Datasets of the PyTorch port: ``load_dataset`` and zero-padding packing."""

from .zero_padding_dataset import (  # noqa: F401
    ZeroPaddingIterableDataset,
    ZeroPaddingMapDataset,
    greedy_pack,
)
from .dataset import (  # noqa: F401
    DATASET_REGISTRY,
    IterDataset,
    MapDataset,
    load_dataset,
    register_dataset,
)
