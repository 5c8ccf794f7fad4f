"""Pretraining data of the PyTorch port: mmap corpora, the GPT dataset, the
batch sampler, loader and collators (copies of ``paddlenlp_tpu/data``)."""

from .causal_dataset import BlendableDataset, GPTDataset, build_train_valid_test_datasets  # noqa: F401
from .data_collator import (  # noqa: F401
    DataCollatorForLanguageModeling,
    DataCollatorForSeq2Seq,
    DataCollatorWithPadding,
    default_data_collator,
)
from .dataloader import DataLoader, DistributedBatchSampler  # noqa: F401
from .indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder, make_dataset  # noqa: F401
