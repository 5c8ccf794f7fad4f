"""Device ops of the PyTorch port: rotary embeddings, the loss, and the CUDA
attention kernels (built from ``paddlenlp_tpu_torch/csrc``): ragged paged
attention for serving and flash attention forward/backward for training
(``ops.flash_attention``, imported as a module: its main function shares
its name)."""

from .cross_entropy import causal_lm_loss, cross_entropy_with_ignore  # noqa: F401
from .paged_attention import paged_decode_attention, ragged_paged_attention, ragged_paged_attention_ref  # noqa: F401
from .rope import apply_rotary_pos_emb, rope_frequencies, rope_tables  # noqa: F401
