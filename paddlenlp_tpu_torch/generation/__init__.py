"""Decoding for the port's causal LMs (``paddlenlp_tpu/generation``):
``GenerationConfig``, the logits processors and warpers, the stopping
criteria, the streamers and ``GenerationMixin``."""

from .configuration_utils import GenerationConfig  # noqa: F401
from .logits_process import (  # noqa: F401
    FrequencyPenaltyLogitsProcessor,
    LogitsProcessorList,
    MinLengthLogitsProcessor,
    NoRepeatNGramLogitsProcessor,
    PresencePenaltyLogitsProcessor,
    RepetitionPenaltyLogitsProcessor,
    TemperatureLogitsWarper,
    TopKLogitsWarper,
    TopPLogitsWarper,
)
from .stopping_criteria import MaxLengthCriteria, MaxTimeCriteria, StoppingCriteriaList  # noqa: F401
from .streamers import TextIteratorStreamer, TextStreamer  # noqa: F401
from .utils import GenerationMixin  # noqa: F401
