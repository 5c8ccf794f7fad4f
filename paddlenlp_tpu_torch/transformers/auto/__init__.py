from .configuration import AutoConfig  # noqa: F401
from .modeling import (  # noqa: F401
    AutoModel,
    AutoModelForCausalLM,
    AutoModelForCausalLMPipe,
    AutoModelForConditionalGeneration,
    AutoModelForMaskedLM,
    AutoModelForSeq2SeqLM,
    AutoModelForSequenceClassification,
    AutoModelForTokenClassification,
)
from .tokenizer import AutoTokenizer  # noqa: F401
