from .configuration import DeepseekV2Config  # noqa: F401
from .modeling import (  # noqa: F401
    DeepseekV2ForCausalLM,
    DeepseekV2Model,
    DeepseekV2PretrainedModel,
    DeepseekV2PretrainingCriterion,
)
