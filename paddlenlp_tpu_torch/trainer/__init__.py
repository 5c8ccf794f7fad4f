"""The training loop of the PyTorch port (``paddlenlp_tpu/trainer``): arguments,
parser, callbacks, timers, LR schedules and the ``Trainer``."""

from .argparser import PdArgumentParser  # noqa: F401
from .trainer import AdamW, Trainer  # noqa: F401
from .trainer_callback import (  # noqa: F401
    CallbackHandler,
    DefaultFlowCallback,
    EarlyStoppingCallback,
    PrinterCallback,
    ProgressCallback,
    TrainerCallback,
    TrainerControl,
    TrainerState,
)
from .trainer_utils import (  # noqa: F401
    IntervalStrategy,
    SchedulerType,
    TrainOutput,
    get_last_checkpoint,
    get_scheduler,
)
from .training_args import TrainingArguments  # noqa: F401
