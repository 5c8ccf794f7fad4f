"""The training loop of the PyTorch port (``paddlenlp_tpu/trainer``): arguments,
parser, callbacks and reporting integrations, timers, LR schedules, unified
checkpoints, the ``Trainer`` and the ``Seq2SeqTrainer``."""

from .argparser import PdArgumentParser  # noqa: F401
from .integrations import (  # noqa: F401
    JsonlLoggerCallback,
    MetricsCallback,
    TensorBoardCallback,
    WandbCallback,
    get_reporting_callbacks,
)
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
    EvalPrediction,
    IntervalStrategy,
    PredictionOutput,
    SchedulerType,
    TrainOutput,
    get_last_checkpoint,
    get_scheduler,
)
from .trainer_seq2seq import Seq2SeqTrainer  # noqa: F401
from .training_args import TrainingArguments  # noqa: F401
from .unified_checkpoint import (  # noqa: F401
    CorruptCheckpointError,
    get_last_committed_checkpoint,
    is_committed,
    join_pending_saves,
    rotate_checkpoints,
    validate_checkpoint,
)
