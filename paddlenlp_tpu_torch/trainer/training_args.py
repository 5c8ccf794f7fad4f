"""``TrainingArguments`` — the run-configuration surface.

Port of ``paddlenlp_tpu/trainer/training_args.py``: the same fields with the
reference's spelling, so the ``llm/config/*.json`` launch files parse, and
the same ``__post_init__`` normalization. The port trains on one device:
:meth:`TrainingArguments.check_supported` (called by the ``Trainer``) raises
``NotImplementedError`` for the parallel degrees, naming the ROADMAP item.
``load_best_model_at_end`` is accepted and only validated (its
``metric_for_best_model`` default), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.log import logger
from .trainer_utils import IntervalStrategy, SchedulerType

__all__ = ["TrainingArguments"]

_PARALLEL = "parallel training (ROADMAP Queue 1 item 12)"


@dataclass
class TrainingArguments:
    output_dir: str = field(default="output", metadata={"help": "output directory for checkpoints/logs"})
    overwrite_output_dir: bool = False

    do_train: bool = False
    do_eval: bool = False
    do_predict: bool = False

    per_device_train_batch_size: int = field(default=8, metadata={"help": "per data-parallel-shard batch size"})
    per_device_eval_batch_size: int = 8
    gradient_accumulation_steps: int = 1

    learning_rate: float = 5e-5
    min_learning_rate: float = 0.0
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0

    num_train_epochs: float = 3.0
    max_steps: int = -1
    lr_scheduler_type: str = "linear"
    warmup_ratio: float = 0.0
    warmup_steps: int = 0

    logging_first_step: bool = False
    logging_strategy: str = "steps"
    logging_steps: int = 500
    evaluation_strategy: str = "no"
    eval_steps: int = 500
    save_strategy: str = "steps"
    save_steps: int = 500
    save_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None

    seed: int = 42
    data_seed: Optional[int] = None

    bf16: bool = False
    fp16: bool = False  # accepted for config compat; mapped to bf16
    amp_master_grad: bool = True  # fp32 params + grads ("O2 + master weights")

    dataloader_drop_last: bool = True
    dataloader_num_workers: int = 0
    remove_unused_columns: bool = True
    label_names: Optional[List[str]] = None

    load_best_model_at_end: bool = False
    metric_for_best_model: Optional[str] = None
    greater_is_better: Optional[bool] = None
    ignore_data_skip: bool = False
    skip_data_intervals: Optional[List[List[int]]] = None

    run_name: Optional[str] = None
    report_to: Optional[List[str]] = None
    eval_logits_host_bytes_limit: int = field(
        default=2 << 30,
        metadata={"help": "evaluate()/predict() refuse to accumulate full logits past this many "
                          "host bytes (0 disables the check); pass preprocess_logits_for_metrics, "
                          "raise the limit, or set eval_reduce_logits_to_argmax"})
    eval_reduce_logits_to_argmax: bool = field(
        default=False,
        metadata={"help": "over the host-bytes limit, reduce eval logits to device-side argmax "
                          "token ids instead of raising (compute_metrics then receives [B, T] ids "
                          "rather than [B, T, V] logits)"})
    profiler_options: Optional[str] = field(
        default=None,
        metadata={"help": 'torch.profiler trace window, e.g. "batch_range=[10,20];profile_path=./prof" '
                          "(reference utils/profiler.py ProfilerOptions). The same window also "
                          "dumps the host-side span timeline (Chrome trace JSON) next to the "
                          "device trace."})
    metrics_port: Optional[int] = field(
        default=None,
        metadata={"help": "start a background HTTP observability exporter for this training job "
                          "(GET /metrics Prometheus text, /health, /debug/trace) on this port "
                          "(0 = ephemeral). None (default) disables it; metrics still populate "
                          "the in-process registry either way."})
    metrics_host: str = field(
        default="127.0.0.1",
        metadata={"help": "bind host for the metrics exporter (0.0.0.0 to expose off-host)"})
    disable_tqdm: bool = False

    # ---- parallelism (reference degrees, training_args.py:539-705) ----
    tensor_parallel_degree: int = 1
    pipeline_parallel_degree: int = 1
    sharding_parallel_degree: int = -1
    sep_parallel_degree: int = 1
    context_parallel_degree: int = 1
    sharding: str = field(default="", metadata={"help": '"" | stage1 | stage2 | stage3'})
    data_parallel_degree: int = -1  # derived
    use_expert_parallel: bool = False
    sequence_parallel: bool = False
    tensor_parallel_output: bool = True

    # ---- model runtime knobs bridged via LlmMetaConfig ----
    use_flash_attention: bool = True
    recompute: bool = False
    recompute_granularity: str = "full"
    use_scan_layers: bool = True  # the port always holds the stacked [L] layout

    # ---- reference per-axis config strings (training_args.py:645-705).
    # Recognized fleet comm-overlap toggles warn, unknown ones raise instead
    # of silently dropping a requested behavior. ----
    tensor_parallel_config: str = ""
    pipeline_parallel_config: str = ""
    sharding_parallel_config: str = ""
    sequence_parallel_config: str = ""
    hybrid_parallel_topo_order: str = ""

    # ---- checkpointing ----
    unified_checkpoint: bool = True
    async_save: bool = False

    def __post_init__(self):
        self.logging_strategy = IntervalStrategy(self.logging_strategy)
        self.evaluation_strategy = IntervalStrategy(self.evaluation_strategy)
        self.save_strategy = IntervalStrategy(self.save_strategy)
        self.lr_scheduler_type = SchedulerType(self.lr_scheduler_type)
        if self.fp16:
            logger.warning_once("fp16 requested: the port trains in bf16; using bf16")
            self.bf16, self.fp16 = True, False
        if self.load_best_model_at_end and self.metric_for_best_model is None:
            self.metric_for_best_model = "loss"
        if self.greater_is_better is None and self.metric_for_best_model is not None:
            self.greater_is_better = not self.metric_for_best_model.endswith("loss")
        if self.data_seed is None:
            self.data_seed = self.seed
        sharding = (self.sharding or "").replace(",", " ").split()
        self.sharding_stage = 0
        for s in sharding:
            if s.startswith("stage"):
                self.sharding_stage = int(s[5:])
        if self.sharding_parallel_degree == -1 and self.sharding_stage > 0:
            self.sharding_parallel_degree = 0  # "all devices" (check_supported refuses sharding)
        _KNOWN_OBSOLETE = {
            # fleet comm/overlap scheduling knobs: no effect on one device
            "enable_mp_async_allreduce", "enable_mp_skip_c_identity",
            "enable_mp_fused_linear_param_grad_add", "enable_delay_scale_loss",
            "enable_dp_comm_overlap", "enable_sharding_comm_overlap",
            "enable_release_grads", "enable_overlap_p2p_comm", "enable_clear_every_step_cache",
            "disable_partial_send_recv", "enable_timer", "enable_stage1_tensor_fusion",
            "enable_stage1_overlap", "enable_stage2_overlap", "split_param",
            "disable_p2p_cache_shape", "best_unbalanced_scheduler",
            "enable_allreduce_avg_in_gradinent_scale", "gradient_sync_after_accumulate",
        }
        for fieldname in ("tensor_parallel_config", "pipeline_parallel_config",
                          "sharding_parallel_config", "sequence_parallel_config"):
            raw = getattr(self, fieldname) or ""
            opts = raw.replace(",", " ").split()
            for o in opts:
                if o in _KNOWN_OBSOLETE:
                    logger.warning_once(
                        f"{fieldname}: option {o!r} is a fleet scheduling knob with no "
                        "effect on one device — ignored"
                    )
                else:
                    raise ValueError(
                        f"{fieldname}: unsupported option {o!r} (supported-but-obsolete "
                        f"fleet options are ignored with a warning; anything else is an error)"
                    )
        if self.hybrid_parallel_topo_order:
            if self.hybrid_parallel_topo_order not in ("pp_first", "sharding_first"):
                raise ValueError(
                    f"hybrid_parallel_topo_order={self.hybrid_parallel_topo_order!r}: "
                    "expected 'pp_first' or 'sharding_first'"
                )
            logger.warning_once(
                "hybrid_parallel_topo_order orders parallel groups; one device has none, "
                "so the knob is accepted for config compatibility and ignored"
            )

    # ------------------------------------------------------------------ support
    def check_supported(self):
        """Raise ``NotImplementedError`` for every option the port's trainer
        does not run yet (the parallel degrees), naming where it is planned."""
        degrees = {"tensor_parallel_degree": self.tensor_parallel_degree,
                   "pipeline_parallel_degree": self.pipeline_parallel_degree,
                   "sharding_parallel_degree": self.sharding_parallel_degree,
                   "sep_parallel_degree": self.sep_parallel_degree,
                   "context_parallel_degree": self.context_parallel_degree,
                   "data_parallel_degree": self.data_parallel_degree}
        for name, degree in degrees.items():
            if degree > 1:
                raise NotImplementedError(f"{name}={degree}: {_PARALLEL} is not part of the port yet")
        if self.sharding_stage > 0:
            raise NotImplementedError(f"sharding={self.sharding!r}: {_PARALLEL} is not part of the port yet")
        if self.sequence_parallel:
            raise NotImplementedError(f"sequence_parallel: {_PARALLEL} is not part of the port yet")
        if self.use_expert_parallel:
            raise NotImplementedError(f"use_expert_parallel: {_PARALLEL} is not part of the port yet")
        if not self.use_flash_attention:
            raise NotImplementedError("use_flash_attention=False: the port's attention is the flash kernels; "
                                      "the other path is ROADMAP Queue 1 item 14")

    # ------------------------------------------------------------------ topology (one device)
    @property
    def world_size(self) -> int:
        return 1

    @property
    def process_index(self) -> int:
        return 0

    @property
    def local_process_index(self) -> int:
        return 0

    @property
    def should_save(self) -> bool:
        return True

    @property
    def should_log(self) -> bool:
        return True

    @property
    def dataset_world_size(self) -> int:
        """Number of batch shards: one device, one shard."""
        return 1

    @property
    def train_batch_size(self) -> int:
        return self.per_device_train_batch_size

    @property
    def eval_batch_size(self) -> int:
        return self.per_device_eval_batch_size

    @property
    def global_train_batch_size(self) -> int:
        return self.per_device_train_batch_size * self.gradient_accumulation_steps * self.dataset_world_size

    @property
    def global_eval_batch_size(self) -> int:
        return self.per_device_eval_batch_size * self.dataset_world_size

    def get_warmup_steps(self, num_training_steps: int) -> int:
        return self.warmup_steps if self.warmup_steps > 0 else math.ceil(num_training_steps * self.warmup_ratio)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, (IntervalStrategy, SchedulerType)):
                d[k] = v.value
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def __str__(self):
        return f"TrainingArguments {self.to_json_string()}"
