"""Continuous-batching LLM serving runtime of the PyTorch port (engine loop,
admission control, OpenAI-style HTTP API with SSE streaming, Prometheus
metrics plane).

Copies of ``paddlenlp_tpu/serving/`` over the port's ``InferenceEngine``,
with the multi-replica router tier in :mod:`.router` (``RouterServer``,
``ReplicaPool``, the policies, the autoscaler and the fleet launcher; stdlib
host code over N port ``ServingServer`` replicas). :mod:`.metrics` is
stdlib-only.
"""

from .api import ServingServer  # noqa: F401
from .brownout import BrownoutController, BrownoutPolicy, PRIORITIES  # noqa: F401
from .chat import ChatTemplate  # noqa: F401
from .engine_loop import (  # noqa: F401
    EngineLoop,
    RequestHandle,
    ServingMetrics,
    SupervisorPolicy,
)
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .scheduler import (  # noqa: F401
    DeadlineUnmetError,
    DegradedError,
    SaturatedError,
    Scheduler,
    SchedulerConfig,
    ShedError,
    ShuttingDownError,
)

__all__ = [
    "ServingServer",
    "ChatTemplate",
    "EngineLoop",
    "RequestHandle",
    "ServingMetrics",
    "SupervisorPolicy",
    "Scheduler",
    "SchedulerConfig",
    "SaturatedError",
    "ShuttingDownError",
    "DegradedError",
    "ShedError",
    "DeadlineUnmetError",
    "BrownoutController",
    "BrownoutPolicy",
    "PRIORITIES",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "REGISTRY",
]
