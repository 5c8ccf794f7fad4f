"""Observability of the PyTorch port, shared by serving and training.

- :mod:`.tracer` — thread-safe span tracing into a bounded ring buffer,
  exportable as Chrome trace-event JSON (Perfetto) or JSONL; the process-wide
  :data:`TRACER` is fed by the serving scheduler, the engine loop and the
  inference engine's step phases.
- :mod:`.exporter` — the shared ``/metrics`` and ``/debug/trace`` routes and
  the on-demand ``torch.profiler`` capture behind ``POST /debug/profile``.
- :mod:`.flight_recorder` — always-on bounded ring of structured *decision*
  events (why the scheduler admitted/deferred/preempted), names validated
  against :mod:`.event_catalog`.
- :mod:`.postmortem` — auto-dumped incident bundles (events + spans + health
  + metrics + config) behind ``PDNLP_TPU_POSTMORTEM_DIR`` and
  ``POST /debug/postmortem``.
- :mod:`.usage` — the durable usage ledger behind serving's metering.
- :mod:`.goodput` — the per-step device-efficiency ledger (exact
  ``fed == useful + padding + spec_rejected + rework`` conservation), step
  anatomy and the serving MFU estimator behind ``GET /debug/efficiency``.
- :mod:`.prometheus` — text-format parsing + exposition lint for scrapers.
- :mod:`.slo` — multi-window availability/TTFT burn rates over federated
  replica counters (the router's ``/fleet/slo`` plane), with a fast-burn
  trigger hook.

Copies of ``paddlenlp_tpu/observability/``.
"""

from .event_catalog import EVENT_CATALOG, EVENT_REASONS  # noqa: F401
from .exporter import ProfileCapture  # noqa: F401
from .flight_recorder import RECORDER, FlightEvent, FlightRecorder  # noqa: F401
from .goodput import GoodputLedger, device_peak_flops, efficiency_doc, estimate_model_flops_per_token  # noqa: F401
from .postmortem import PostmortemDumper, handle_postmortem_request  # noqa: F401
from .prometheus import (  # noqa: F401
    MetricFamily,
    histogram_quantile,
    lint_exposition,
    parse_prometheus_text,
)
from .slo import SLOObjectives, SLOTracker, slo_inputs_from_families  # noqa: F401
from .tracer import (  # noqa: F401
    TRACER,
    Span,
    SpanTracer,
    current_trace,
    format_traceparent,
    merge_chrome_traces,
    parse_traceparent,
    trace_sampled,
    use_trace,
)
