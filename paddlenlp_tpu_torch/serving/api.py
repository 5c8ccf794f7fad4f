"""OpenAI-style HTTP front end for the continuous-batching engine.

Counterpart of the reference's ``llm/predict/flask_server.py`` (streaming chat
HTTP) and ``paddlenlp/server`` (REST), rebuilt on the serving runtime: requests
go through :class:`Scheduler` admission into the :class:`EngineLoop`, tokens
stream back over SSE, and the metrics plane is scraped at ``/metrics``.
Stdlib ``ThreadingHTTPServer`` only (no flask/fastapi in the image).

Routes::

    POST /v1/completions   {"prompt": str | [int], "max_tokens": int,
                            "stream": bool, "temperature"/"top_p"/"top_k"/
                            "seed"/"do_sample", "timeout": float,
                            "priority": "interactive"|"batch"|"best_effort",
                            "deadline_ms": float, "tenant": str,
                            "adapter_id": str}
    POST /v1/chat/completions
                           {"messages": [{"role", "content"}, ...],
                            "conversation"?: str, ... same fields} — prefix-
                           stable chat rendering over the same pipeline; the
                            optional conversation key is the router's sticky-
                            affinity hint
    POST /v1/abort         {"id": "cmpl-N"}        — cancel an in-flight request
    GET  /metrics          Prometheus text exposition
    GET  /health           liveness + scheduler/engine stats + tracer clock
    GET  /debug/requests   in-flight + recently finished request timelines
    GET  /debug/efficiency goodput ledger + step anatomy + compile telemetry
                           (what fraction of each device step was useful work)
    GET  /debug/trace      span ring buffer as Chrome trace JSON (Perfetto)
    GET  /debug/spans      span ring buffer as structured JSONL
    POST /debug/profile    on-demand torch.profiler capture (?seconds=S; 409
                           while another capture runs), started and stopped
                           on the engine loop's thread: its host ops and, on
                           a CUDA engine, the device kernels
    POST /debug/postmortem force a postmortem bundle dump (events + spans +
                           health + metrics + config); returns its path
    POST /admin/brownout   router/autoscaler-pushed overload-brownout floor
                           {"level": 0..3, "reason"?, "ttl_s"?}
    POST /admin/adapters   LoRA adapter hot-load/unload against the engine's
                           AdapterRegistry: {"op": "load", "adapter_id",
                           "path" | "weights", "scaling"?} | {"op": "unload",
                           "adapter_id"} | {"op": "list"} (400 when the
                           engine has no registry)
    POST /admin/weights    live base-weight hot-swap from a committed
                           checkpoint: {"ckpt_dir": str, "version"?,
                           "mode"?: "finish_old"|"pause_resume",
                           "canary"?: bool, "canary_digest"?, "timeout_s"?}
                           — 409 on uncommitted/torn checkpoints, dimension
                           conflicts, or a swap already in flight; a failed
                           swap rolls back to the old weights and also
                           answers 409 (body carries the rollback detail)

Backpressure maps to HTTP: 429 when the admission window is full (retryable),
503 while draining, 413 for oversized bodies. A client disconnect mid-stream
aborts the request so its KV blocks free immediately.

The server follows its engine's device: a CUDA engine serves from the card,
an engine built on the CPU (as the tests build it) from the CPU.

A copy of ``paddlenlp_tpu/serving/api.py``; checkpoints for ``/admin/weights``
load through the port's ``from_pretrained``.

Cross-tier tracing: a ``X-Pdnlp-Traceparent`` request header (stamped by the
router) makes the replica adopt the inbound trace id instead of minting its
own ``req-N``, and pins the propagated 1-in-N sampling decision on the tracer
— the router can then stitch both tiers' spans into one timeline.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from http.server import ThreadingHTTPServer
from typing import Dict, Optional

from ..observability.exporter import TorchProfiler, handle_profile_request, route_observability
from ..observability.postmortem import handle_postmortem_request
from ..observability.tracer import TRACEPARENT_HEADER, TRACER, parse_traceparent, use_trace
from ..utils.faults import FaultPoint
from ..utils.log import logger
from .chat import ChatTemplate
from .engine_loop import CANARY_PROMPT_IDS, EngineLoop, RequestHandle, ServingMetrics, SupervisorPolicy
from .httputil import JsonRequestHandler
from .metrics import REGISTRY, MetricsRegistry
from .brownout import PRIORITIES
from .scheduler import (
    DeadlineUnmetError,
    DegradedError,
    SaturatedError,
    Scheduler,
    SchedulerConfig,
    ShedError,
    ShuttingDownError,
)
from .tenancy.adapters import UnknownAdapterError
from .tenancy.quotas import DEFAULT_TENANT, TenantQuotas

__all__ = ["ServingServer", "WeightSwapConflictError"]

MAX_BODY_BYTES = 8 << 20  # 8 MiB: far above any sane prompt payload

# fires inside /admin/weights BEFORE any validation or load — an injected
# fault here must surface as a clean HTTP error with zero engine mutation
_F_WEIGHT_LOAD = FaultPoint("engine.weight_load")

#: model-config dimensions that shape the parameter tree (and the LoRA pool
#: arrays): a checkpoint disagreeing on any of these can never be hot-swapped
_DIM_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
               "num_hidden_layers", "num_attention_heads",
               "num_key_value_heads", "head_dim")


class WeightSwapConflictError(ValueError):
    """A weight-swap request that can never succeed against this replica as
    it stands: uncommitted/torn checkpoint, dimension mismatch vs the live
    model config or resident adapters, or a swap already in flight (HTTP
    409, never 500 — the engine was not touched)."""


def _sampling_from_payload(payload: dict, max_new_default: int = 64):
    from ..experimental import SamplingParams

    return SamplingParams(
        max_new_tokens=int(payload.get("max_tokens", max_new_default)),
        do_sample=bool(payload.get("do_sample", False)),
        temperature=float(payload.get("temperature", 1.0)),
        top_p=float(payload.get("top_p", 1.0)),
        top_k=int(payload.get("top_k", 0)),
        seed=int(payload.get("seed", 0)),
        repetition_penalty=float(payload.get("repetition_penalty", 1.0)),
        presence_penalty=float(payload.get("presence_penalty", 0.0)),
        frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
    )


class ServingServer:
    """Engine + loop + scheduler + HTTP, wired together.

    ``tokenizer`` is optional: without one, ``prompt`` must be a token-id list
    and responses carry ``token_ids`` instead of decoded ``text`` (the shape
    the CPU tests and the smoke benchmark use)."""

    def __init__(self, engine, tokenizer=None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 max_src_tokens: Optional[int] = None,
                 engine_factory=None,
                 supervisor_policy: Optional[SupervisorPolicy] = None,
                 trace_sample_every: Optional[int] = None,
                 tenant_quotas: Optional[TenantQuotas] = None,
                 usage_meter=None,
                 chat_template: Optional[ChatTemplate] = None):
        self.engine = engine
        # /v1/chat/completions rendering (prefix-stable by construction so
        # multi-turn conversations ride the hierarchical prefix cache)
        self.chat_template = chat_template or ChatTemplate()
        self.tokenizer = tokenizer if tokenizer is not None else getattr(engine, "tokenizer", None)
        self.registry = registry or REGISTRY
        self.tracer = TRACER
        if trace_sample_every is not None:
            # standalone 1-in-N sampling knob (router-fronted replicas get the
            # decision in the traceparent header instead)
            self.tracer.sample_every = int(trace_sample_every)
        self.max_body_bytes = max_body_bytes
        self.max_src_tokens = max_src_tokens
        self.loop = EngineLoop(engine, metrics=ServingMetrics(engine, self.registry),
                               engine_factory=engine_factory, policy=supervisor_policy,
                               usage=usage_meter)
        self.scheduler = Scheduler(self.loop, scheduler_config,
                                   tenant_quotas=tenant_quotas)
        # /debug/profile records the loop thread, started and stopped there
        self.profiler = TorchProfiler(run_on=self.loop.run_on_loop)
        # brownout side effects: level >= 2 turns speculative decode off on
        # the live engine (conserve device cycles for committed tokens); the
        # baseline is captured here so exit restores the configured behavior.
        # A supervisor rebuild comes up with factory defaults — the next level
        # transition re-applies.
        self._spec_baseline = bool(getattr(engine, "use_speculative", False))
        self.scheduler.brownout.on_level_change = self._apply_brownout_level
        self.loop.metrics.brownout_level.set_function(
            lambda: self.scheduler.brownout.level)
        self._ids = itertools.count()
        self._live: Dict[str, RequestHandle] = {}
        self._live_lock = threading.Lock()
        # Retry-After hint stamped on drain rejections (503): set by
        # start_drain(), defaults to a short generic backoff
        self._drain_retry_after = 5.0
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------- submission
    def _encode(self, prompt):
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt needs a tokenizer; pass token ids instead")
            ids = self.tokenizer.encode(prompt)
            ids = getattr(ids, "ids", ids)
        else:
            ids = [int(t) for t in prompt]
            # raw token ids come straight off the wire: range-check against
            # the model vocab (a bad id would otherwise surface as a garbage
            # completion, or as an engine-step failure downstream)
            vocab = getattr(getattr(self.engine, "model", None), "config", None)
            vocab = getattr(vocab, "vocab_size", None)
            if ids and vocab is not None and (min(ids) < 0 or max(ids) >= vocab):
                raise ValueError(
                    f"prompt token ids must be in [0, {vocab}); "
                    f"got min {min(ids)}, max {max(ids)}")
        if not ids:
            raise ValueError("empty prompt")
        if self.max_src_tokens is not None:
            ids = ids[-self.max_src_tokens:]
        return ids

    def submit(self, payload: dict, traceparent: Optional[str] = None,
               cid_prefix: str = "cmpl"):
        """Parse + admit one completion request. Returns (completion_id, handle).

        ``traceparent`` is the raw inbound propagation header (if any): the
        request adopts the upstream trace id and sampling decision, so its
        spans stitch into the router's timeline under one id."""
        if "prompt" not in payload:
            raise ValueError("missing required field 'prompt'")
        ids = self._encode(payload["prompt"])
        sampling = _sampling_from_payload(payload)
        if sampling.max_new_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        timeout_s = payload.get("timeout")
        if timeout_s is not None:
            timeout_s = float(timeout_s)
            if timeout_s <= 0:
                raise ValueError("timeout must be > 0 seconds")
        max_retries = payload.get("max_retries")
        if max_retries is not None:
            max_retries = int(max_retries)
            if max_retries < 0:
                raise ValueError("max_retries must be >= 0")
        priority = str(payload.get("priority", "interactive"))
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {'/'.join(PRIORITIES)}, got {priority!r}")
        deadline_s = payload.get("deadline_ms")
        if deadline_s is not None:
            deadline_s = float(deadline_s) / 1e3
            if deadline_s <= 0:
                raise ValueError("deadline_ms must be > 0 milliseconds")
        tenant = str(payload.get("tenant", DEFAULT_TENANT))
        if not tenant:
            raise ValueError("tenant must be a non-empty string")
        adapter_id = payload.get("adapter_id")
        if adapter_id is not None:
            adapter_id = str(adapter_id)
            # reject unknown adapters at the door (400) instead of letting the
            # submission die on the loop thread; the engine re-checks under
            # its own registry view, so a hot-unload race still fails safely
            registry = getattr(self.loop.engine, "adapter_registry", None)
            if registry is None:
                raise ValueError("this replica serves no LoRA adapters "
                                 "(engine has no adapter registry)")
            if adapter_id not in registry:
                raise ValueError(
                    f"unknown adapter_id {adapter_id!r}; load it first via "
                    f"POST /admin/adapters (registered: {registry.ids()})")
        trace_id = None
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            trace_id, parent_id, sampled = ctx
            # pin the upstream decision BEFORE any span can record under the id
            self.tracer.mark_trace(trace_id, sampled)
            # parentage marker: ties the adopted trace back to the tier that
            # placed it (recorded only for sampled traces, like every span)
            self.tracer.instant("trace_adopted", cat="serving", trace=trace_id,
                                parent=parent_id)
        handle = self.scheduler.submit(ids, sampling, timeout_s=timeout_s,
                                       max_retries=max_retries, trace=trace_id,
                                       priority=priority, deadline_s=deadline_s,
                                       tenant=tenant, adapter_id=adapter_id)
        cid = f"{cid_prefix}-{next(self._ids)}"
        with self._live_lock:
            self._live[cid] = handle
        handle.add_done_callback(lambda _h: self._forget(cid))
        return cid, handle

    def submit_chat(self, payload: dict, traceparent: Optional[str] = None):
        """Parse + admit one chat-completion request (POST
        /v1/chat/completions): render the conversation to token ids with the
        prefix-stable :class:`ChatTemplate`, then feed the ordinary
        completion pipeline — every downstream field (stream, priority,
        deadline, tenant, adapter_id, timeout) means exactly what it does on
        /v1/completions. ``conversation`` is an optional opaque sticky-
        routing key: the router pins a conversation's turns to one replica so
        its cached (device- or host-tier) KV keeps being re-used; the replica
        itself does not interpret it."""
        if "messages" not in payload:
            raise ValueError("missing required field 'messages'")
        if "prompt" in payload:
            raise ValueError("chat completions take 'messages', not 'prompt'")
        conversation = payload.get("conversation")
        if conversation is not None and not isinstance(conversation, str):
            raise ValueError("conversation must be a string key")

        def encode(text: str):
            if self.tokenizer is None:
                raise ValueError("string message content needs a tokenizer; "
                                 "pass token-id lists instead")
            ids = self.tokenizer.encode(text)
            return getattr(ids, "ids", ids)

        ids = self.chat_template.render(payload["messages"], encode)
        body = {k: v for k, v in payload.items()
                if k not in ("messages", "conversation")}
        body["prompt"] = ids
        return self.submit(body, traceparent=traceparent, cid_prefix="chatcmpl")

    def _forget(self, cid: str):
        with self._live_lock:
            self._live.pop(cid, None)

    def abort(self, cid: str) -> bool:
        with self._live_lock:
            handle = self._live.get(cid)
        if handle is None or handle.done():
            return False
        self.scheduler.cancel(handle)
        return True

    def start_drain(self, retry_after_s: Optional[float] = None) -> dict:
        """Replica-side drain: stop admitting NEW requests (direct traffic
        included — they 503 with ``Retry-After``) while in-flight streams
        finish. The router propagates its admin-plane drains here so a
        drained replica rejects clients that bypass the router, not just
        router-routed traffic. The engine loop keeps running until
        :meth:`shutdown`."""
        if retry_after_s is not None:
            retry_after_s = float(retry_after_s)
            if retry_after_s > 0:
                self._drain_retry_after = retry_after_s
        self.scheduler.start_drain()
        return {"draining": True, "retry_after_s": self._drain_retry_after}

    def stop_drain(self) -> dict:
        """Rejoin half of a rolling weight rollout: resume admitting new work
        after a drain. The engine loop never stopped, so there is nothing to
        restart — the admission gate just reopens."""
        self.scheduler.stop_drain()
        return {"draining": False}

    def efficiency(self) -> dict:
        """The ``GET /debug/efficiency`` document: the live engine's goodput
        ledger + step anatomy (the loop swaps engines on rebuild, so this
        always reads through ``loop.engine``). Engines without a ledger
        (stand-ins) report a minimal doc instead of a 500."""
        engine = self.loop.engine
        eff = getattr(engine, "efficiency", None)
        doc = eff() if eff is not None else {"tier": "serving", "ledger": None}
        doc["engine_state"] = self.loop.state
        return doc

    def usage(self) -> dict:
        """The ``GET /debug/usage`` document: the meter's rolling per-tenant/
        per-adapter aggregate plus durable-ledger stats. This is the replica
        view the router's ``/fleet/usage`` fold sums."""
        doc = self.loop.usage.snapshot()
        doc["engine_state"] = self.loop.state
        return doc

    def _apply_brownout_level(self, level: int):
        """Brownout ladder side effects on the live engine: level >= 2
        disables speculative decode (spend device time on committed tokens
        only); exit restores the construction-time baseline."""
        engine = self.loop.engine
        if hasattr(engine, "use_speculative"):
            engine.use_speculative = False if level >= 2 else self._spec_baseline

    def push_brownout(self, payload: dict) -> dict:
        """Router/autoscaler-pushed brownout floor (POST /admin/brownout):
        the fleet tier saw SLO fast burn or is pinned at its max scale
        envelope, so this replica must start shedding even if its local
        pressure signal has not tripped yet. ``{"level": 0..3, "reason"?,
        "ttl_s"?}`` — level 0 lifts the floor."""
        level = int(payload.get("level", 1))
        if not 0 <= level <= 3:
            raise ValueError(f"level must be in [0, 3], got {level}")
        ttl_s = payload.get("ttl_s")
        if ttl_s is not None:
            ttl_s = float(ttl_s)
            if not (ttl_s > 0):
                raise ValueError("ttl_s must be > 0 seconds")
        reason = str(payload.get("reason", "slo_fast_burn"))
        effective = self.scheduler.brownout.push(level, reason=reason, ttl_s=ttl_s)
        return {"level": effective, "pushed": level,
                "brownout": self.scheduler.brownout.stats()}

    def admin_adapters(self, payload: dict) -> dict:
        """LoRA adapter hot-load/unload (POST /admin/adapters) against the
        live engine's :class:`AdapterRegistry`. Ops::

            {"op": "load", "adapter_id": str,
             "path": str | "weights": {"<proj>.lora_A": [[...]], ...},
             "scaling"?: float}     -> registers (idempotent on same bytes)
            {"op": "unload", "adapter_id": str}  -> drops store + pool slot
            {"op": "list"}                       -> ids + pool stats only

        Loading only registers in the host store; the device pool slot is
        taken lazily by the first request that decodes with the adapter.
        Unload is refused (409 via ValueError) while any request holds it."""
        registry = getattr(self.loop.engine, "adapter_registry", None)
        if registry is None:
            raise ValueError("this replica serves no LoRA adapters "
                             "(engine has no adapter registry)")
        op = str(payload.get("op", "list"))
        doc: dict = {"op": op}
        if op == "load":
            adapter_id = str(payload.get("adapter_id") or "")
            source = payload.get("path") if payload.get("path") is not None \
                else payload.get("weights")
            if source is None:
                raise ValueError("load needs 'path' (safetensors) or 'weights'")
            if isinstance(source, dict):
                # JSON bodies carry nested lists; the registry wants arrays
                source = {k: v for k, v in source.items()}
            scaling = payload.get("scaling")
            doc["digest"] = registry.add(
                adapter_id, source,
                scaling=None if scaling is None else float(scaling))
            doc["adapter_id"] = adapter_id
        elif op == "unload":
            adapter_id = str(payload.get("adapter_id") or "")
            registry.remove(adapter_id)
            doc["adapter_id"] = adapter_id
        elif op != "list":
            raise ValueError(f"op must be load/unload/list, got {op!r}")
        doc["adapters"] = registry.ids()
        doc["stats"] = registry.stats()
        return doc

    def _check_ckpt_dims(self, ckpt_dir: str):
        """409-gate a swap on checkpoint/model dimension agreement BEFORE any
        bytes are loaded. Two layers: the checkpoint's own config must agree
        with the live model config on every tree-shaping dimension, and when
        LoRA adapters are resident their pool projection shapes (derived from
        the same dims) must survive the swap — a mismatch is listed per-field
        so the operator sees exactly what conflicts."""
        from .tenancy.adapters import adapter_dims_from_config

        model = self.loop.engine.model
        cur = model.config
        try:
            new = type(cur).from_pretrained(ckpt_dir)
        except Exception as e:
            raise WeightSwapConflictError(
                f"checkpoint {ckpt_dir} has no readable model config: {e}")
        conflicts = []
        for field in _DIM_FIELDS:
            a, b = getattr(cur, field, None), getattr(new, field, None)
            if a is not None and b is not None and int(a) != int(b):
                conflicts.append(f"{field}: model {a} vs checkpoint {b}")
        if conflicts:
            raise WeightSwapConflictError(
                "checkpoint dimensions conflict with the live model config: "
                + "; ".join(conflicts))
        registry = getattr(self.loop.engine, "adapter_registry", None)
        resident = registry.ids() if registry is not None else []
        if resident:
            cur_dims = adapter_dims_from_config(cur)
            new_dims = adapter_dims_from_config(new)
            bad = [f"{proj}: {cur_dims[proj]} vs {new_dims[proj]}"
                   for proj in cur_dims if cur_dims[proj] != new_dims.get(proj)]
            if bad:
                raise WeightSwapConflictError(
                    f"checkpoint projection shapes conflict with resident "
                    f"adapters {resident}: " + "; ".join(bad))

    def _load_ckpt_params(self, ckpt_dir: str):
        """Materialize the checkpoint's parameter tree on the host, in the live
        model's dtype (placement onto the model's device happens inside the
        quiesced swap via ``sync_params``). Built against the LIVE config so
        the tree structure is guaranteed identical; a leaf-shape surprise
        inside the loader (torn shard, wrong file, a leaf the checkpoint
        lacks) is still a 409, not a 500."""
        model = self.loop.engine.model
        try:
            loaded = type(model).from_pretrained(
                ckpt_dir, device="cpu", param_dtype=model.param_dtype, config=model.config, strict=True)
        except ValueError as e:
            raise WeightSwapConflictError(
                f"checkpoint {ckpt_dir} does not match the live parameter "
                f"tree: {e}")
        return loaded.params

    def admin_weights(self, payload: dict) -> dict:
        """Live base-weight hot-swap (POST /admin/weights): validate a
        committed checkpoint, 409-gate dimension conflicts, load the new tree,
        then hand it to the engine loop which quiesces at a step boundary,
        installs through the backend seam, bumps the prefix-cache epoch, runs
        the canary probe, and rolls back all-or-nothing on any failure.
        Everything that can fail cheaply fails HERE, on the HTTP thread,
        before the loop is asked to touch the engine."""
        ckpt_dir = payload.get("ckpt_dir")
        if not ckpt_dir or not isinstance(ckpt_dir, str):
            raise ValueError("missing required field 'ckpt_dir' (string path)")
        _F_WEIGHT_LOAD.fire(path=ckpt_dir)
        from ..trainer.unified_checkpoint import validate_checkpoint

        reason = validate_checkpoint(ckpt_dir, verify_hashes=True)
        if reason is not None:
            raise WeightSwapConflictError(
                f"checkpoint {ckpt_dir} is not swappable: {reason}")
        self._check_ckpt_dims(ckpt_dir)
        new_params = self._load_ckpt_params(ckpt_dir)
        version = str(payload.get("version")
                      or os.path.basename(os.path.normpath(ckpt_dir)))
        mode = str(payload.get("mode", "finish_old"))
        timeout_s = payload.get("timeout_s")
        timeout_s = 120.0 if timeout_s is None else float(timeout_s)
        canary = bool(payload.get("canary", True))
        canary_digest = payload.get("canary_digest")
        if canary_digest is not None:
            canary_digest = str(canary_digest)
        canary_ids = payload.get("canary_prompt")
        if canary_ids is not None:
            canary_ids = tuple(int(t) for t in canary_ids)
        elif canary:
            canary_ids = CANARY_PROMPT_IDS
        try:
            result = self.loop.request_weight_swap(
                new_params, version, mode=mode,
                canary_prompt_ids=canary_ids, canary_digest=canary_digest,
                timeout_s=timeout_s)
        except RuntimeError as e:
            # another swap holds the loop, or the loop is not running: the
            # engine was not touched — a clean conflict, not a server error
            raise WeightSwapConflictError(str(e))
        result["ckpt_dir"] = ckpt_dir
        return result

    def _decode_delta(self, toks, emitted: int, final: bool = False):
        """Incremental detokenization: full-decode + diff. A trailing U+FFFD
        means a codepoint is still split across tokens — hold it back until the
        next token resolves it (or ``final`` flushes it as-is), otherwise the
        replacement char would be emitted and never corrected."""
        if self.tokenizer is None:
            return None, emitted
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        safe = len(text)
        if not final:
            while safe > emitted and text[safe - 1] == "�":
                safe -= 1
        return text[emitted:safe], safe

    # ------------------------------------------------------------- http
    def _make_httpd(self, host: str, port: int) -> ThreadingHTTPServer:
        server = self

        class Handler(JsonRequestHandler):
            log_prefix = "serving"

            @property
            def max_body_bytes(self):  # live read: the cap is server-tunable
                return server.max_body_bytes

            # --------------------------------------------------------- GET
            def do_GET(self):
                try:
                    # /metrics, /debug/trace, /debug/spans: shared with the
                    # training exporter (observability.exporter)
                    routed = route_observability(self.path, server.registry, server.tracer)
                    if routed is not None:
                        self._send_raw(routed[0], routed[2], routed[1])
                    elif self.path == "/health":
                        if server.scheduler.draining:
                            status = "draining"
                        elif server.loop.degraded:
                            status = "degraded"
                        else:
                            status = "ok"
                        headers = None
                        if status == "degraded":
                            headers = {"Retry-After": max(1, int(round(server.loop.retry_after_hint())))}
                        elif status == "draining":
                            headers = {"Retry-After": max(1, int(round(server._drain_retry_after)))}
                        self._send_json(200 if status == "ok" else 503, {
                            "status": status,
                            "scheduler": server.scheduler.stats(),
                            "engine": server.loop.engine.stats(),
                            # base-weight version this replica serves: the
                            # router's rollout gate and version-skew failover
                            # guard both key off this field
                            "weights_version": server.loop.weights_version,
                            # overload ladder level, top-level so the router's
                            # health poller can read it without digging into
                            # scheduler stats (>= 2 suppresses hedging here)
                            "brownout": server.scheduler.brownout.level,
                            # tracer-timeline clock, piggybacked for the
                            # router's RTT-midpoint clock-skew estimate
                            "now": server.tracer.now(),
                        }, headers=headers)
                    elif self.path == "/debug/requests":
                        self._send_json(200, {
                            "inflight": server.loop.inflight_info(),
                            "recent": list(server.loop.recent_finished),
                        })
                    elif self.path == "/debug/efficiency":
                        self._send_json(200, server.efficiency())
                    elif self.path == "/debug/usage":
                        self._send_json(200, server.usage())
                    else:
                        self._send_error_json(404, f"no route {self.path}", "not_found")
                except (BrokenPipeError, ConnectionResetError):
                    logger.debug("serving: client disconnected during GET")

            # --------------------------------------------------------- POST
            def do_POST(self):
                try:
                    if self.path.split("?", 1)[0] in ("/debug/profile",
                                                      "/debug/postmortem"):
                        # drain any request body before responding: leftover
                        # bytes would desync the next request on this
                        # keep-alive connection
                        n = int(self.headers.get("Content-Length") or 0)
                        if n:
                            self.rfile.read(n)
                        routed = handle_profile_request(self.path, profiler=server.profiler) \
                            or handle_postmortem_request(self.path, server.loop.postmortem)
                        self._send_raw(routed[0], routed[2], routed[1])
                    elif self.path == "/v1/completions":
                        payload = self._read_body()
                        if payload is not None:
                            self._completions(payload)
                    elif self.path == "/v1/chat/completions":
                        payload = self._read_body()
                        if payload is not None:
                            self._completions(payload, chat=True)
                    elif self.path == "/v1/abort":
                        payload = self._read_body()
                        if payload is not None:
                            ok = server.abort(str(payload.get("id", "")))
                            self._send_json(200, {"id": payload.get("id"), "cancelled": ok})
                    elif self.path == "/admin/drain":
                        payload = self._read_body()
                        if payload is not None:
                            try:
                                if payload.get("undo"):
                                    doc = server.stop_drain()
                                else:
                                    doc = server.start_drain(payload.get("retry_after_s"))
                            except (TypeError, ValueError):
                                self._send_error_json(
                                    400,
                                    f"retry_after_s must be a number, got "
                                    f"{payload.get('retry_after_s')!r}",
                                    "invalid_request")
                            else:
                                self._send_json(200, doc)
                    elif self.path == "/admin/weights":
                        payload = self._read_body()
                        if payload is not None:
                            try:
                                doc = server.admin_weights(payload)
                            except WeightSwapConflictError as e:
                                self._send_error_json(409, str(e), "weights_conflict")
                            except TimeoutError as e:
                                self._send_error_json(
                                    504, f"weight swap timed out: {e}", "swap_timeout")
                            except (TypeError, ValueError) as e:
                                self._send_error_json(400, str(e), "invalid_request")
                            else:
                                # a swap that failed mid-flight rolled back and
                                # kept serving the old weights: a conflict with
                                # the full rollback detail in the body, so the
                                # router's rollout orchestrator can abort on it
                                self._send_json(200 if doc.get("ok") else 409, doc)
                    elif self.path == "/admin/adapters":
                        payload = self._read_body()
                        if payload is not None:
                            try:
                                doc = server.admin_adapters(payload)
                            except UnknownAdapterError as e:
                                self._send_error_json(404, str(e), "unknown_adapter")
                            except (TypeError, ValueError) as e:
                                self._send_error_json(400, str(e), "invalid_request")
                            else:
                                self._send_json(200, doc)
                    elif self.path == "/admin/brownout":
                        payload = self._read_body()
                        if payload is not None:
                            try:
                                doc = server.push_brownout(payload)
                            except (TypeError, ValueError) as e:
                                self._send_error_json(400, str(e), "invalid_request")
                            else:
                                self._send_json(200, doc)
                    else:
                        self._send_error_json(404, f"no route {self.path}", "not_found")
                except (BrokenPipeError, ConnectionResetError):
                    # dead socket: never attempt a second write
                    logger.debug("serving: client disconnected during POST")
                except Exception as e:
                    logger.warning(f"serving: error on {self.path}: {e!r}")
                    try:
                        self._send_error_json(500, str(e), "internal_error")
                    except (BrokenPipeError, ConnectionResetError):
                        pass

            def _completions(self, payload: dict, chat: bool = False):
                try:
                    submit = server.submit_chat if chat else server.submit
                    cid, handle = submit(
                        payload, traceparent=self.headers.get(TRACEPARENT_HEADER))
                except SaturatedError as e:
                    # Retry-After from the live queue-wait estimate: the hint
                    # tracks how deep the backlog actually is right now
                    self._send_error_json(
                        429, str(e), "rate_limit_exceeded",
                        headers={"Retry-After": max(1, int(round(
                            getattr(e, "retry_after_s", 1.0))))})
                    return
                except ShedError as e:
                    # brownout priority shed: clean 503 + the live hint — the
                    # client (or router) backs off instead of re-queueing work
                    # the ladder will keep rejecting
                    self._send_error_json(
                        503, str(e), "overloaded_shed",
                        headers={"Retry-After": max(1, int(round(e.retry_after_s)))})
                    return
                except DeadlineUnmetError as e:
                    self._send_error_json(
                        503, str(e), "deadline_unmet",
                        headers={"Retry-After": max(1, int(round(e.retry_after_s)))})
                    return
                except DegradedError as e:
                    # circuit breaker: engine rebuild in progress — a clean 503
                    # with a recovery hint, never a connection reset
                    self._send_error_json(
                        503, str(e), "engine_recovering",
                        headers={"Retry-After": max(1, int(round(e.retry_after_s)))})
                    return
                except ShuttingDownError as e:
                    # draining replica: a clean 503 WITH a retry hint so a
                    # direct client backs off instead of hammering a server
                    # that is leaving the fleet
                    self._send_error_json(
                        503, str(e), "shutting_down",
                        headers={"Retry-After": max(1, int(round(server._drain_retry_after)))})
                    return
                except (ValueError, TypeError) as e:
                    self._send_error_json(400, str(e), "invalid_request")
                    return
                # ambient trace id: log records emitted while serving this
                # request carry it in JSON log mode (log <-> trace join key)
                with use_trace(handle.trace):
                    if payload.get("stream"):
                        self._stream_response(cid, handle, chat=chat)
                    else:
                        self._batch_response(cid, handle, chat=chat)

            def _batch_response(self, cid: str, handle, chat: bool = False):
                try:
                    req = handle.result()  # deadline enforced by the loop
                except UnknownAdapterError as e:
                    # adapter hot-unloaded between the door check and engine
                    # admission: still a client-visible 4xx, not a 500
                    self._send_error_json(400, str(e), "unknown_adapter")
                    return
                choice = {"index": 0, "finish_reason": req.finish_reason if req else "abort"}
                toks = list(req.output_ids) if req is not None else []
                text = (server.tokenizer.decode(toks, skip_special_tokens=True)
                        if server.tokenizer is not None else None)
                if chat:
                    # chat shape: the completion is an assistant message whose
                    # token_ids are what the NEXT turn should thread back as
                    # assistant content for an exact prefix-cache replay
                    message = {"role": "assistant", "token_ids": toks}
                    if text is not None:
                        message["content"] = text
                    choice["message"] = message
                else:
                    choice["token_ids"] = toks
                    if text is not None:
                        choice["text"] = text
                self._send_json(200, {
                    "id": cid,
                    "object": "chat.completion" if chat else "text_completion",
                    "choices": [choice],
                    "usage": {
                        "prompt_tokens": handle.prompt_len,
                        "cached_tokens": int(getattr(req, "cached_tokens", 0) or 0),
                        "completion_tokens": len(toks),
                        "total_tokens": handle.prompt_len + len(toks),
                    },
                    "timing": {
                        "ttft_s": req.ttft if req else None,
                        "queue_wait_s": req.queue_wait if req else None,
                        "decode_time_s": req.decode_time if req else None,
                    },
                })

            def _stream_response(self, cid: str, handle, chat: bool = False):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

                def chunk(obj: dict):
                    self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                    self.wfile.flush()

                obj = "chat.completion.chunk" if chat else "text_completion.chunk"
                toks, emitted = [], 0
                try:
                    if chat:
                        # role preamble first, in the OpenAI chat-chunk shape
                        chunk({"id": cid, "object": obj, "choices": [
                            {"index": 0, "delta": {"role": "assistant"},
                             "finish_reason": None}]})
                    for tok in handle.tokens():
                        toks.append(tok)
                        piece, emitted = server._decode_delta(toks, emitted)
                        if chat:
                            delta = {"token": tok}
                            if piece is not None:
                                delta["content"] = piece
                            c = {"index": 0, "delta": delta, "finish_reason": None}
                        else:
                            c = {"index": 0, "token": tok, "finish_reason": None}
                            if piece is not None:
                                c["text"] = piece
                        chunk({"id": cid, "object": obj, "choices": [c]})
                    req = handle.result()
                    final = {"index": 0,
                             "finish_reason": req.finish_reason if req else "abort"}
                    # flush any held-back partial-codepoint text
                    piece, emitted = server._decode_delta(toks, emitted, final=True)
                    if chat:
                        final["delta"] = {"content": piece} if piece else {}
                    elif piece:
                        final["text"] = piece
                    chunk({"id": cid, "object": obj,
                           "choices": [final],
                           "usage": {"prompt_tokens": handle.prompt_len,
                                     "cached_tokens": int(getattr(req, "cached_tokens", 0) or 0),
                                     "completion_tokens": len(toks),
                                     "total_tokens": handle.prompt_len + len(toks)}})
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-stream: free the slot + KV now
                    logger.debug(f"serving: client disconnected; aborting {cid}")
                    server.abort(cid)
                except Exception as e:
                    # headers already sent — a second status line would corrupt
                    # the stream; terminate it in-band instead
                    logger.warning(f"serving: stream {cid} failed: {e!r}")
                    server.abort(cid)
                    try:
                        chunk({"id": cid, "object": "error",
                               "error": {"message": str(e), "type": "internal_error"}})
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass

        httpd = ThreadingHTTPServer((host, port), Handler)
        httpd.daemon_threads = True
        return httpd

    # ------------------------------------------------------------- lifecycle
    def start_in_thread(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start loop + HTTP without blocking; returns the bound port."""
        self.loop.start()
        self._httpd = self._make_httpd(host, port)
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="serving-http")
        t.start()
        bound = self._httpd.server_address[1]
        logger.info(f"serving API on {host}:{bound} (POST /v1/completions, GET /metrics)")
        return bound

    def run(self, host: str = "0.0.0.0", port: int = 8011):
        self.loop.start()
        self._httpd = self._make_httpd(host, port)
        logger.info(f"serving API on {host}:{port} (POST /v1/completions, GET /metrics)")
        try:
            self._httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self, drain_timeout_s: Optional[float] = 30.0):
        """Graceful: stop admitting (503), drain in-flight, stop loop + HTTP."""
        self.scheduler.shutdown(timeout_s=drain_timeout_s)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
