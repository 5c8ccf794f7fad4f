"""Streaming HTTP chat server.

Port of ``llm/predict/flask_server.py`` (reference
``llm/predict/flask_server.py``: streaming HTTP on flask + a SysV message
queue). Stdlib only: ``ThreadingHTTPServer`` + server-sent events straight
from the engine's token callbacks.

POST /generate  {"src": str, "max_length"?: int, "stream"?: bool}
GET  /health

``serve_v1`` serves the predictor's engine through the port's
``serving.ServingServer`` instead (``/v1/completions``, ``/v1/chat/completions``,
``/metrics``), which reads string prompts and chat messages through the
predictor's tokenizer. Launch on the card with

    python -m paddlenlp_tpu_torch.llm.predict.flask_server --model_name_or_path <dir> --mode block [--port 8011] [--api v1]
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ...trainer import PdArgumentParser
from ...utils.log import logger
from .predictor import BlockPredictor, PredictorArgument, create_predictor

__all__ = ["main", "make_handler", "serve", "serve_v1"]


def make_handler(predictor, lock: threading.Lock):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt % args)

        def do_GET(self):
            if self.path == "/health":
                body = json.dumps({"status": "ok"}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/generate":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
                text = payload["src"]
            except (json.JSONDecodeError, KeyError) as e:
                body = json.dumps({"error": f"bad request: {e}"}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            stream = bool(payload.get("stream", False))
            if "max_length" in payload:
                predictor.args.max_length = int(payload["max_length"])
            with lock:  # one generation at a time per engine (batching inside)
                if stream and isinstance(predictor, BlockPredictor):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    for piece in predictor.stream_predict(text):
                        self.wfile.write(f"data: {json.dumps({'token': piece})}\n\n".encode())
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                else:
                    out = predictor.predict([text])[0]
                    body = json.dumps({"output": out}, ensure_ascii=False).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

    return Handler


def serve(predictor, port: int = 8011):
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(predictor, threading.Lock()))
    logger.info(f"serving on :{port} (POST /generate)")
    server.serve_forever()


def serve_v1(predictor, port: int = 8011):
    """Serve through the continuous-batching runtime (``serving``):
    concurrent requests share the engine's running batch instead of taking
    turns behind the legacy per-request lock; adds /v1/completions SSE
    streaming, admission control (429/503) and /metrics. Needs --mode block.
    The server gets a metrics registry of its own: on the process-wide one,
    its pull gauges would keep the engine alive after it shuts down."""
    from ...serving import MetricsRegistry, SchedulerConfig, ServingServer

    if not isinstance(predictor, BlockPredictor):
        raise ValueError("--api v1 needs the paged engine: run with --mode block")
    server = ServingServer(
        predictor.engine,
        registry=MetricsRegistry(),
        tokenizer=predictor.tokenizer,
        scheduler_config=SchedulerConfig(max_inflight=4 * predictor.args.batch_size),
        max_src_tokens=predictor.args.src_length,
    )
    server.run(port=port)


def main(argv: Optional[List[str]] = None, device="cuda"):
    parser = PdArgumentParser((PredictorArgument,))
    (args, remaining) = parser.parse_args_into_dataclasses(argv, return_remaining_strings=True)
    port, api = 8011, "legacy"
    for i, r in enumerate(remaining):
        if r in ("--port", "--api"):
            if i + 1 >= len(remaining):
                raise SystemExit(f"{r} requires a value")
            if r == "--port":
                port = int(remaining[i + 1])
            else:
                api = remaining[i + 1]
    predictor = create_predictor(args, device=device)
    if api == "v1":
        serve_v1(predictor, port)
    else:
        serve(predictor, port)


if __name__ == "__main__":
    main()
