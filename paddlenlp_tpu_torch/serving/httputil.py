"""Shared HTTP handler plumbing for the serving planes.

``serving/api.py`` (single replica) and ``serving/router/proxy.py`` (front
tier) speak the same JSON-over-HTTP dialect: raw/JSON/error senders with
explicit Content-Length, and a body reader enforcing a size cap + JSON-object
validation. One base class keeps the 413/400 semantics from drifting between
the planes.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from typing import Optional

from ..utils.log import logger

__all__ = ["JsonRequestHandler"]


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Base handler: JSON senders + capped body reader.

    Subclasses set ``log_prefix`` and ``max_body_bytes`` (class attributes, so
    the closure-defined handlers in api.py/proxy.py can override per server).
    """

    protocol_version = "HTTP/1.1"
    log_prefix = "http"
    max_body_bytes = 8 << 20

    def log_message(self, fmt, *args):
        logger.debug(f"{self.log_prefix}: " + fmt % args)

    # ------------------------------------------------------------- senders
    def _send_raw(self, code: int, body: bytes, ctype: str,
                  headers: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict, headers: Optional[dict] = None):
        self._send_raw(code, json.dumps(payload).encode(), "application/json",
                       headers=headers)

    def _send_error_json(self, code: int, message: str, etype: str,
                         headers: Optional[dict] = None):
        self._send_json(code, {"error": {"message": message, "type": etype,
                                         "code": code}}, headers=headers)

    # ------------------------------------------------------------- body
    def _read_body(self) -> Optional[dict]:
        """Parse the request body as a JSON object, or send the error and
        return None. Oversized bodies are rejected before reading."""
        n = int(self.headers.get("Content-Length", 0))
        if n < 0:
            # rfile.read(-1) would block until the client closes, pinning the
            # handler thread — a trivially exploitable slow-loris
            self.close_connection = True
            self._send_error_json(400, f"invalid Content-Length {n}", "invalid_request")
            return None
        if n > self.max_body_bytes:
            # rejected before reading: the unread body makes this connection
            # unusable for keep-alive
            self.close_connection = True
            self._send_error_json(
                413, f"body of {n} bytes exceeds limit {self.max_body_bytes}",
                "payload_too_large")
            return None
        raw = self.rfile.read(n) if n else b"{}"
        try:
            payload = json.loads(raw or b"{}")
        except ValueError as e:
            self._send_error_json(400, f"invalid JSON body: {e}", "invalid_request")
            return None
        if not isinstance(payload, dict):
            self._send_error_json(400, "body must be a JSON object", "invalid_request")
            return None
        return payload
