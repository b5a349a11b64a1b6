"""HTTP front-end over the MicroBatcher + JobQueue (stdlib only).

Endpoints (JSON in/out):
  GET  /healthz              -> {"status": "ok"}
  GET  /metrics              -> Prometheus exposition (serve/metrics.py)
  GET  /v1/models            -> model/registry info (info_fn)
  GET  /v1/stats             -> batcher + job-queue counters
  POST /v1/enhance           -> {"prompts": [...], "max_tokens"?, ...}
                                waits for the coalesced batch; returns
                                {"prompts": [...enhanced...]}
  POST /v1/generate          -> enqueue a generation job; 202 {"job_id"}
  GET  /v1/jobs              -> recent jobs (newest first)
  GET  /v1/jobs/<id>         -> one job record
  DELETE /v1/jobs/<id>       -> cancel a pending job

ThreadingHTTPServer: each request runs on its own thread, so concurrent
POST /v1/enhance callers coalesce into ONE device batch through the
MicroBatcher. Port of ltx_tpu/serve/server.py: the same routes, status
codes, JSON fields and metric labels.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ltx_tpu_torch.serve.batcher import MicroBatcher
from ltx_tpu_torch.serve.jobs import JobQueue
from ltx_tpu_torch.serve.metrics import ServeMetrics

log = logging.getLogger("ltx_tpu_torch")

# sampling params that define an enhance micro-batch's group_key — rows of
# one batched decode must share them (pipeline/enhance.py::enhance_prompts)
ENHANCE_PARAMS = ("max_tokens", "temperature", "seed", "i2v")
ENHANCE_DEFAULTS = {"max_tokens": 512, "temperature": 0.7, "seed": 42,
                    "i2v": False}

MAX_BODY_BYTES = 8 << 20  # request bodies are JSON control-plane, not media
MAX_PROMPTS_PER_REQUEST = 64


def enhance_group_key(payload: dict):
    return tuple(payload[k] for k in ENHANCE_PARAMS)


def validate_enhance_params(params: dict) -> Optional[str]:
    """Bounds/type check BEFORE a payload joins a batch: a malformed value
    must 400 at the door, not throw inside the worker and fail the whole
    coalesced batch (other callers' requests ride in it)."""
    mt = params["max_tokens"]
    if not isinstance(mt, int) or isinstance(mt, bool) or not 1 <= mt <= 4096:
        return "'max_tokens' must be an integer in [1, 4096]"
    t = params["temperature"]
    if isinstance(t, bool) or not isinstance(t, (int, float)) \
            or not 0.0 <= float(t) <= 2.0:
        return "'temperature' must be a number in [0, 2]"
    sd = params["seed"]
    if not isinstance(sd, int) or isinstance(sd, bool) \
            or not 0 <= sd < 2**63:
        return "'seed' must be a non-negative integer"
    if not isinstance(params["i2v"], bool):
        return "'i2v' must be a boolean"
    return None


def _json_bytes(obj) -> bytes:
    return (json.dumps(obj) + "\n").encode()


_KNOWN_ROUTES = frozenset({
    "/healthz", "/metrics", "/v1/metrics", "/v1/models", "/v1/stats",
    "/v1/enhance", "/v1/generate", "/v1/jobs",
})


def _route_label(path: str) -> str:
    """Collapse paths to a CLOSED label set (metrics label cardinality must
    stay bounded; job ids — and arbitrary scanned 404 paths — are not)."""
    if path.startswith("/v1/jobs/"):
        return "/v1/jobs/{id}"
    path = path.split("?", 1)[0]
    return path if path in _KNOWN_ROUTES else "other"


class _Handler(BaseHTTPRequestHandler):
    # instances get .server.ltx_* attributes from make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route to logging, not stderr
        log.debug("serve: %s", fmt % args)

    # --- helpers ---

    def _reply(self, code: int, obj) -> None:
        self._status = code
        body = _json_bytes(obj)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, text: str,
                    ctype: str = "text/plain; version=0.0.4") -> None:
        self._status = code
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _instrumented(self, method: str, handler) -> None:
        m: Optional[ServeMetrics] = getattr(self.server, "ltx_metrics", None)
        self._status = 0
        t0 = time.monotonic()
        try:
            handler()
        finally:
            if m is not None:
                route = _route_label(self.path)
                m.http_requests_total.inc(
                    route=route, method=method, code=str(self._status))
                m.http_request_seconds.observe(
                    time.monotonic() - t0, route=route)

    def _read_json(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n > MAX_BODY_BYTES:
                # reject without reading; the unread body corrupts the
                # keep-alive framing, so drop the connection after replying
                self.close_connection = True
                self._reply(413, {"error": f"body exceeds {MAX_BODY_BYTES} "
                                           "bytes"})
                return None
            raw = self.rfile.read(n) if n else b""
            obj = json.loads(raw) if raw else {}
        except (ValueError, json.JSONDecodeError):
            self._reply(400, {"error": "body must be valid JSON"})
            return None
        if not isinstance(obj, dict):
            self._reply(400, {"error": "body must be a JSON object"})
            return None
        return obj

    # --- routes ---

    def do_GET(self):  # noqa: N802 (http.server API)
        self._instrumented("GET", self._do_get)

    def do_POST(self):  # noqa: N802
        self._instrumented("POST", self._do_post)

    def do_DELETE(self):  # noqa: N802
        self._instrumented("DELETE", self._do_delete)

    def _do_get(self):
        srv = self.server
        if self.path == "/healthz":
            return self._reply(200, {"status": "ok"})
        if self.path in ("/metrics", "/v1/metrics"):
            m = getattr(srv, "ltx_metrics", None)
            if m is None:
                return self._reply(404, {"error": "metrics disabled"})
            return self._reply_text(200, m.registry.render())
        if self.path == "/v1/models":
            try:
                return self._reply(200, srv.ltx_info_fn())
            except Exception as e:  # noqa: BLE001
                return self._reply(500, {"error": str(e)})
        if self.path == "/v1/stats":
            stats = {"jobs": srv.ltx_jobs.stats()}
            if srv.ltx_batcher is not None:
                stats["enhance"] = srv.ltx_batcher.stats()
            return self._reply(200, stats)
        if self.path == "/v1/jobs":
            return self._reply(200, {"jobs": srv.ltx_jobs.list_jobs()})
        if self.path.startswith("/v1/jobs/"):
            job = srv.ltx_jobs.get(self.path[len("/v1/jobs/"):])
            if job is None:
                return self._reply(404, {"error": "no such job"})
            return self._reply(200, job)
        return self._reply(404, {"error": f"no route {self.path}"})

    def _do_post(self):
        srv = self.server
        if self.path == "/v1/enhance":
            if srv.ltx_batcher is None:
                return self._reply(503, {"error": "enhancement not loaded"})
            body = self._read_json()
            if body is None:
                return
            prompts = body.get("prompts")
            if (not isinstance(prompts, list) or not prompts
                    or not all(isinstance(p, str) and p for p in prompts)):
                return self._reply(
                    400, {"error": "'prompts' must be a non-empty list of "
                                   "non-empty strings"})
            if len(prompts) > MAX_PROMPTS_PER_REQUEST:
                return self._reply(
                    400, {"error": f"at most {MAX_PROMPTS_PER_REQUEST} "
                                   "prompts per request"})
            params = dict(ENHANCE_DEFAULTS)
            for k in ENHANCE_PARAMS:
                if k in body:
                    params[k] = body[k]
            err = validate_enhance_params(params)
            if err:
                return self._reply(400, {"error": err})
            payloads = [{"prompt": p, **params} for p in prompts]
            futs = srv.ltx_batcher.submit_many(payloads)
            try:
                out = [f.result(timeout=srv.ltx_enhance_timeout_s)
                       for f in futs]
            except Exception as e:  # noqa: BLE001 — batch failed
                return self._reply(500, {"error": str(e)})
            return self._reply(200, {"prompts": out})
        if self.path == "/v1/generate":
            body = self._read_json()
            if body is None:
                return
            if not isinstance(body.get("prompt"), str) or not body["prompt"]:
                return self._reply(
                    400, {"error": "'prompt' must be a non-empty string"})
            if srv.ltx_validate_fn is not None:
                err = srv.ltx_validate_fn(body)
                if err:
                    return self._reply(400, {"error": err})
            kind = body.get("kind", "t2v")
            if kind not in ("t2v", "i2v", "v2v", "extend", "keyframes",
                            "chain", "two_stage", "audio",
                            "audio_two_stage"):
                return self._reply(400, {"error": f"unknown kind {kind!r}"})
            job_id = srv.ltx_jobs.submit(kind, body)
            return self._reply(202, {"job_id": job_id})
        return self._reply(404, {"error": f"no route {self.path}"})

    def _do_delete(self):
        if self.path.startswith("/v1/jobs/"):
            ok = self.server.ltx_jobs.cancel(self.path[len("/v1/jobs/"):])
            if not ok:
                return self._reply(409, {"error": "not cancellable"})
            return self._reply(200, {"cancelled": True})
        return self._reply(404, {"error": f"no route {self.path}"})


def make_server(
    jobs: JobQueue,
    batcher: Optional[MicroBatcher] = None,
    info_fn: Callable[[], dict] = lambda: {},
    validate_fn: Optional[Callable[[dict], Optional[str]]] = None,
    host: str = "127.0.0.1",
    port: int = 8571,
    enhance_timeout_s: float = 600.0,
    metrics: Optional[ServeMetrics] = None,
) -> ThreadingHTTPServer:
    """Build (don't start) the HTTP server. Call .serve_forever() on a
    thread; .shutdown() + .server_close() to stop. port=0 binds an
    ephemeral port (tests). `metrics` (serve/metrics.py) enables /metrics;
    queue-depth gauges are registered here since this layer owns both
    components."""
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    # socketserver.shutdown() DEADLOCKS unless serve_forever() is running
    # (stdlib docstring); track whether it ever started so close() on a
    # built-but-never-served app doesn't hang.
    srv.ltx_serving = False
    _orig_serve = srv.serve_forever

    def _serve_forever(*a, **kw):
        srv.ltx_serving = True
        return _orig_serve(*a, **kw)

    srv.serve_forever = _serve_forever
    srv.ltx_jobs = jobs
    srv.ltx_batcher = batcher
    srv.ltx_info_fn = info_fn
    srv.ltx_validate_fn = validate_fn
    srv.ltx_enhance_timeout_s = enhance_timeout_s
    srv.ltx_metrics = metrics
    if metrics is not None:
        metrics.gauge("ltx_jobs_queued", "Generation jobs waiting",
                      lambda: jobs.stats()["queued"])
        if batcher is not None:
            metrics.gauge("ltx_enhance_pending", "Enhance rows waiting",
                          lambda: batcher.stats()["pending"])
    return srv


def serve_forever_threaded(srv: ThreadingHTTPServer) -> threading.Thread:
    # set the flag BEFORE the thread starts so a close() racing the thread
    # still calls shutdown() (serve_forever exits promptly once entered —
    # it checks the shutdown request every poll interval)
    srv.ltx_serving = True
    t = threading.Thread(target=srv.serve_forever, name="ltx-http",
                         daemon=True)
    t.start()
    return t
