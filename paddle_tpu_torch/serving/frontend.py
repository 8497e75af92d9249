"""HTTP front door of the serving stack (the port's copy of
``paddle_tpu/serving/frontend.py``).

A ``ThreadingHTTPServer`` on a daemon thread, JSON in and out, in front
of a `Router` (or a bare engine; both call surfaces are duck-typed):

  POST /v1/generate   {"prompt": [ids], "max_new_tokens": n,
                       "eos_id"?, "tenant"?, "timeout_s"?}
                      → {"tokens": [ids]} through the decode lane
                      (the router's failover and retry underneath)
  POST /v1/infer      {"model": m, "feed": {name: nested lists},
                       "tenant"?, "timeout_s"?}
                      → {"outputs": {name: nested lists}} through the
                      stateless lane (hedging underneath)
  GET  /healthz       {"ok": true|false, "draining": ...}; 503 while
                      draining, a load balancer's out-of-rotation cue
  GET  /routerz       the router's replica table

Typed serving errors map onto HTTP statuses (`_error_status`):
ServingOverloadError → 429 (503 for ``draining`` / ``closed``),
ServingDeadlineError → 504, FeedValidationError / ValueError → 400,
ModelNotLoadedError → 404, anything else → 500.

Drain order (``drain()``; ``install_drain()`` runs it on SIGTERM): stop
admission (new requests get 503), drain the replicas (in-flight
sequences finish, queued futures fail typed), wait for open connections
to write their responses, and only then close the listener and let the
handler chain re-deliver the signal.  A client mid-request at SIGTERM
gets its tokens, not a reset connection.
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time

import numpy as np

from paddle_tpu_torch.distributed import resilience as _resilience
from paddle_tpu_torch.observability import reqtrace as _reqtrace

from .errors import (FeedValidationError, ModelNotLoadedError,
                     ServingDeadlineError, ServingError,
                     ServingOverloadError)

__all__ = ["Frontend"]

_DEFAULT_TIMEOUT_S = 600.0


def _error_status(exc):
    """Typed serving error → HTTP status (the admission contract on the
    wire)."""
    if isinstance(exc, ServingOverloadError):
        return 503 if exc.reason in ("draining", "closed") else 429
    if isinstance(exc, ServingDeadlineError):
        return 504
    if isinstance(exc, (FeedValidationError, ValueError)):
        return 400
    if isinstance(exc, ModelNotLoadedError):
        return 404
    return 500


def _error_body(exc):
    body = {"error": type(exc).__name__, "message": str(exc)}
    reason = getattr(exc, "reason", None)
    if reason:
        body["reason"] = reason
    return body


class Frontend:
    """One HTTP listener over a router (or bare engine).

    ``backend``: a `Router` (decode `submit` + stateless `submit_feed`),
    a `DecodeEngine` (generate only), or an `Engine` (infer only).
    ``port=0`` binds an ephemeral port (tests); read `.port` after
    construction.  The server thread is a daemon; `close()` (or the
    drain path) shuts it down deterministically."""

    def __init__(self, backend, host="127.0.0.1", port=0,
                 name="frontend", auto_start=True):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        self.backend = backend
        self.name = name
        self._draining = False
        self._closed = False
        self._lock = threading.Lock()
        self._inflight = 0
        self._idle = threading.Event()
        self._idle.set()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request spam
                pass

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                trace = (payload.get("trace")
                         if isinstance(payload, dict) else None)
                if trace:
                    # echo the request's trace id (minted or joined) so
                    # a client can fetch it from /tracez by id
                    self.send_header("x-pt-trace", str(trace))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    code, payload = frontend._handle_get(self.path)
                    self._send(code, payload)
                except BrokenPipeError:
                    # client hung up mid-response; nothing left to write to
                    _resilience.record("frontend_client_disconnects")
                except Exception as e:
                    self._send(500, _error_body(e))

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length) if length else b""
                    code, payload = frontend._handle_post(
                        self.path, raw, headers=self.headers)
                    self._send(code, payload)
                except BrokenPipeError:
                    # client hung up mid-response; nothing left to write to
                    _resilience.record("frontend_client_disconnects")
                except Exception as e:
                    self._send(500, _error_body(e))

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"pt-frontend-{name}")
        if auto_start:
            self._thread.start()

    # -- request handling ---------------------------------------------------

    def _handle_get(self, path):
        path = path.split("?", 1)[0]
        if path == "/healthz":
            with self._lock:
                draining = self._draining
            code = 503 if draining or self._closed else 200
            return code, {"ok": code == 200, "draining": draining,
                          "frontend": self.name}
        if path == "/routerz":
            stats = getattr(self.backend, "stats", None)
            if stats is None:
                return 404, {"error": "backend has no stats surface"}
            return 200, stats()
        return 404, {"error": f"no such path {path!r}",
                     "paths": ["/healthz", "/routerz", "/v1/generate",
                               "/v1/infer"]}

    def _admit(self):
        """Admission edge shared by every POST: 503 while draining (the
        typed reject the drain contract promises), else count the
        request in flight so drain can wait for open connections."""
        with self._lock:
            if self._draining or self._closed:
                raise ServingOverloadError(
                    f"frontend {self.name!r} is draining — resubmit to "
                    f"another replica group", reason="draining")
            self._inflight += 1
            self._idle.clear()

    def _release(self):
        with self._lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    def _handle_post(self, path, raw, headers=None):
        path = path.split("?", 1)[0]
        try:
            body = json.loads(raw.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return 400, {"error": "BadJSON", "message": str(e)}
        if not isinstance(body, dict):
            return 400, {"error": "BadJSON",
                         "message": "request body must be a JSON object"}
        try:
            self._admit()
        except ServingOverloadError as e:
            return _error_status(e), _error_body(e)
        # the frontend is the trace mint: an `x-pt-trace` request header
        # joins an upstream trace, else a fresh id; the root span rides
        # the thread-local attach through the router into the engines
        span = None
        if path in ("/v1/generate", "/v1/infer"):
            span = _reqtrace.start_request(
                "generate" if path == "/v1/generate" else "infer",
                trace_id=(headers.get("x-pt-trace") if headers else None),
                attrs={"frontend": self.name})
        code, error = None, None
        try:
            with _reqtrace.attach(span):
                if path == "/v1/generate":
                    code, payload = self._generate(body)
                elif path == "/v1/infer":
                    code, payload = self._infer(body)
                else:
                    code, payload = 404, {"error": f"no such path {path!r}"}
        except ServingError as e:
            error = e
            code, payload = _error_status(e), _error_body(e)
        except (ValueError, TypeError, KeyError) as e:
            error = e
            code, payload = 400, _error_body(e)
        except (TimeoutError, concurrent.futures.TimeoutError) as e:
            # 3.10: futures.TimeoutError is NOT the builtin alias yet
            error = e
            code, payload = 504, {"error": "Timeout", "message": str(e)}
        except BaseException as e:
            error = e
            raise
        finally:
            self._release()
            if span is not None:
                if error is None:
                    span.finish("ok", http_status=code)
                else:
                    span.finish("error", error=error,
                                http_status=code if code else 500)
        if span is not None and isinstance(payload, dict):
            payload["trace"] = span.trace_id
        return code, payload

    def _generate(self, body):
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise ValueError("generate: 'prompt' must be a non-empty "
                             "list of token ids")
        max_new = int(body.get("max_new_tokens", 16))
        timeout_s = float(body.get("timeout_s", _DEFAULT_TIMEOUT_S))
        submit = getattr(self.backend, "submit", None)
        if submit is None:
            raise ModelNotLoadedError(
                "backend has no decode surface (submit)")
        t0 = time.monotonic()
        fut = submit(prompt, max_new,
                     eos_id=body.get("eos_id"),
                     tenant=str(body.get("tenant", "default")))
        try:
            tokens = fut.result(timeout=timeout_s)
        except (TimeoutError, concurrent.futures.TimeoutError):
            fut.cancel()
            raise ServingDeadlineError(
                f"generate did not finish within {timeout_s}s")
        return 200, {"tokens": [int(t) for t in tokens],
                     "latency_s": round(time.monotonic() - t0, 6)}

    def _infer(self, body):
        model = body.get("model")
        feed_spec = body.get("feed")
        if not model or not isinstance(feed_spec, dict) or not feed_spec:
            raise ValueError("infer: 'model' and a non-empty 'feed' "
                             "object are required")
        timeout_s = float(body.get("timeout_s", _DEFAULT_TIMEOUT_S))
        tenant = str(body.get("tenant", "default"))
        feed = {str(k): np.asarray(v) for k, v in feed_spec.items()}
        t0 = time.monotonic()
        submit_feed = getattr(self.backend, "submit_feed", None)
        if submit_feed is not None:
            fut = submit_feed(model, feed, tenant=tenant)
        else:
            fut = self.backend.submit(model, feed, tenant=tenant)
        try:
            out = fut.result(timeout=timeout_s)
        except (TimeoutError, concurrent.futures.TimeoutError):
            fut.cancel()
            raise ServingDeadlineError(
                f"infer did not finish within {timeout_s}s")
        return 200, {"outputs": {k: np.asarray(v).tolist()
                                 for k, v in out.items()},
                     "latency_s": round(time.monotonic() - t0, 6)}

    # -- lifecycle / drain --------------------------------------------------

    def start(self):
        if not self._thread.is_alive():
            self._thread.start()
        return self

    def drain(self, timeout=30.0):
        """The SIGTERM drain contract, in order: (1) stop admission —
        new requests get a typed 503; (2) drain every replica engine —
        in-flight batches/sequences finish, queued futures fail typed;
        (3) wait for open HTTP connections to write their responses;
        (4) close the listener.  Engines stay open (the caller snapshots
        / LEAVEs before close).  Idempotent; returns True when the
        in-flight work finished inside `timeout`."""
        with self._lock:
            if self._closed:
                return True
            already = self._draining
            self._draining = True
        deadline = time.monotonic() + max(float(timeout), 0.0)
        if not already:
            for eng in self._engines():
                drain = getattr(eng, "drain", None)
                if drain is None:
                    continue
                remaining = max(deadline - time.monotonic(), 0.0)
                try:
                    drain(timeout=remaining)
                except TypeError:
                    drain()  # Engine.drain() takes no timeout
        ok = self._idle.wait(timeout=max(deadline - time.monotonic(),
                                         0.0))
        self._shutdown_listener()
        return ok

    def _engines(self):
        reps = getattr(self.backend, "replicas", None)
        if reps is not None:
            return [r.engine for r in reps()]
        return [self.backend]

    def _shutdown_listener(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def close(self):
        """Immediate teardown (tests / non-drain exits).  The drain
        path calls `_shutdown_listener` itself, last."""
        self._shutdown_listener()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def install_drain(self, timeout=30.0, poll_s=0.1):
        """Chained-DrainHandler path for the frontend process: install
        the process `elastic.DrainHandler` (idempotent — chains any
        previously installed handlers) and a watcher thread that, when
        SIGTERM lands, runs the full drain ordering above and then
        `handler.finish()` — drain marker, handler restore, signal
        re-delivery.  Returns the handler."""
        from paddle_tpu_torch.distributed import elastic

        handler = elastic.install_drain_handler()

        def _watch():
            while not handler.requested.wait(timeout=poll_s):
                with self._lock:
                    if self._closed:
                        return  # frontend closed without a signal
            self.drain(timeout=timeout)
            handler.finish()

        t = threading.Thread(target=_watch, daemon=True,
                             name=f"pt-frontend-drain-{self.name}")
        t.start()
        return handler

    def stats(self):
        with self._lock:
            return {
                "frontend": self.name,
                "host": self.host,
                "port": self.port,
                "draining": self._draining,
                "closed": self._closed,
                "inflight": self._inflight,
            }
