"""Exposition surfaces for the metrics registry (the port's copy of
``paddle_tpu/observability/exposition.py``): the Prometheus text format
with OpenMetrics exemplars, a JSON dump, the strict parser that is the
text format's golden inverse, and a stdlib HTTP endpoint.

The HTTP server is ``http.server`` on a daemon thread, serving:

    /metricsz   Prometheus text exposition of the default registry
    /statusz    JSON process status: identity (pid, role, rank, trace
                id), uptime, the flags, and torch's version and devices
                when torch is already imported (a scrape never
                initializes a device)
    /healthz    200 "ok" liveness probe

plus every page a subsystem registers (``register_page``): ``/servez``
(serving/status.py), ``/routerz`` (serving/router.py), ``/tracez``
(observability/reqtrace.py) and ``/sloz`` (observability/slo.py).

``FLAGS_metrics_port`` (0 = off) starts one server a process through
``ensure_from_flags()``, which the executor calls when it is built.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time
import warnings

from . import metrics as _metrics
from . import tracing

__all__ = ["render_text", "render_json", "parse_text", "MetricsServer",
           "ensure_from_flags", "active_server", "stop_server",
           "register_page", "unregister_page"]

_START_TIME = time.time()


# ---------------------------------------------------------------------------
# text format
# ---------------------------------------------------------------------------


def _escape_label_value(v: str) -> str:
    return (v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"'))


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names, values, extra=()):
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_escape_label_value(str(v))}"'
                    for n, v in pairs)
    return "{" + body + "}"


def render_text(snapshot=None) -> str:
    """Prometheus text exposition of a registry snapshot (default: the
    process registry)."""
    snap = _metrics.snapshot() if snapshot is None else snapshot
    lines = []
    for name, fam in snap.items():
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        label_names = fam.get("label_names", ())
        for values, sample in sorted(fam["samples"].items()):
            if fam["type"] == "histogram":
                exemplars = sample.get("exemplars") or {}
                for le, cum in sample["buckets"]:
                    line = (
                        f"{name}_bucket"
                        f"{_label_str(label_names, values, [('le', _fmt_value(le))])}"
                        f" {cum}")
                    ex = exemplars.get(le)
                    if ex is not None:
                        # OpenMetrics exemplar: `# {labels} value` after
                        # the bucket sample — how a trace id rides the
                        # exposition
                        ex_labels, ex_value = ex
                        body = ",".join(
                            f'{k}="{_escape_label_value(str(v))}"'
                            for k, v in sorted(ex_labels.items()))
                        line += f" # {{{body}}} {_fmt_value(ex_value)}"
                    lines.append(line)
                lines.append(f"{name}_sum{_label_str(label_names, values)}"
                             f" {_fmt_value(sample['sum'])}")
                lines.append(f"{name}_count{_label_str(label_names, values)}"
                             f" {sample['count']}")
            else:
                lines.append(f"{name}{_label_str(label_names, values)}"
                             f" {_fmt_value(sample['value'] if isinstance(sample, dict) else sample)}")
    return "\n".join(lines) + "\n" if lines else ""


def render_json(snapshot=None) -> str:
    snap = _metrics.snapshot() if snapshot is None else snapshot
    out = {}
    for name, fam in snap.items():
        samples = []
        for values, sample in sorted(fam["samples"].items()):
            labels = dict(zip(fam.get("label_names", ()), values))
            if fam["type"] == "histogram":
                samples.append({"labels": labels,
                                "buckets": [[le if not math.isinf(le)
                                             else "+Inf", c]
                                            for le, c in sample["buckets"]],
                                "sum": sample["sum"],
                                "count": sample["count"]})
            else:
                samples.append({"labels": labels, "value": sample})
        out[name] = {"type": fam["type"], "help": fam.get("help", ""),
                     "samples": samples}
    return json.dumps(out, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# parser (the golden-format inverse)
# ---------------------------------------------------------------------------


class ExpositionParseError(ValueError):
    pass


def _parse_labels(body: str, line: str):
    """'a="x",b="y"' -> dict, honoring escapes; strict about syntax."""
    labels = {}
    i, n = 0, len(body)
    while i < n:
        j = body.find("=", i)
        if j < 0:
            raise ExpositionParseError(f"label without '=': {line}")
        name = body[i:j]
        if not name or not all(c.isalnum() or c == "_" for c in name):
            raise ExpositionParseError(f"bad label name {name!r}: {line}")
        if j + 1 >= n or body[j + 1] != '"':
            raise ExpositionParseError(f"label value not quoted: {line}")
        i = j + 2
        val = []
        while True:
            if i >= n:
                raise ExpositionParseError(f"unterminated label: {line}")
            c = body[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ExpositionParseError(f"dangling escape: {line}")
                nxt = body[i + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt))
                if val[-1] is None:
                    raise ExpositionParseError(
                        f"bad escape \\{nxt}: {line}")
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                val.append(c)
                i += 1
        labels[name] = "".join(val)
        if i < n:
            if body[i] != ",":
                raise ExpositionParseError(f"junk after label: {line}")
            i += 1
    return labels


def parse_text(text: str):
    """Strict line-by-line parse of a Prometheus text exposition.

    Returns {metric_name: {"type": ..., "help": ..., "samples":
    [(labels_dict, value)]}} where histogram series appear under their
    ``_bucket``/``_sum``/``_count`` sample names attributed to the base
    family.  Raises ExpositionParseError on any malformed line — the
    golden tests rely on this strictness.
    """
    out = {}

    def family(name):
        return out.setdefault(name, {"type": None, "help": None,
                                     "samples": []})

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not name:
                raise ExpositionParseError(f"line {lineno}: empty HELP name")
            family(name)["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, type_ = rest.partition(" ")
            if type_ not in ("counter", "gauge", "histogram", "summary",
                             "untyped"):
                raise ExpositionParseError(
                    f"line {lineno}: bad TYPE {type_!r}")
            family(name)["type"] = type_
            continue
        if line.startswith("#"):
            continue  # comment
        # OpenMetrics exemplar appendix: `... # {labels} value` after a
        # bucket sample.  Split it off first — the label parse below
        # rpartitions on the LAST '}', which would otherwise be the
        # exemplar's closing brace.
        exemplar = None
        ex_at = line.rfind(" # {")
        if ex_at > 0:
            ex_part = line[ex_at + len(" # "):]
            line = line[:ex_at]
            ex_body, _, ex_val = ex_part.rpartition("}")
            if not ex_body.startswith("{") or not ex_val.strip():
                raise ExpositionParseError(
                    f"line {lineno}: malformed exemplar: {raw}")
            try:
                ex_value = float(ex_val.strip().replace("+Inf", "inf")
                                 .replace("-Inf", "-inf"))
            except ValueError:
                raise ExpositionParseError(
                    f"line {lineno}: bad exemplar value "
                    f"{ex_val.strip()!r}") from None
            exemplar = (_parse_labels(ex_body[1:], raw), ex_value)
        # sample line: name[{labels}] value
        if "{" in line:
            name, _, rest = line.partition("{")
            body, _, valpart = rest.rpartition("}")
            if not valpart.startswith(" "):
                raise ExpositionParseError(
                    f"line {lineno}: missing value: {line}")
            labels = _parse_labels(body, line)
            value_str = valpart.strip()
        else:
            name, _, value_str = line.partition(" ")
            labels = {}
            value_str = value_str.strip()
        if not name or not (name[0].isalpha() or name[0] in "_:"):
            raise ExpositionParseError(
                f"line {lineno}: bad metric name {name!r}")
        try:
            value = float(value_str.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ExpositionParseError(
                f"line {lineno}: bad value {value_str!r}") from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in out:
                base = name[:-len(suffix)]
                labels = dict(labels, __sample__=suffix.lstrip("_"))
                break
        family(base)["samples"].append((labels, value))
        if exemplar is not None:
            # kept beside (not inside) the samples so exemplar-free
            # consumers see the exact legacy shape
            family(base).setdefault("exemplars", []).append(
                (labels, exemplar[0], exemplar[1]))
    return out


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------


def _statusz() -> dict:
    status = dict(tracing.process_identity())
    status["uptime_seconds"] = round(time.time() - _START_TIME, 3)
    status["argv"] = sys.argv
    try:
        from paddle_tpu_torch.fluid import flags as _flags
        status["flags"] = {k: v for k, v in sorted(_flags._VALUES.items())}
    except Exception:
        status["flags"] = {}
    # torch state only when torch is ALREADY imported: a scrape must
    # never be the thing that initializes a device
    th = sys.modules.get("torch")
    if th is not None:
        try:
            status["torch"] = {"version": th.__version__,
                               "cuda": th.version.cuda,
                               "device_count": th.cuda.device_count()}
        except Exception:
            status["torch"] = {"version": getattr(th, "__version__", "?")}
    return status


# subsystem status pages served beside the built-ins on EVERY
# MetricsServer in the process (the serving lane's /servez registers
# here): path -> zero-arg callable returning either (body_bytes,
# content_type) or a JSON-serializable object
_extra_pages: dict = {}
# guards the collision check-then-set below: without it two threads
# registering the same path with different renderers can both pass the
# check and the second overwrite wins silently — the exact undetected
# collision the guard exists to prevent (handlers read single keys,
# which is atomic, so only writers lock)
_pages_lock = threading.Lock()


def register_page(path, render):
    """Register an extra GET page (e.g. ``/servez``) on every exposition
    server in this process.  `render()` returns (body, content_type) —
    body bytes or str — or any JSON-serializable object (rendered
    application/json).  A page raising is a 500 on that request, never a
    server crash.  Registering a second renderer for a live path raises
    (a silent overwrite would vanish the first subsystem's page with
    nothing to detect the collision) — `unregister_page` first to
    replace; re-registering the SAME renderer is an idempotent no-op."""
    if not path.startswith("/"):
        raise ValueError(f"page path must start with '/': {path!r}")
    if path in ("/metricsz", "/metrics", "/metricsz.json", "/statusz",
                "/healthz"):
        raise ValueError(f"{path!r} is a built-in page")
    with _pages_lock:
        existing = _extra_pages.get(path)
        if existing is not None and existing is not render:
            raise ValueError(
                f"page {path!r} is already registered; unregister_page() "
                f"it before installing a different renderer")
        _extra_pages[path] = render


def unregister_page(path):
    with _pages_lock:
        _extra_pages.pop(path, None)


class MetricsServer:
    """Daemon-thread HTTP exposition server.  port=0 binds an ephemeral
    port (tests); the flag path passes an explicit port."""

    def __init__(self, port=0, host="127.0.0.1", registry=None):
        import http.server

        reg = registry or _metrics.REGISTRY

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path in ("/metricsz", "/metrics"):
                    body = render_text(reg.snapshot()).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/statusz":
                    body = json.dumps(_statusz(), indent=1,
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                elif path == "/metricsz.json":
                    body = render_json(reg.snapshot()).encode()
                    ctype = "application/json"
                elif (page := _extra_pages.get(path)) is not None:
                    # single .get(): a concurrent unregister_page between
                    # a membership test and the call would KeyError out
                    # of do_GET instead of 404/500ing the one request
                    try:
                        # serialization stays inside the try: a page
                        # whose RETURN VALUE fails json.dumps (circular
                        # reference, raising __str__) must also 500,
                        # never drop the connection with a traceback
                        out = page()
                        if (isinstance(out, tuple) and len(out) == 2
                                and isinstance(out[1], str)):
                            raw, ctype = out
                        else:
                            raw, ctype = out, "application/json"
                        if isinstance(raw, str):
                            body = raw.encode()
                        elif isinstance(raw, (bytes, bytearray)):
                            body = bytes(raw)
                        else:  # JSON-serializable body, possibly with
                            # an explicit content type alongside it
                            body = json.dumps(raw, indent=1,
                                              default=str).encode()
                    except Exception as e:
                        self.send_error(500, explain=str(e))
                        return
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, int(port)),
                                                      Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            name="pt-metricsz", daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_server = None
_server_lock = threading.Lock()
_failed_port = None  # latched: don't re-bind (and re-warn) the same port


def active_server():
    return _server


def ensure_from_flags():
    """Start the exposition server once per process when
    FLAGS_metrics_port is nonzero.  Never fatal: a taken port warns ONCE
    and latches disabled (two roles on one host must each get their own
    port); changing the flag to a different port retries."""
    global _server, _failed_port
    if _server is not None:
        return _server
    try:
        from paddle_tpu_torch.fluid import flags
        port = int(flags.flag("metrics_port"))
    except Exception:
        return None
    # same construction edge also arms the flag-driven SLO evaluator
    # (FLAGS_slo_specs; no-op when the flag is empty) — one hook, every
    # process that runs a program gets both surfaces
    try:
        from . import slo as _slo

        _slo.ensure_from_flags()
    except Exception:
        pass
    if port <= 0 or port == _failed_port:
        return None
    with _server_lock:
        if _server is None and port != _failed_port:
            try:
                _server = MetricsServer(port=port)
            except OSError as e:
                _failed_port = port
                warnings.warn(
                    f"FLAGS_metrics_port={port}: cannot bind ({e}); "
                    f"metrics endpoint disabled for this process")
                return None
    return _server


def stop_server():
    global _server, _failed_port
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
        _failed_port = None
