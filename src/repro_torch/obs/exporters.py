"""Metric/trace exporters: Prometheus text exposition (with a round-
trip parser), a stdlib HTTP endpoint, and a JSONL snapshot writer (port
of ``repro.obs.exporters``; the text is the JAX package's, line for
line).

The HTTP endpoint is what a load test, dashboard, or the ROADMAP's
replica load balancer scrapes::

    /metrics        Prometheus text exposition of the registry
    /snapshot.json  the registry's plain-dict snapshot
    /traces         Chrome trace-event JSON of the tracer's ring buffer
    /healthz        liveness probe: always 200 {"status": "ok"} (what a
                    replica load balancer polls)
    /quality.json   the quality plane's snapshot (live recall + Wilson
                    interval, SLO state, loss funnel, drift) when a
                    ``quality`` provider is attached

``parse_prometheus_text`` exists so tests (and the report CLI) can
assert on the *exported* surface, not on registry internals — the
contract is the text format.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer

_ESC = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _escape(v: str) -> str:
    return "".join(_ESC.get(ch, ch) for ch in str(v))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format v0.0.4.

    Histograms expose cumulative ``_bucket{le=...}`` series plus
    ``_sum`` / ``_count``; gauge callbacks are evaluated here (a
    failing callback drops its sample, never the scrape).
    """
    lines = []
    for fam in registry.collect():
        lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for label_values, child in fam.samples():
            labels = dict(zip(fam.label_names, label_values))
            if fam.kind == "histogram":
                cum = 0
                for edge, c in zip(child.edges, child.counts):
                    cum += c
                    le = dict(labels, le=f"{edge:.6g}")
                    lines.append(f"{fam.name}_bucket{_fmt_labels(le)} "
                                 f"{cum}")
                cum += child.counts[-1]
                le = dict(labels, le="+Inf")
                lines.append(f"{fam.name}_bucket{_fmt_labels(le)} {cum}")
                lines.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                             f"{child.total:.9g}")
                lines.append(f"{fam.name}_count{_fmt_labels(labels)} "
                             f"{child.n}")
            else:
                try:
                    v = child.value
                except Exception:   # noqa: BLE001 — see docstring
                    continue
                lines.append(f"{fam.name}{_fmt_labels(labels)} {v:.9g}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Parse text exposition back into
    ``{name: {"type": ..., "samples": {frozen_labels: value}}}`` where
    ``frozen_labels`` is a sorted tuple of ``(label, value)`` pairs.
    Supports exactly what :func:`prometheus_text` emits (quoted label
    values with ``\\"``/``\\n``/``\\\\`` escapes)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            out.setdefault(name, {"type": kind, "samples": {}})
            continue
        if line.startswith("#"):
            continue
        # <name>{labels} <value>   |   <name> <value>
        if "{" in line:
            name, rest = line.split("{", 1)
            label_str, value_str = rest.rsplit("}", 1)
            labels = []
            i = 0
            while i < len(label_str):
                eq = label_str.index("=", i)
                key = label_str[i:eq]
                assert label_str[eq + 1] == '"'
                j = eq + 2
                buf = []
                while label_str[j] != '"':
                    if label_str[j] == "\\":
                        nxt = label_str[j + 1]
                        buf.append({"n": "\n"}.get(nxt, nxt))
                        j += 2
                    else:
                        buf.append(label_str[j])
                        j += 1
                labels.append((key, "".join(buf)))
                i = j + 2 if j + 1 < len(label_str) \
                    and label_str[j + 1] == "," else j + 1
        else:
            name, value_str = line.rsplit(None, 1)
            labels = []
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in out:
                base = name[:-len(suffix)]
                break
        fam = out.setdefault(base if base in out else name,
                             {"type": "untyped", "samples": {}})
        key = (name, tuple(sorted(labels)))
        fam["samples"][key] = float(value_str)
    return out


def write_jsonl_snapshot(registry: MetricsRegistry, path: str, *,
                         extra: dict | None = None) -> dict:
    """Append one JSON line holding the registry snapshot (plus
    caller-supplied ``extra`` fields, e.g. a benchmark tag). Returns
    the record written."""
    rec = {"unix_time": time.time(), "metrics": registry.snapshot()}
    if extra:
        rec.update(extra)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


class _Handler(BaseHTTPRequestHandler):
    """Serves the registry, tracer and quality callable its server
    carries. A module-level class: a class made inside ``__init__`` would
    sit in a reference cycle (as every class does) holding what it closes
    over, such as an auditor and its index, until the cyclic collector
    runs."""

    def do_GET(self):              # noqa: N802 — stdlib API
        srv = self.server
        if self.path in ("/metrics", "/"):
            body = prometheus_text(srv.registry)
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path == "/snapshot.json":
            body = json.dumps(srv.registry.snapshot())
            ctype = "application/json"
        elif self.path == "/traces" and srv.tracer is not None:
            body = json.dumps(srv.tracer.export_chrome())
            ctype = "application/json"
        elif self.path == "/healthz":
            body = json.dumps({"status": "ok"})
            ctype = "application/json"
        elif self.path == "/quality.json" and srv.quality is not None:
            body = json.dumps(srv.quality())
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        data = body.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):      # silence per-request stderr
        pass


class ObsHTTPServer:
    """Background stdlib HTTP endpoint exposing one registry (and
    optionally one tracer). ``port=0`` binds an ephemeral port —
    read it back from ``.port``. Close with ``.close()`` (or use as a
    context manager)."""

    def __init__(self, registry: MetricsRegistry,
                 tracer: Tracer | None = None, *, host: str = "127.0.0.1",
                 port: int = 0, quality=None):
        self.registry = registry
        self.tracer = tracer
        self.quality = quality   # zero-arg callable -> JSON-able dict
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.registry = registry
        self._httpd.tracer = tracer
        self._httpd.quality = quality
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-exporter", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "ObsHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_exporter(registry: MetricsRegistry,
                   tracer: Tracer | None = None, *,
                   host: str = "127.0.0.1", port: int = 0,
                   quality=None) -> ObsHTTPServer:
    """Start the background metrics/trace HTTP endpoint. ``quality``
    is a zero-arg callable returning a JSON-serializable dict (e.g.
    ``ShadowAuditor.snapshot``), served at ``/quality.json``."""
    return ObsHTTPServer(registry, tracer, host=host, port=port,
                         quality=quality)


__all__ = ["prometheus_text", "parse_prometheus_text",
           "write_jsonl_snapshot", "ObsHTTPServer", "start_exporter"]
