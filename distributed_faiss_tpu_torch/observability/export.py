"""Prometheus text exposition of the perf-stats tree (counterpart of
distributed_faiss_tpu/observability/export.py).

``render_prometheus`` walks the nested dict ``get_perf_stats`` returns and
renders the 0.0.4 text format: a latency summary that carries its raw
histogram (``hist``, from ``LatencyStats.summary(raw=True)``) becomes a
histogram, cumulative ``_bucket{le="..."}`` series over the real bucket
bounds plus ``_sum`` and ``_count``, so ``histogram_quantile`` computes the
percentiles the summaries report; every other numeric leaf becomes a gauge
named by its path; strings, None and other values are skipped. The same
tree renders to the same text as in the JAX package.

``MetricsExporter`` is the optional per-rank listener behind
``DFT_METRICS_PORT`` (0 = off): a single-threaded ``http.server`` answering
``GET /metrics``; ``stop()`` shuts it down and joins its thread.
"""

import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Optional

from distributed_faiss_tpu_torch.utils.tracing import bucket_bounds

logger = logging.getLogger()

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(part) -> str:
    return _NAME_RE.sub("_", str(part))


def _labels_text(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{_sanitize(k)}="{v}"' for k, v in sorted(labels.items())) + "}"


def _is_hist_summary(value) -> bool:
    return (isinstance(value, dict) and isinstance(value.get("hist"), list)
            and "count" in value and "total_s" in value)


def _render_histogram(lines, name, value, labels) -> None:
    lines.append(f"# TYPE {name} histogram")
    cum = 0
    for i, n in enumerate(value["hist"]):
        cum += n
        lab = _labels_text({**labels, "le": f"{bucket_bounds()[i]:.6g}"})
        lines.append(f"{name}_bucket{lab} {cum}")
    lines.append(f"{name}_bucket{_labels_text({**labels, 'le': '+Inf'})} {value['count']}")
    lines.append(f"{name}_sum{_labels_text(labels)} {value['total_s']:.9g}")
    lines.append(f"{name}_count{_labels_text(labels)} {value['count']}")


def render_prometheus(stats: dict, prefix: str = "dft", labels: Optional[dict] = None) -> str:
    """A perf-stats tree as Prometheus text; ``labels`` (e.g. ``{"rank":
    0}``) are stamped onto every series."""
    labels = {k: str(v) for k, v in (labels or {}).items()}
    lines = []

    def walk(path, value):
        if _is_hist_summary(value):
            _render_histogram(lines, prefix + "_" + "_".join(_sanitize(p) for p in path),
                              value, labels)
            return
        if isinstance(value, dict):
            for k, v in value.items():
                # the raw summary's side channels are not metrics
                if k in ("exemplars", "hist", "p99_exemplar"):
                    continue
                walk(path + (k,), v)
            return
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, (int, float)):
            name = prefix + "_" + "_".join(_sanitize(p) for p in path)
            lines.append(f"{name}{_labels_text(labels)} {value:.9g}")

    walk((), stats)
    return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    # the listener is sequential: a scraper that connects and sends nothing
    # is dropped after this long instead of wedging every later scrape
    timeout = 5.0

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] != "/metrics":
            self.send_error(404)
            return
        try:
            body = self.server.exporter.render().encode()
        except Exception:
            logger.exception("metrics render failed")
            self.send_error(500)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not server log events
        pass


class MetricsExporter:
    """Per-rank ``/metrics`` listener. ``stats_fn()`` returns the raw
    perf-stats tree (``get_perf_stats(raw=True)``); ``port=0`` binds a free
    port."""

    def __init__(self, stats_fn: Callable[[], dict], port: int = 0, host: str = "",
                 rank=None):
        self._stats_fn = stats_fn
        self._labels = {} if rank is None else {"rank": rank}
        self._httpd = HTTPServer((host, int(port)), _MetricsHandler)
        self._httpd.exporter = self
        self.port = self._httpd.server_address[1]
        # daemon: a connected scraper never holds process exit; stop() is
        # the orderly path
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics:r{rank if rank is not None else '?'}", daemon=True)

    def render(self) -> str:
        return render_prometheus(self._stats_fn(), labels=self._labels)

    def start(self) -> "MetricsExporter":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            logger.warning("metrics listener thread did not exit in 5s")
