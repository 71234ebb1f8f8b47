"""Request tracing, metrics export and the ops CLI (counterpart of
distributed_faiss_tpu/observability/):

- ``spans``: sampled requests (``DFT_TRACE_SAMPLE``) mint a ``trace_id``
  that rides the CALL frame's meta; each serving stage records a span into
  its process's bounded ``SpanBuffer``, pulled over the ``get_trace_spans``
  op and merged on the client into one timeline.
- ``export``: the perf-stats tree as Prometheus text (histograms as
  cumulative ``_bucket`` series) behind an optional per-rank HTTP listener
  (``DFT_METRICS_PORT``).
- ``dfstat``: the live cluster CLI,
  ``python -m distributed_faiss_tpu_torch.observability.dfstat``.
"""

from distributed_faiss_tpu_torch.observability.export import (  # noqa: F401
    MetricsExporter,
    render_prometheus,
)
from distributed_faiss_tpu_torch.observability.spans import (  # noqa: F401
    SpanBuffer,
    current_trace,
    local_buffer,
    maybe_sample,
    mint_trace_id,
    sample_rate,
)
