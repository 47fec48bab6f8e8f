"""Observability for the port: metric sinks and metric computations
(``obs.metrics``), host-side phase spans (``obs.spans``), step timing and
profiler annotation (``obs.timing``), trajectory regression
(``obs.regress``) and the per-phase report CLI (``obs.report``).

The flat import surface follows the JAX package's ``repro.obs``::

    from repro_torch import obs
    with obs.SpanRecorder() as rec, obs.span("train.step"):
        ...
"""
from repro_torch.obs.metrics import (JsonlSink, MemorySink, MetricsSink,
                                     NullSink, consensus_error,
                                     frodo_step_metrics, global_norm,
                                     read_jsonl, scalarize, tree_sq_sum,
                                     zeros_like_metrics)
from repro_torch.obs.spans import (PhaseStat, Span, SpanRecorder, aggregate,
                                   device_sync, get_recorder, set_recorder,
                                   span, span_paths, to_chrome_trace,
                                   to_records)
from repro_torch.obs.timing import (ProfileWindow, StepTimer, annotate,
                                    step_annotation, trace_scope)

__all__ = [
    "JsonlSink", "MemorySink", "MetricsSink", "NullSink", "PhaseStat",
    "ProfileWindow", "Span", "SpanRecorder", "StepTimer", "aggregate",
    "annotate", "consensus_error", "device_sync", "frodo_step_metrics",
    "get_recorder", "global_norm", "read_jsonl", "scalarize",
    "set_recorder", "span", "span_paths", "step_annotation",
    "to_chrome_trace", "to_records", "trace_scope", "tree_sq_sum",
    "zeros_like_metrics",
]
