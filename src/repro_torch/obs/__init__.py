"""Observability for the port: metric sinks and metric computations
(``obs.metrics``), host-side phase spans (``obs.spans``), step timing and
profiler annotation (``obs.timing``), trajectory regression
(``obs.regress``) and the per-phase report CLI (``obs.report``).

The flat import surface follows the JAX package's ``repro.obs``::

    from repro_torch import obs
    obs.set_sink(obs.JsonlSink("experiments/run.jsonl"))
    obs.record("loss", 0.3, step=7)
    with obs.SpanRecorder() as rec, obs.span("train.step"):
        ...
"""
from repro_torch.obs.metrics import (JsonlSink, MemorySink, MetricsSink,
                                     NullSink, consensus_error,
                                     frodo_step_metrics, get_sink,
                                     global_norm, read_jsonl, record,
                                     scalarize, set_sink, tree_sq_sum,
                                     zeros_like_metrics)
from repro_torch.obs.regress import (MetricDiff, Tolerance,
                                     compare_to_baseline, format_report,
                                     is_timing_metric, load_baseline,
                                     load_trajectories, make_baseline,
                                     write_baseline)
from repro_torch.obs.spans import (PhaseStat, Span, SpanRecorder, aggregate,
                                   device_sync, get_recorder, set_recorder,
                                   span, span_paths, to_chrome_trace,
                                   to_records)
from repro_torch.obs.timing import (ProfileWindow, StepTimer, annotate,
                                    step_annotation, trace_scope)

__all__ = [
    "JsonlSink", "MemorySink", "MetricDiff", "MetricsSink", "NullSink",
    "PhaseStat", "ProfileWindow", "Span", "SpanRecorder", "StepTimer",
    "Tolerance", "aggregate", "annotate", "compare_to_baseline",
    "consensus_error", "device_sync", "format_report", "frodo_step_metrics",
    "get_recorder", "get_sink", "global_norm", "is_timing_metric",
    "load_baseline", "load_trajectories", "make_baseline", "read_jsonl",
    "record", "scalarize", "set_recorder", "set_sink", "span", "span_paths",
    "step_annotation", "to_chrome_trace", "to_records", "trace_scope",
    "tree_sq_sum", "write_baseline", "zeros_like_metrics",
]
