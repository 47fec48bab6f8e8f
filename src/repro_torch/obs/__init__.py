"""Observability for the port: metric sinks and metric computations
(``obs.metrics``)."""
