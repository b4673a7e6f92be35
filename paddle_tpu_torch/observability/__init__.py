"""Observability of the port: the decode bundles' device counters
(``devtel``) and the servers' latency histograms (``metrics``)."""
