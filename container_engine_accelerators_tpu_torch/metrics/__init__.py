"""The node's GPU metrics: the Prometheus server (``metrics.py``), the
PodResources join (``devices.py``) and the agent's counters
(``counters.py``, stdlib only)."""
