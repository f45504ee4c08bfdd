"""The pieces of the JAX package's ``scheduler/`` the node agent needs,
copied so that the port imports nothing of the JAX package: a small
Kubernetes client (``k8s.py``) and the GCE metadata fetcher
(``labeler.py``)."""
