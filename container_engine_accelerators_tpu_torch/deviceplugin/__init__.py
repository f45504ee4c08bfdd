"""The kubelet device plugin for ``nvidia.com/gpu``: the manager's
discovery and serve loop (``manager.py``) and its gRPC service
(``service.py``, wired by ``api.py``)."""
