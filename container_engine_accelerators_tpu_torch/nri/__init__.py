"""The NRI device injector for GPU nodes: a containerd NRI plugin.

Pods annotate ``devices.gke.io/container.<name>`` with a device list, and
the plugin injects those device nodes at CreateContainer, with no device
plugin involved (ref: nri_device_injector/nri_device_injector.go).  On a
GPU node the nodes are ``/dev/nvidia<minor>``, ``/dev/nvidiactl``,
``/dev/nvidia-uvm`` and, for MIG, ``/dev/nvidia-caps/nvidia-cap<m>``.

The wire stack (the mux, ttrpc and the NRI protobuf) is written here
because containerd's client libraries are Go only; its constants follow
github.com/containerd/{nri,ttrpc}.  A copy of the JAX package's ``nri/``,
so that the port imports nothing of the JAX package.
"""

from container_engine_accelerators_tpu_torch.nri.injector import (
    CTR_DEVICE_KEY_PREFIX,
    get_devices,
    to_linux_device,
)

__all__ = ["CTR_DEVICE_KEY_PREFIX", "get_devices", "to_linux_device"]
