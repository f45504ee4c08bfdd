"""The NRI device injector daemon (a DaemonSet; the JAX package's root
``cmd/nri_device_injector.py``).

Connects to containerd's NRI socket and injects the device nodes a pod
annotates (``devices.gke.io/container.<name>``) at CreateContainer
(ref: nri_device_injector/nri_device_injector.go:56-77); on a GPU node,
``/dev/nvidia<minor>``, ``/dev/nvidiactl`` and ``/dev/nvidia-uvm``
(``nri/injector.py``).  It reconnects with backoff when containerd
restarts.

    python -m container_engine_accelerators_tpu_torch.cmd.nri_device_injector \\
        --nri-socket /var/run/nri/nri.sock
"""

import argparse
import logging
import sys
import time

from container_engine_accelerators_tpu_torch.nri.plugin import (
    DEFAULT_NRI_SOCKET,
    PLUGIN_IDX,
    PLUGIN_NAME,
    DeviceInjectorPlugin,
)
from container_engine_accelerators_tpu_torch.nri.ttrpc import TtrpcError

RECONNECT_DELAY_S = 5.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nri-device-injector")
    parser.add_argument("--nri-socket", default=DEFAULT_NRI_SOCKET)
    parser.add_argument("--plugin-name", default=PLUGIN_NAME)
    parser.add_argument("--plugin-idx", default=PLUGIN_IDX)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("nri_device_injector")

    while True:
        try:
            plugin = DeviceInjectorPlugin(
                socket_path=args.nri_socket,
                plugin_name=args.plugin_name,
                plugin_idx=args.plugin_idx,
            )
            plugin.run()
            log.info("NRI connection closed")
        except (OSError, EOFError, TtrpcError) as e:
            # EOFError: containerd closed mid-handshake; TtrpcError: the
            # registration was refused.  Both call for a retry, not a
            # crash.
            log.warning("NRI connection failed: %s", e)
        time.sleep(RECONNECT_DELAY_S)


if __name__ == "__main__":
    sys.exit(main())
