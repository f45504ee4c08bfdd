"""Node GPU configuration: the reference's config tiers
(ref: cmd/nvidia_gpu/nvidia_gpu.go:54-71, pkg/gpu/nvidia/manager.go:68-133;
the JAX package's ``utils/config.py`` with the reference's keys).

Tier 2 is a JSON file the node bootstrap drops at
``/etc/nvidia/gpu_config.json``; tier 3 is env: critical Xid codes from
``XID_CONFIG``.

Schema (the reference's Go-style keys; lowerCamel is accepted too):

    {
      "GPUPartitionSize": "1g.10gb",            # MIG profile
      "GPUSharingConfig": {
        "GPUSharingStrategy": "time-sharing" | "mps",
        "MaxSharedClientsPerGPU": 4
      },
      "MaxTimeSharedClientsPerGPU": 0,         # deprecated
      "HealthCriticalXid": [48]
    }
"""

import dataclasses
import json
import logging
import os
from typing import List, Optional

from container_engine_accelerators_tpu_torch.sharing import SharingStrategy

log = logging.getLogger(__name__)

CONFIG_PATH = "/etc/nvidia/gpu_config.json"
XID_CONFIG_ENV = "XID_CONFIG"

# MIG profiles of the A100 40GB, A100 80GB and H100 80GB.
VALID_PARTITION_SIZES = (
    "1g.5gb", "2g.10gb", "3g.20gb", "4g.20gb", "7g.40gb",
    "1g.10gb", "1g.20gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb",
)


@dataclasses.dataclass
class GPUSharingConfig:
    strategy: SharingStrategy = SharingStrategy.UNDEFINED
    max_shared_clients_per_gpu: int = 0


@dataclasses.dataclass
class GPUConfig:
    """Settings used to configure the GPUs on a node (ref: manager.go:68-84)."""

    partition_size: str = ""
    # Deprecated in favor of sharing (manager.go:71-73).
    max_time_shared_clients_per_gpu: int = 0
    sharing: GPUSharingConfig = dataclasses.field(default_factory=GPUSharingConfig)
    health_critical_xid: List[int] = dataclasses.field(default_factory=list)

    # ---- parsing -----------------------------------------------------------

    @classmethod
    def from_file(cls, path: str = CONFIG_PATH) -> "GPUConfig":
        """Parse the node config JSON.  A missing or empty file is an empty
        config (nvidia_gpu.go:56-59)."""
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            raw = f.read().strip()
        if not raw:
            return cls()
        return cls.from_json(json.loads(raw))

    @classmethod
    def from_json(cls, obj: dict) -> "GPUConfig":
        def pick(d, *keys, default=None):
            for k in keys:
                if k in d:
                    return d[k]
            return default

        sharing_obj = pick(obj, "GPUSharingConfig", "gpuSharingConfig",
                           default={})
        strategy_raw = pick(sharing_obj, "GPUSharingStrategy",
                            "gpuSharingStrategy", default="")
        sharing = GPUSharingConfig(
            strategy=SharingStrategy.parse(strategy_raw)
            if strategy_raw else SharingStrategy.UNDEFINED,
            max_shared_clients_per_gpu=int(pick(
                sharing_obj, "MaxSharedClientsPerGPU",
                "maxSharedClientsPerGpu", default=0)),
        )
        return cls(
            partition_size=pick(obj, "GPUPartitionSize", "gpuPartitionSize",
                                default=""),
            max_time_shared_clients_per_gpu=int(pick(
                obj, "MaxTimeSharedClientsPerGPU",
                "maxTimeSharedClientsPerGpu", default=0)),
            sharing=sharing,
            health_critical_xid=list(pick(obj, "HealthCriticalXid",
                                          "healthCriticalXid", default=[])),
        )

    # ---- defaulting / validation ------------------------------------------

    def add_defaults_and_validate(self) -> None:
        """Defaulting and validation (manager.go:86-111): the deprecated
        max_time_shared_clients_per_gpu wins over the sharing block; a
        strategy needs max clients > 0 and max clients need a strategy."""
        if self.max_time_shared_clients_per_gpu > 0:
            self.sharing.strategy = SharingStrategy.TIME_SHARING
            self.sharing.max_shared_clients_per_gpu = (
                self.max_time_shared_clients_per_gpu)
        elif self.sharing.strategy == SharingStrategy.UNDEFINED:
            if self.sharing.max_shared_clients_per_gpu > 0:
                raise ValueError(
                    "GPU sharing strategy needs to be specified when "
                    "MaxSharedClientsPerGPU > 0")
        elif self.sharing.max_shared_clients_per_gpu <= 0:
            raise ValueError(
                "MaxSharedClientsPerGPU should be > 0 for time-sharing or "
                "mps GPU sharing strategies")

        if self.partition_size and self.partition_size not in VALID_PARTITION_SIZES:
            raise ValueError(
                f"invalid GPUPartitionSize {self.partition_size!r}, "
                f"should be one of {VALID_PARTITION_SIZES}")

    def add_health_critical_xid(self, env: Optional[dict] = None) -> None:
        """Critical Xid codes from the XID_CONFIG env (csv ints), as
        AddHealthCriticalXid (manager.go:113-133).

        A malformed entry is logged and skipped, never raised: one typo in
        the env must not crash-loop the device plugin and take every GPU on
        the node offline.  If no entry parses, the file's codes are kept.
        """
        env = env if env is not None else os.environ
        raw = env.get(XID_CONFIG_ENV, "")
        if not raw:
            return
        codes = []
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                codes.append(int(part))
            except ValueError:
                log.error("ignoring invalid %s entry %r", XID_CONFIG_ENV, part)
        if codes:
            self.health_critical_xid = codes
        else:
            log.error("%s=%r contained no valid codes; keeping %s",
                      XID_CONFIG_ENV, raw, self.health_critical_xid)
