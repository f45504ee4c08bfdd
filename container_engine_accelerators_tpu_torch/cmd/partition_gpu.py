"""One-shot MIG partitioner for GPU nodes (an init container that runs
after the driver installer and before the device plugin; ref:
partition_gpu/partition_gpu.go:81-257, SURVEY §3.7; the counterpart of
the JAX package's root ``cmd/partition_tpu.py``).

    python -m container_engine_accelerators_tpu_torch.cmd.partition_gpu \\
        --gpu-config /etc/nvidia/gpu_config.json \\
        --nvidia-smi-path /usr/local/nvidia/bin/nvidia-smi

1. Read ``GPUPartitionSize`` from the node config.  No file, no size or
   an invalid config: exit 0 and touch nothing (partition_gpu.go:84-97).
2. Read each GPU's MIG mode (``nvidia-smi --query-gpu=index,
   mig.mode.current,mig.mode.pending``); where it is off, enable it
   (``nvidia-smi -i <i> -mig 1``).  A mode that stays pending needs a GPU
   reset: with ``--reboot-to-apply`` the tool reboots the node (SIGRTMIN+5
   to PID 1, partition_gpu.go:209-212) and exits 1, else it exits 1 and
   says so.  The reboot follows the JAX tool's boot-id protocol: the
   state file records the boot id it rebooted from, so a run in the same
   boot asks again, and a run after a reboot that left the mode pending
   stops instead of rebooting for ever.
3. Check the size's profile id (partition_gpu.go:35-50) against the
   card's own ``nvidia-smi mig -lgip``; read the layout
   (``nvidia-smi mig -lgi``).  Already the size's maximum count on every
   GPU: verify only.  Else destroy the compute instances, then the GPU
   instances (``mig -dci``, ``mig -dgi``), and create the maximum count
   of the profile with their compute instances (``mig -cgi <id,...> -C``).
4. Verify with ``nvidia-smi mig -lgi``.

Any ``nvidia-smi`` command that fails makes the tool exit 1.
"""

import argparse
import json
import logging
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.partition.mig import (
    PARTITION_MAX_COUNT,
)
from container_engine_accelerators_tpu_torch.utils.config import (
    CONFIG_PATH,
    GPUConfig,
)

log = logging.getLogger("partition_gpu")

DEFAULT_NVIDIA_SMI = "/usr/local/nvidia/bin/nvidia-smi"
DEFAULT_STATE_FILE = "/var/run/nvidia/mig_pending.json"
# The target is the host's systemd (hostPID), so the host's numbering
# applies: SIGRTMIN (34) + 5 asks systemd for a graceful reboot.
SIGRTMIN = 34
COMMAND_TIMEOUT_S = 300

# MIG profile id of each size (partition_gpu.go:35-50): A100 40GB, then
# A100 80GB and H100 80GB.
PROFILE_IDS = {
    "1g.5gb": 19, "2g.10gb": 14, "3g.20gb": 9, "4g.20gb": 5, "7g.40gb": 0,
    "1g.10gb": 19, "1g.20gb": 15, "2g.20gb": 14, "3g.40gb": 9, "4g.40gb": 5,
    "7g.80gb": 0,
}

_PENDING_KEY = "pendingReboot"
_BOOT_ID_KEY = "bootId"
# Rows of `nvidia-smi mig -lgip`:  |   0  MIG 1g.10gb   19   7/7   9.50 ...
_PROFILE_ROW = re.compile(r"^\|\s+(\d+)\s+MIG\s+(\S+)\s+(\d+)\s+\d+/(\d+)\s")
# Rows of `nvidia-smi mig -lgi`:   |   0  MIG 1g.10gb   19   7   0:1   |
_INSTANCE_ROW = re.compile(r"^\|\s+(\d+)\s+MIG\s+(\S+)\s+(\d+)\s+(\d+)\s+"
                           r"\d+:\d+\s+\|")
_NO_INSTANCES = ("No GPU instances found", "No compute instances found")


class CommandError(RuntimeError):
    """An nvidia-smi command failed."""


def smi(binary: str, *args: str, nothing_ok: bool = False) -> str:
    """Run ``binary args``; its output, or CommandError on a non-zero
    exit (``nothing_ok``: also when it answered that there is no GPU or
    compute instance, as ``mig -lgi`` and ``-dgi`` do with none)."""
    cmd = [binary, *args]
    log.info("running %s", " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=COMMAND_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise CommandError(f"{' '.join(cmd)}: {e}") from None
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if nothing_ok and any(s in out for s in _NO_INSTANCES):
            return out
        raise CommandError(f"{' '.join(cmd)} exited {proc.returncode}: "
                           f"{out.strip()[:500]}")
    return proc.stdout


def mig_modes(binary: str) -> List[Tuple[int, str, str]]:
    """(index, current, pending) of every GPU."""
    out = smi(binary, "--query-gpu=index,mig.mode.current,mig.mode.pending",
              "--format=csv,noheader")
    modes = []
    for line in out.strip().splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) != 3 or not fields[0].isdigit():
            raise CommandError(f"unexpected MIG mode row {line!r}")
        modes.append((int(fields[0]), fields[1], fields[2]))
    return modes


def parse_profiles(text: str) -> Dict[int, Dict[str, Tuple[int, int]]]:
    """``mig -lgip`` -> {gpu: {size: (profile id, most instances)}}."""
    out: Dict[int, Dict[str, Tuple[int, int]]] = {}
    for line in text.splitlines():
        m = _PROFILE_ROW.match(line)
        if m:
            out.setdefault(int(m.group(1)), {})[m.group(2)] = (
                int(m.group(3)), int(m.group(4)))
    return out


def parse_instances(text: str) -> Dict[int, List[int]]:
    """``mig -lgi`` -> {gpu: sorted profile ids of its GPU instances}."""
    out: Dict[int, List[int]] = {}
    for line in text.splitlines():
        m = _INSTANCE_ROW.match(line)
        if m:
            out.setdefault(int(m.group(1)), []).append(int(m.group(3)))
    return {gpu: sorted(ids) for gpu, ids in out.items()}


def read_state(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            state = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        log.warning("unreadable state file %s: %s", path, e)
        return None
    return state if isinstance(state, dict) else None


def write_state(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def read_boot_id(proc_root: str) -> Optional[str]:
    """The kernel's boot id, or None.  The reboot protocol refuses to run
    without it: it is how a later run tells that the reboot happened."""
    try:
        with open(os.path.join(proc_root, "sys/kernel/random/boot_id")) as f:
            return f.read().strip() or None
    except OSError:
        return None


def reboot_node() -> bool:
    """Ask the host's systemd for a graceful reboot; a failure is logged
    (partition_gpu.go:127-129)."""
    try:
        os.kill(1, SIGRTMIN + 5)
        return True
    except OSError as e:
        log.error("failed to trigger the node reboot: %s", e)
        return False


def await_reboot(args, waiting: List[int]) -> int:
    """MIG mode is pending on ``waiting``: reboot under the boot-id
    protocol, or say what is needed.  Always 1: the partitions cannot be
    made before the GPUs reset."""
    state = read_state(args.state_file)
    boot_id = read_boot_id(args.proc_root)
    if (state is not None and state.get(_PENDING_KEY) and boot_id is not None
            and state.get(_BOOT_ID_KEY) != boot_id):
        log.error("MIG mode still pending on GPUs %s after the node "
                  "rebooted; not rebooting again", waiting)
        return 1
    if not args.reboot_to_apply:
        log.error("MIG mode pending on GPUs %s: reset them or reboot the "
                  "node, or run with --reboot-to-apply", waiting)
        return 1
    if boot_id is None:
        log.error("cannot run the reboot protocol: no boot id under %s",
                  args.proc_root)
        return 1
    write_state(args.state_file, {_PENDING_KEY: True, _BOOT_ID_KEY: boot_id,
                                  "gpus": waiting})
    log.info("rebooting the node to enable MIG mode on GPUs %s", waiting)
    reboot_node()
    return 1


def program(binary: str, size: str, gpus: List[int]) -> None:
    """Make every GPU hold the size's maximum count of partitions;
    CommandError when a command fails or the result differs."""
    profile, count = PROFILE_IDS[size], PARTITION_MAX_COUNT[size]
    offered = parse_profiles(smi(binary, "mig", "-lgip"))
    for gpu in gpus:
        have = offered.get(gpu, {}).get(size)
        if have is None or have[0] != profile:
            raise CommandError(
                f"GPU {gpu} does not offer {size} as profile {profile} "
                f"(nvidia-smi mig -lgip: {offered.get(gpu)})")
        if have[1] != count:
            log.warning("GPU %d holds at most %d of %s; creating %d",
                        gpu, have[1], size, count)
    want = {gpu: [profile] * count for gpu in gpus}
    if parse_instances(smi(binary, "mig", "-lgi", nothing_ok=True)) == want:
        log.info("%d x %s already programmed on GPUs %s; verifying only",
                 count, size, gpus)
        return
    log.info("cleaning up existing GPU partitions")
    smi(binary, "mig", "-dci", nothing_ok=True)
    smi(binary, "mig", "-dgi", nothing_ok=True)
    log.info("creating %d partitions of %s on each GPU", count, size)
    smi(binary, "mig", "-cgi", ",".join([str(profile)] * count), "-C")
    got = parse_instances(smi(binary, "mig", "-lgi", nothing_ok=True))
    if got != want:
        raise CommandError(f"verification failed: GPU instances {got}, "
                           f"want {want}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="partition_gpu")
    parser.add_argument("--gpu-config", default=CONFIG_PATH,
                        help="node GPU config JSON (GPUPartitionSize)")
    parser.add_argument("--nvidia-smi-path", default=DEFAULT_NVIDIA_SMI,
                        help="the nvidia-smi binary to drive")
    parser.add_argument("--reboot-to-apply", action="store_true",
                        help="reboot the node when MIG mode stays pending")
    parser.add_argument("--state-file", default=DEFAULT_STATE_FILE,
                        help="where a pending reboot is recorded")
    parser.add_argument("--proc-root", default="/proc",
                        help="where sys/kernel/random/boot_id is read")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    if not os.path.exists(args.gpu_config):
        log.info("no GPU config file, nothing to do")
        return 0
    try:
        config = GPUConfig.from_file(args.gpu_config)
        config.add_defaults_and_validate()
    except (ValueError, OSError) as e:
        log.info("failed to parse the GPU config file, taking no action: %s",
                 e)
        return 0
    if not config.partition_size:
        log.info("no GPU partitions are required, exiting")
        return 0
    binary = args.nvidia_smi_path
    if not os.path.isfile(binary):
        log.error("nvidia-smi not found at %s", binary)
        return 1
    try:
        modes = mig_modes(binary)
        if not modes:
            raise CommandError("nvidia-smi reports no GPU")
        disabled = [i for i, current, pending in modes
                    if current != "Enabled" and pending != "Enabled"]
        for index in disabled:
            log.info("MIG mode is off on GPU %d; enabling it", index)
            smi(binary, "-i", str(index), "-mig", "1")
        if disabled:
            modes = mig_modes(binary)
        waiting = [i for i, current, _ in modes if current != "Enabled"]
        if waiting:
            return await_reboot(args, waiting)
        if read_state(args.state_file) is not None:
            log.info("MIG mode is on after the reboot; clearing %s",
                     args.state_file)
            os.unlink(args.state_file)
        program(binary, config.partition_size, [i for i, _, _ in modes])
    except CommandError as e:
        log.error("%s", e)
        return 1
    log.info("MIG partitions of %s verified on GPUs %s",
             config.partition_size, [i for i, _, _ in modes])
    return 0


if __name__ == "__main__":
    sys.exit(main())
