"""cmd/partition_gpu.py, the MIG partitioner, driven through a fake
``nvidia-smi`` that keeps a node's MIG state in a JSON file and records
every command: the nine cases of tests/test_partition_tpu_cli.py with GPU
semantics, and the exact command sequences for MIG off, for MIG on with a
stale layout, and for a re-run that is already programmed."""

import json
import os
import sys

import pytest

from container_engine_accelerators_tpu_torch.cmd import partition_gpu

# The card's MIG profiles as `nvidia-smi mig -lgip` lists them:
# size -> (profile id, most instances).
H100_80GB = {"1g.10gb": (19, 7), "1g.10gb+me": (20, 1), "1g.20gb": (15, 4),
             "2g.20gb": (14, 3), "3g.40gb": (9, 2), "4g.40gb": (5, 1),
             "7g.80gb": (0, 1)}
A100_40GB = {"1g.5gb": (19, 7), "1g.5gb+me": (20, 1), "2g.10gb": (14, 3),
             "3g.20gb": (9, 2), "4g.20gb": (5, 1), "7g.40gb": (0, 1)}

FAKE_SMI = r'''#!{python}
"""A fake nvidia-smi over a JSON node state (FAKE_SMI_STATE)."""
import json, os, sys

path = os.environ["FAKE_SMI_STATE"]
state = json.load(open(path))
args = sys.argv[1:]
state["log"].append(" ".join(args))
gpus = state["gpus"]
on = [g for g in gpus if g["current"] == "Enabled"]


def done(rc=0, out=""):
    json.dump(state, open(path, "w"))
    sys.stdout.write(out)
    sys.exit(rc)


if any(a in state.get("fail", []) for a in args):
    done(1, "Failed: Insufficient Resources\n")
if args[:1] and args[0].startswith("--query-gpu="):
    done(0, "".join(f"{{g['index']}}, {{g['current']}}, {{g['pending']}}\n"
                    for g in gpus))
if len(args) == 4 and args[0] == "-i" and args[2:] == ["-mig", "1"]:
    g = gpus[int(args[1])]
    g["pending"] = "Enabled"
    if not g.get("reset_needed"):
        g["current"] = "Enabled"
    done(0, f"Enabled MIG Mode for GPU {{args[1]}}\n")
if args[:1] != ["mig"]:
    done(1, "unknown command\n")
if args[1:] == ["-lgip"]:
    rows = "".join(
        f"|  {{g['index']:2d}}  MIG {{name:<13s}} {{pid:3d}}     {{n}}/{{n}}"
        f"        9.75       No     16     1     0   |\n"
        for g in on for name, (pid, n) in g["profiles"].items())
    done(0, "| GPU instance profiles:   |\n|=====|\n" + rows)
if args[1:] == ["-lgi"]:
    if not on:
        done(0, "No MIG-enabled devices found.\n")
    rows = "".join(f"|  {{g['index']:2d}}  MIG x   {{pid:3d}}   {{k + 1:3d}}   "
                   f"{{k}}:1     |\n" for g in on
                   for k, pid in enumerate(g["instances"]))
    if not rows:
        done(6, "No GPU instances found: Not Found\n")
    done(0, "| GPU instances:  |\n|=====|\n" + rows)
if args[1:] in (["-dci"], ["-dgi"]):
    if not any(g["instances"] for g in on):
        done(6, "No GPU instances found: Not Found\n")
    if args[1] == "-dgi":
        for g in on:
            g["instances"] = []
    done(0, "Successfully destroyed\n")
if len(args) == 4 and args[1] == "-cgi" and args[3] == "-C":
    for g in on:
        g["instances"] += [int(p) for p in args[2].split(",")]
    done(0, "Successfully created\n")
done(1, "unknown command\n")
'''


class Node:
    """The fake nvidia-smi and its node state."""

    def __init__(self, tmp_path, monkeypatch, gpus=2, mig="Disabled",
                 profiles=H100_80GB, instances=(), reset_needed=False):
        self.tmp = tmp_path
        self.state_path = str(tmp_path / "smi.json")
        self.smi = str(tmp_path / "nvidia-smi")
        with open(self.smi, "w") as f:
            f.write(FAKE_SMI.format(python=sys.executable))
        os.chmod(self.smi, 0o755)
        monkeypatch.setenv("FAKE_SMI_STATE", self.state_path)
        self.write({"log": [], "gpus": [
            {"index": i, "current": mig, "pending": mig,
             "reset_needed": reset_needed, "profiles": profiles,
             "instances": list(instances)} for i in range(gpus)]})
        self.config = str(tmp_path / "gpu_config.json")
        self.pending = str(tmp_path / "state" / "mig_pending.json")
        self.proc = str(tmp_path / "proc")

    def write(self, state):
        with open(self.state_path, "w") as f:
            json.dump(state, f)

    def read(self):
        with open(self.state_path) as f:
            return json.load(f)

    def configure(self, obj):
        with open(self.config, "w") as f:
            json.dump(obj, f)

    def run(self, *extra, size=None, smi=None):
        if size is not None:
            self.configure({"GPUPartitionSize": size})
        return partition_gpu.main([
            "--gpu-config", self.config, "--nvidia-smi-path", smi or self.smi,
            "--state-file", self.pending, "--proc-root", self.proc, *extra])

    def commands(self):
        """What the tool ran since the last call, and forget it."""
        state = self.read()
        log, state["log"] = state["log"], []
        self.write(state)
        return log

    def set_boot_id(self, value):
        d = os.path.join(self.proc, "sys/kernel/random")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "boot_id"), "w") as f:
            f.write(value + "\n")


QUERY = "--query-gpu=index,mig.mode.current,mig.mode.pending --format=csv,noheader"


@pytest.fixture
def node(tmp_path, monkeypatch):
    return lambda **kw: Node(tmp_path, monkeypatch, **kw)


def test_no_config_file_is_noop(node):
    n = node()
    assert n.run() == 0
    assert n.commands() == []


def test_empty_partition_size_is_noop(node):
    n = node()
    assert n.run(size="") == 0
    assert n.commands() == []


@pytest.mark.parametrize("config", [{"GPUPartitionSize": "3g.99gb"},
                                    {"GPUSharingConfig": {
                                        "GPUSharingStrategy": "mps"}},
                                    "not json"])
def test_invalid_config_takes_no_action(node, config):
    """partition_gpu.go:88-92: an unparseable config exits 0 untouched."""
    n = node()
    if isinstance(config, dict):
        n.configure(dict(config, GPUPartitionSize=config.get(
            "GPUPartitionSize", "1g.10gb")))
    else:
        with open(n.config, "w") as f:
            f.write(config)
    assert n.run() == 0
    assert n.commands() == []


def test_mig_off_enables_then_creates_the_maximum(node):
    n = node(gpus=2)
    assert n.run(size="1g.10gb") == 0
    assert n.commands() == [
        QUERY, "-i 0 -mig 1", "-i 1 -mig 1", QUERY, "mig -lgip", "mig -lgi",
        "mig -dci", "mig -dgi", "mig -cgi 19,19,19,19,19,19,19 -C",
        "mig -lgi"]
    assert [g["instances"] for g in n.read()["gpus"]] == [[19] * 7] * 2


def test_mig_on_with_a_stale_layout_is_replaced(node):
    n = node(gpus=1, mig="Enabled", instances=[9, 9])
    assert n.run(size="1g.20gb") == 0
    assert n.commands() == [
        QUERY, "mig -lgip", "mig -lgi", "mig -dci", "mig -dgi",
        "mig -cgi 15,15,15,15 -C", "mig -lgi"]
    assert n.read()["gpus"][0]["instances"] == [15] * 4


def test_a_size_the_card_does_not_offer_fails(node):
    """A100 40GB: profile 19 is 1g.5gb there, not 1g.10gb."""
    n = node(gpus=1, mig="Enabled", profiles=A100_40GB, instances=[0])
    assert n.run(size="1g.10gb") == 1
    assert n.commands() == [QUERY, "mig -lgip"]
    assert n.read()["gpus"][0]["instances"] == [0]
    assert n.run(size="1g.5gb") == 0
    assert n.commands()[-2:] == ["mig -cgi 19,19,19,19,19,19,19 -C",
                                 "mig -lgi"]


def test_no_gpus_or_no_binary_fails(node, tmp_path):
    n = node(gpus=0)
    assert n.run(size="3g.40gb") == 1
    assert n.commands() == [QUERY]
    assert n.run(size="3g.40gb", smi=str(tmp_path / "absent")) == 1


def test_rerun_already_programmed_verifies_only_and_relayout(node):
    n = node(gpus=2)
    assert n.run(size="3g.40gb") == 0
    n.commands()
    assert n.run(size="3g.40gb") == 0
    assert n.commands() == [QUERY, "mig -lgip", "mig -lgi"]
    assert n.run(size="7g.80gb") == 0
    assert n.commands() == [QUERY, "mig -lgip", "mig -lgi", "mig -dci",
                            "mig -dgi", "mig -cgi 0 -C", "mig -lgi"]
    assert [g["instances"] for g in n.read()["gpus"]] == [[0], [0]]


def test_a_failed_command_exits_1(node):
    n = node(gpus=1, mig="Enabled")
    state = n.read()
    state["fail"] = ["-cgi"]
    n.write(state)
    assert n.run(size="2g.20gb") == 1
    assert n.commands()[-1] == "mig -cgi 14,14,14 -C"
    n = node(gpus=1)
    state = n.read()
    state["fail"] = ["-mig"]
    n.write(state)
    assert n.run(size="2g.20gb") == 1
    assert n.commands() == [QUERY, "-i 0 -mig 1"]


def test_reboot_to_apply_pending_then_commit(node, monkeypatch):
    """A mode that stays pending until a GPU reset: the boot-id protocol
    of partition_tpu.py."""
    n = node(gpus=1, reset_needed=True)
    rebooted = []
    monkeypatch.setattr(partition_gpu, "reboot_node",
                        lambda: rebooted.append(True) or True)
    # Without --reboot-to-apply: say so, exit 1, record nothing.
    assert n.run(size="1g.10gb") == 1
    assert n.commands() == [QUERY, "-i 0 -mig 1", QUERY]
    assert not os.path.exists(n.pending) and rebooted == []
    # With it: record the pending reboot with the boot id, reboot, exit 1.
    n.set_boot_id("boot-1")
    assert n.run("--reboot-to-apply") == 1
    assert rebooted == [True]
    with open(n.pending) as f:
        assert json.load(f) == {"pendingReboot": True, "bootId": "boot-1",
                                "gpus": [0]}
    # Same boot (the reboot never happened): ask again.
    assert n.run("--reboot-to-apply") == 1
    assert rebooted == [True, True]
    # After the reboot the GPU came up in MIG mode: clear, partition.
    state = n.read()
    state["gpus"][0]["current"] = "Enabled"
    n.write(state)
    n.commands()
    n.set_boot_id("boot-2")
    assert n.run("--reboot-to-apply") == 0
    assert not os.path.exists(n.pending)
    assert n.commands()[-2:] == ["mig -cgi 19,19,19,19,19,19,19 -C",
                                 "mig -lgi"]
    assert rebooted == [True, True]


def test_still_pending_after_a_reboot_stops(node, monkeypatch):
    n = node(gpus=1, reset_needed=True)
    rebooted = []
    monkeypatch.setattr(partition_gpu, "reboot_node",
                        lambda: rebooted.append(True) or True)
    n.set_boot_id("boot-1")
    assert n.run("--reboot-to-apply", size="1g.10gb") == 1
    n.set_boot_id("boot-2")
    assert n.run("--reboot-to-apply") == 1
    assert rebooted == [True]  # no reboot loop
    os.unlink(os.path.join(n.proc, "sys/kernel/random/boot_id"))
    os.unlink(n.pending)
    assert n.run("--reboot-to-apply") == 1  # no boot id: no protocol
    assert rebooted == [True]


def test_parsers_read_the_cards_answers():
    """What the H100 answered with MIG off (nvidia-smi 580.159.03)."""
    lgip_off = ("+-----+\n| GPU instance profiles:  |\n| GPU   Name   ID    "
                "Instances   Memory     P2P    SM    DEC   ENC  |\n|=====|\n")
    assert partition_gpu.parse_profiles(lgip_off) == {}
    assert partition_gpu.parse_instances("No MIG-enabled devices found.\n") == {}
    row = ("|   0  MIG 1g.10gb       19     7/7        9.50       No     16    "
           " 1     0   |\n|                                  1     1     0   |")
    assert partition_gpu.parse_profiles(row) == {0: {"1g.10gb": (19, 7)}}
    lgi = ("|   1  MIG 3g.40gb          9        2          0:4     |\n"
           "|   1  MIG 3g.40gb          9        1          4:4     |\n")
    assert partition_gpu.parse_instances(lgi) == {1: [9, 9]}


def test_the_profile_table_is_the_references():
    assert partition_gpu.PROFILE_IDS == {
        "1g.5gb": 19, "2g.10gb": 14, "3g.20gb": 9, "4g.20gb": 5,
        "7g.40gb": 0, "1g.10gb": 19, "1g.20gb": 15, "2g.20gb": 14,
        "3g.40gb": 9, "4g.40gb": 5, "7g.80gb": 0}
    for size, (pid, most) in H100_80GB.items():
        if "+" not in size:
            assert partition_gpu.PROFILE_IDS[size] == pid
            assert partition_gpu.PARTITION_MAX_COUNT[size] == most
