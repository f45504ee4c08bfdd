"""The PyTorch port's checkpointer (``models/checkpoint.py``) and the
retry budget and fault sites it rides on (``utils/retry.py``,
``utils/faults.py``, copies of the JAX package's modules) on the CPU.

Every checkpoint lands under pytest's ``tmp_path``."""

import os

import pytest
import torch

from container_engine_accelerators_tpu.utils import faults as jfaults
from container_engine_accelerators_tpu.utils import retry as jretry
from container_engine_accelerators_tpu_torch.models import checkpoint
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    SAVE_RETRY,
    TrainCheckpointer,
)
from container_engine_accelerators_tpu_torch.models.lm_train import (
    create_lm_train_state,
    make_lm_train_step,
    next_token_targets,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

CFG = dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8, mlp_dim=16,
           device="cpu")


def _state(seed=0):
    model = TransformerLM(**CFG)
    return create_lm_train_state(
        model, torch.Generator().manual_seed(seed),
        torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1))


def _train(state, steps, seed=1):
    step_fn, state = make_lm_train_step(None, state)
    toks = torch.randint(0, 61, (2, 16), generator=torch.Generator()
                         .manual_seed(seed))
    labels, mask = next_token_targets(toks)
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, toks, labels, mask)
        losses.append(m["loss"].item())
    return state, losses


@pytest.fixture(autouse=True)
def _no_sleep(monkeypatch):
    """Retries without their backoff sleeps."""
    monkeypatch.setattr(checkpoint, "SAVE_RETRY", RetryPolicy(
        max_attempts=SAVE_RETRY.max_attempts, initial_backoff_s=0.0,
        jitter=0.0))


def test_round_trip_of_params_adamw_state_and_step(tmp_path):
    state, _ = _train(_state(), 3)
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(state)
    fresh = _state(seed=7)
    fresh, step = ck.restore_latest(fresh)
    assert step == 3 and fresh.step == 3
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    want = state.optimizer.state_dict()
    got = fresh.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
            assert got["state"][i][k].dtype == v.dtype
    # AdamW's step counter is a tensor, and it round-trips.
    assert torch.is_tensor(got["state"][0]["step"])
    assert got["state"][0]["step"].item() == 3
    # The restored state trains on exactly as the saved one.
    _, a = _train(state, 2, seed=2)
    _, b = _train(fresh, 2, seed=2)
    assert a == b


def test_restore_latest_on_an_empty_directory(tmp_path):
    state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got, step = TrainCheckpointer(str(tmp_path / "new")).restore_latest(state)
    assert step is None and got is state and state.step == 0
    assert all(torch.equal(v, before[k])
               for k, v in state.model.state_dict().items())


def test_max_to_keep_prunes_old_steps(tmp_path):
    state = _state()
    ck = TrainCheckpointer(str(tmp_path), max_to_keep=3)
    for _ in range(5):
        state, _ = _train(state, 1)
        ck.save(state)
    assert ck.all_steps() == [3, 4, 5] and ck.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    _, step = ck.restore_latest(_state())
    assert step == 5


def test_a_saved_step_is_not_written_again(tmp_path, monkeypatch):
    state, _ = _train(_state(), 2)
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(state)
    writes = []
    monkeypatch.setattr(ck, "_write", lambda *a: writes.append(a))
    ck.save(state)  # the trainer's end-of-run save after an interval save
    assert writes == []


def test_an_armed_save_fault_is_retried_and_lands(tmp_path):
    state, _ = _train(_state(), 2)
    ck = TrainCheckpointer(str(tmp_path))
    with faults.armed("checkpoint.save:fail@1") as inj:
        ck.save(state)
        assert inj.fired("checkpoint.save") == 1
    assert ck.all_steps() == [2]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_a_save_that_always_fails_raises_after_three_attempts(tmp_path):
    state, _ = _train(_state(), 2)
    ck = TrainCheckpointer(str(tmp_path))
    with faults.armed("checkpoint.save:fail@1x*") as inj:
        with pytest.raises(faults.FaultInjectedError):
            ck.save(state)
        assert inj.fired("checkpoint.save") == SAVE_RETRY.max_attempts == 3
    assert ck.all_steps() == []


def test_an_attempt_that_committed_then_raised_is_not_saved_twice(
        tmp_path, monkeypatch):
    state, _ = _train(_state(), 2)
    ck = TrainCheckpointer(str(tmp_path))
    real_write, calls = ck._write, []

    def commit_then_fail(step, st):
        calls.append(step)
        real_write(step, st)
        raise OSError("mount flapped after the rename")

    monkeypatch.setattr(ck, "_write", commit_then_fail)
    ck.save(state)
    assert calls == [2] and ck.all_steps() == [2]
    _, step = ck.restore_latest(_state())
    assert step == 2


def test_a_failed_write_leaves_no_partial_step(tmp_path, monkeypatch):
    """The rename is the commit: a write that dies before it leaves no
    step directory, and the next commit clears its temporary one."""
    state, _ = _train(_state(), 1)
    ck = TrainCheckpointer(str(tmp_path))

    def torn_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError, match="disk full"):
        ck.save(state)
    monkeypatch.undo()
    assert ck.all_steps() == []
    stale = tmp_path / ".tmp-1-999999"
    stale.mkdir()  # a writer that died mid-save
    monkeypatch.setattr(checkpoint, "SAVE_RETRY", RetryPolicy(
        max_attempts=1, jitter=0.0))
    ck.save(state)
    assert sorted(os.listdir(tmp_path)) == ["1"]


@pytest.mark.parametrize("spec", [
    "checkpoint.save:fail@1",
    "dcn.send:fail@3;health.stream:drop@1x2;dcn.connect:fail@1x*",
    "a:conflict@2x3, b:fail",
    "bad;x:nope@1;y:fail@0;z:fail@1x-1;w:fail@2x0;ok:drop@4",
    "",
])
def test_fault_spec_parses_as_the_jax_package_parses_it(spec):
    got = [(r.site, r.mode, r.at, r.times) for r in faults.parse_spec(spec)]
    want = [(r.site, r.mode, r.at, r.times)
            for r in jfaults.parse_spec(spec)]
    assert got == want


def test_fault_injector_fires_on_its_hits():
    inj = faults.FaultInjector.from_spec("s:fail@2x2;t:drop@1x*")
    inj.check("s")
    for _ in range(2):
        with pytest.raises(faults.FaultInjectedError):
            inj.check("s")
    inj.check("s")
    with pytest.raises(faults.InjectedConnectionDrop):
        inj.check("t")
    assert inj.fired("s") == 2 and inj.fired() == 3
    assert issubclass(faults.InjectedConflict, OSError)
    assert faults.InjectedConflict.status == 409


def test_armed_restores_the_previous_injector():
    prev = faults.injector()
    with faults.armed("checkpoint.save:fail@1") as inj:
        assert faults.injector() is inj
        with pytest.raises(OSError):
            faults.check("checkpoint.save")
        faults.check("checkpoint.save")
    assert faults.injector() is prev


def test_retry_policy_matches_the_jax_package():
    kw = dict(max_attempts=4, initial_backoff_s=0.1, max_backoff_s=0.5,
              multiplier=3.0, jitter=0.2)
    port, ref = RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    for attempt in range(5):
        for u in (0.0, 0.5, 1.0):
            assert port.backoff_s(attempt, lambda: u) == \
                ref.backoff_s(attempt, lambda: u)
    slept = []
    assert list(port.attempts(sleep=slept.append)) == [0, 1, 2, 3]
    assert len(slept) == 3
    clock = iter([0.0, 0.0, 10.0])
    short = RetryPolicy(max_attempts=5, initial_backoff_s=1.0, jitter=0.0,
                        deadline_s=2.5)
    assert list(short.attempts(sleep=lambda s: None,
                               monotonic=lambda: next(clock))) == [0, 1]
