"""The plain reference agrees with the port's plain paths (f32, on the
CPU, at the tiny test size): a training step's loss, gradients and AdamW
update, and the logits of a prefill and of decode steps through the KV
cache."""

import json

import pytest
import torch
from conftest import DATA

from harness import weights

CFG = json.loads((DATA / "configs" / "tiny.json").read_text())
OPT = {"lr": 3e-4, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.1}


@pytest.fixture(scope="module")
def ref():
    from reference import smollm

    return smollm


def port_model(decode):
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    s = weights.sizes(CFG)
    model = TransformerLM(vocab_size=s["V"], num_layers=s["L"],
                          num_heads=s["H"], head_dim=s["hd"], mlp_dim=s["F"],
                          num_kv_heads=s["KVH"], dtype=torch.float32,
                          decode=decode, use_flash=True,
                          use_flash_decode=True, remat=not decode,
                          device="cpu")
    weights.load_into(dict(model.named_parameters()), CFG, 3, "cpu",
                      torch.float32)
    return model


def test_train_step_matches(ref):
    from container_engine_accelerators_tpu_torch.models import lm_train

    s = weights.sizes(CFG)
    tokens = torch.randint(0, s["V"], (4, 32),
                           generator=torch.Generator().manual_seed(1))
    model = port_model(decode=False)
    state = lm_train.create_lm_train_state(model)
    step, state = lm_train.make_lm_train_step(state=state)
    _, metrics = step(state, tokens, *lm_train.next_token_targets(tokens))
    port_grads = {n: state.optimizer.state[p]["exp_avg"].norm().item() / 0.1
                  for n, p in model.named_parameters()}

    start = weights.draw(CFG, 3, "cpu", torch.float32)
    params = {n: t.clone() for n, t in start.items()}
    losses, grads, changes = ref.train(s, params, [tokens], OPT, 2)
    assert losses[0] == pytest.approx(metrics["loss"].item(), rel=1e-5)
    for name, p in model.named_parameters():
        assert grads[name] == pytest.approx(port_grads[name], rel=1e-4), name
        # AdamW's first step moves each element by about lr; elements
        # whose gradient is near eps move by what rounding leaves.
        moved = (p.detach() - start[name]).norm().item()
        assert changes[name] == pytest.approx(moved, rel=1e-3), name
        assert (params[name] - p.detach()).abs().max() < 0.1 * OPT["lr"]


def test_prefill_and_decode_logits_match(ref):
    from container_engine_accelerators_tpu_torch.models.generate import (
        prefill,
    )

    s = weights.sizes(CFG)
    model = port_model(decode=True)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, s["V"], (1, 24), generator=g)
    plen = 19  # the rest is bucket padding
    with torch.no_grad():
        cache, last = prefill(model, ids, plen, 64)
        seq = ids[0, :plen].tolist()
        got = [last[0]]
        for j in range(5):
            tok = int(got[-1].argmax())
            seq.append(tok)
            out = model(torch.tensor([[tok]]),
                        positions=torch.tensor([plen + j]), cache=cache)
            got.append(out[0, 0])
    plain = ref.Reference(s, weights.draw(CFG, 3, "cpu", torch.float32))
    want = plain.logits_at(seq, list(range(plen - 1, len(seq))))
    assert torch.allclose(torch.stack(got), want, atol=1e-4)
