"""The numbers that decide ``correct``, each a gap between what the
program produced and what the plain reference gives.

Training: the worst relative gap of a step's loss, and by the worst leaf
the gap between the program's norm and the reference's of the first
gradient and of the parameters' change over the checked steps, each
measured against the larger of that leaf's reference norm and the median
leaf's.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of both.

Serving: at each served token, the gap by which its reference logit
lies below the reference's best at that position; compared are the
widest gap and the mean gap over the checked tokens.  The widest catches
a token altered outright; the mean, which grows with how often and how
far the program's rounding flips a near tie, tells the configuration's
bf16 from a lower precision.
"""

import statistics

import torch

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median's


def loss_gap(program, reference) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def kept_leaves(ref_grads: dict):
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= NEGLIGIBLE * med]


def leaf_gap(program: dict, reference: dict, kept) -> tuple:
    """(worst gap, its leaf) over the ``kept`` leaves."""
    med = statistics.median(reference[n] for n in kept)
    return max((abs(program[n] - reference[n]) / max(reference[n], med), n)
               for n in kept)


def token_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far below the reference's best each token's logit lies, at
    each row."""
    idx = torch.as_tensor(tokens, device=ref_logits.device)
    picked = ref_logits.gather(1, idx[:, None])[:, 0]
    return ref_logits.max(-1).values - picked


def serve_numbers(gaps) -> dict:
    """The widest and the mean of the per-request token gaps."""
    if not gaps:
        return {"logit_gap": 0.0, "mean_gap": 0.0}
    g = torch.cat(gaps)
    return {"logit_gap": g.max().item(), "mean_gap": g.mean().item()}
