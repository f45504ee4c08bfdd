"""Plain f32 reference of the SmolLM equations (HuggingFaceTB/SmolLM-*):
a decoder-only LM with pre-norm RMSNorm, GQA attention with half-split
RoPE, a SwiGLU MLP without biases and a tied head.

Plain PyTorch, in float32 with TF32 off, no kernel, cache or batching:
every product goes through :meth:`Reference.mm`, so the precision
control (:func:`fp8`) can round both operands of every product to
float8 e4m3, scaled per tensor, and change nothing else.  It imports
nothing of the program, and takes only the weights and inputs the
benchmark drew.

Departures from the published model, shared with the program: RMSNorm's
epsilon is the configuration's (1e-6 as run; the published 1e-5), and
the weights are random, drawn from the seed.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest float8 e4m3fn value


def no_tf32() -> None:
    """f32 products in f32 (PyTorch may otherwise round them to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(x):
    return x


def fp8(x):
    """``x`` rounded to float8 e4m3 after scaling its largest magnitude
    to the format's largest value; the gradient passes straight
    through."""
    xd = x.detach()
    scale = xd.abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - xd)


class Reference:
    """The forward over ``params`` (name -> f32 tensor, the benchmark's
    layouts) with sizes ``s`` (``arch/smollm.py::sizes``)."""

    def __init__(self, s: dict, params: dict, quant=exact):
        self.s, self.p, self.quant = s, params, quant

    def mm(self, a, b):
        return self.quant(a) @ self.quant(b)

    def rmsnorm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.s["eps"]) * scale

    def rope(self, x, positions):
        half = x.shape[-1] // 2
        freq = self.s["theta"] ** (-torch.arange(half, dtype=torch.float32,
                                                 device=x.device) / half)
        ang = positions[:, None].float() * freq  # [T, half]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def block(self, i, x):
        s = self.s
        b, t, d = x.shape
        h, kvh, hd = s["H"], s["KVH"], s["hd"]

        def w(name):
            return self.p[f"blocks.{i}.{name}"]

        y = self.rmsnorm(x, w("ln_attn.scale"))
        q = self.mm(y, w("attn.q").reshape(d, h * hd)).view(b, t, h, hd)
        k = self.mm(y, w("attn.k").reshape(d, kvh * hd)).view(b, t, kvh, hd)
        v = self.mm(y, w("attn.v").reshape(d, kvh * hd)).view(b, t, kvh, hd)
        pos = torch.arange(t, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))  # [B, H, T, hd]
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        o = self.mm(probs, v).transpose(1, 2).reshape(b, t, h * hd)
        x = x + self.mm(o, w("attn.out").reshape(h * hd, d))
        y = self.rmsnorm(x, w("ln_mlp.scale"))
        gate = self.mm(y, w("gate"))
        return x + self.mm(F.silu(gate) * self.mm(y, w("up")), w("down"))

    def hidden(self, tokens, remat=False):
        """Final-norm hidden states [B, T, D] of ``tokens`` [B, T]."""
        x = self.p["embed"][tokens]
        for i in range(self.s["L"]):
            if remat:
                x = checkpoint(self.block, i, x, use_reentrant=False)
            else:
                x = self.block(i, x)
        return self.rmsnorm(x, self.p["ln_f.scale"])

    def logits(self, h):
        return self.mm(h, self.p["embed"].t())

    @torch.no_grad()
    def logits_at(self, ids, rows):
        """f32 logits [len(rows), V] of the sequence ``ids`` (a list) at
        positions ``rows``."""
        dev = self.p["embed"].device
        tokens = torch.tensor([ids], dtype=torch.long, device=dev)
        h = self.hidden(tokens)[0, torch.as_tensor(rows, device=dev)]
        return self.logits(h)


def targets(tokens):
    """Next-token labels and mask: predict token t+1 at position t; the
    last position has no label."""
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def train(s: dict, params: dict, batches, opt: dict, micro: int,
          quant=exact):
    """Take ``len(batches)`` AdamW steps from ``params`` (f32, changed in
    place) on the mean masked next-token cross entropy, the batch summed
    in micro-batches of ``micro`` rows and divided once.  Returns
    (losses, gradient norm of each leaf at step 1, norm of each leaf's
    change over all steps)."""
    names = list(params)
    start = {n: params[n].detach().clone() for n in names}
    for n in names:
        params[n].requires_grad_(True)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    ref = Reference(s, params, quant)
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], None
    for step, tokens in enumerate(batches, start=1):
        labels, mask = targets(tokens)
        denom = mask.sum()
        total = torch.zeros((), device=tokens.device)
        for r in range(0, tokens.shape[0], micro):
            rows = slice(r, r + micro)
            logits = ref.logits(ref.hidden(tokens[rows], remat=True))
            per_tok = F.cross_entropy(logits.flatten(0, 1),
                                      labels[rows].flatten(),
                                      reduction="none")
            part = (per_tok * mask[rows].flatten()).sum() / denom
            part.backward()
            total += part.detach()
            del logits, per_tok, part
        losses.append(total.item())
        with torch.no_grad():
            if step == 1:
                norms = torch.stack([params[n].grad.norm() for n in names])
                grad_norms = dict(zip(names, norms.tolist()))
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n in names:
                p, g = params[n], params[n].grad
                p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom_n = (v[n].sqrt() / math.sqrt(bc2)).add_(eps)
                p.addcdiv_(m[n], denom_n, value=-lr / bc1)
                p.grad = None
    with torch.no_grad():
        norms = torch.stack([(params[n] - start[n]).norm() for n in names])
    return losses, grad_norms, dict(zip(names, norms.tolist()))
