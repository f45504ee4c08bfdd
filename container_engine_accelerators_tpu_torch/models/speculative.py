"""Speculative decoding: a draft proposes k tokens, the target verifies
them in one forward — counterpart of
``container_engine_accelerators_tpu/models/speculative.py``.

Plain decode re-reads every target weight for each generated token.
Speculative decoding turns k of those reads into one (k+1)-token verify
chunk.  Each round:

1. the draft proposes ``d_1..d_k`` in k+1 single-token steps (the last
   step only writes ``d_k``'s K/V, so the draft cache is complete when
   all k are accepted; it projects no logits);
2. the target runs ONE forward over ``[t_last, d_1..d_k]`` at positions
   ``p0..p0+k``;
3. greedy (:func:`generate_speculative`): the longest prefix of drafts
   equal to the target's argmax is accepted, plus the target's own token
   at the first divergence (or the bonus token after k matches) — the
   output is exactly the target's greedy continuation.  Sampled
   (:func:`generate_speculative_sampled`): ``d_i ~ q`` is accepted with
   probability ``min(1, p(d_i)/q(d_i))`` and the first rejection
   resamples ``normalize(max(p - q, 0))`` — the output is distributed
   exactly as the target's temperature sampling, for any draft;
4. both caches' cursors rewind to the new head: stale slots past it are
   dead, as bucket padding is.

The round (:func:`spec_round`) is shared with the batching engine's
``SpecDecodeEngine``.  Sampled rows draw from their own
``torch.Generator`` in a fixed order — per draft step one [1, V] row,
then one [1, k] uniform, then one [1, V] row for the residual — so a
batch-1 request and an engine lane on the same seed give the same
tokens.  The JAX package's key-split stream cannot be reproduced, so
sampled output matches JAX in distribution only.

**The margin rule.**  Caches hold ``[prefix bucket +] P + N + k + 1``
slots (P the prompt bucket, N the new tokens).  A live row's round writes
at most ``P + N + k - 2``.  flax clamps an out-of-range write, so the
JAX rows that finished keep writing into the tail; the port's cache
write raises past the buffer, so a finished row's round position is
clamped to ``slots - k - 1``: it writes only where the margin covers it,
and its output goes to a tail that is sliced off.
"""

from typing import Optional

import torch

from container_engine_accelerators_tpu_torch.models.generate import (
    _rewind_cache_index,
    init_cache,
    prefill,
    prefill_continue,
    prefix_bucket_len,
    sample_token,
    splice_prefix,
)


def spec_round(model, draft_model, t_cache, d_cache, pos, last_tok, k: int,
               sampled: Optional[dict] = None):
    """One draft/verify round for every row -> (tokens [B, k+1], m [B]).

    Row b's last emitted token ``last_tok[b]`` sits at position
    ``pos[b]``, where both caches' cursors must stand.  The row emits
    ``tokens[b, :m[b] + 1]``: ``m`` accepted drafts, then the target's
    token.  Rows are greedy, except those in ``sampled``, a map row ->
    (generator, temperature) whose rows run the rejection round on their
    own generators.  The caches' cursors end past the round's writes;
    the caller rewinds them.
    """
    b = pos.shape[0]
    dev = pos.device
    sampled = sampled or {}
    tok, drafts, q_rows = last_tok, [], []
    for i in range(k + 1):
        out = draft_model(tok[:, None], positions=(pos + i)[:, None],
                          cache=d_cache, project=i < k)
        if i == k:
            break
        logits = out[:, 0]
        nxt = logits.argmax(-1)
        q_i = {}
        for r, (gen, temp) in sampled.items():
            q_i[r] = torch.softmax(logits[r] / temp, -1)
            nxt[r] = sample_token(logits[r:r + 1], temp, gen)[0]
        q_rows.append(q_i)
        drafts.append(nxt)
        tok = nxt
    drafts = torch.stack(drafts, 1)  # [B, k]
    chunk = torch.cat([last_tok[:, None], drafts], 1)
    steps = torch.arange(k + 1, dtype=pos.dtype, device=dev)
    logits = model(chunk, positions=pos[:, None] + steps, cache=t_cache)
    target = logits.argmax(-1)  # [B, k+1]
    matches = (drafts == target[:, :k]).to(torch.int32)
    residual = {}
    for r, (gen, temp) in sampled.items():
        p = torch.softmax(logits[r] / temp, -1)  # [k+1, V]
        q = torch.stack([q_rows[i][r] for i in range(k)])  # [k, V]
        idx = drafts[r][:, None]
        p_at = p[:k].gather(1, idx)[:, 0]
        q_at = q.gather(1, idx)[:, 0]
        u = torch.rand((1, k), generator=gen, device=dev)[0]
        matches[r] = (u * q_at < p_at).to(torch.int32)
        residual[r] = (p, q, gen)
    m = matches.cumprod(1).sum(1)  # [B]
    nxt = target.gather(1, m[:, None])[:, 0]
    for r, (p, q, gen) in residual.items():
        # q padded with a zero row at index k: an all-accepted round's
        # bonus token is the same formula (max(p - 0, 0) = p).
        q_pad = torch.cat([q, torch.zeros_like(q[:1])])
        at = m[r:r + 1]
        p_m = p.index_select(0, at)
        res = (p_m - q_pad.index_select(0, at)).clamp_min(0.0)
        safe = torch.where(res.sum() > 0, res, p_m)
        nxt[r] = sample_token(torch.log(safe + 1e-30), 1.0, gen)[0]
    tokens = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1)
    tokens.scatter_(1, m[:, None], nxt[:, None])
    return tokens, m


def _spec_setup(model, draft_model, prompt, max_new_tokens, k, prompt_len,
                prefix):
    """Prefill (or splice + suffix prefill) both models -> (target cache,
    draft cache, target's last logits, ctx_len, the last position a
    round may start at).  ``ctx_len`` is the global depth of the last
    real prompt token + 1: cache positions are ctx-global while the
    output buffer stays suffix-local."""
    b, plen = prompt.shape
    margin = plen + max_new_tokens + k + 1
    if prefix is None:
        t_cache, t_last = prefill(model, prompt, prompt_len, margin)
        d_cache, _ = prefill(draft_model, prompt, prompt_len, margin)
        ctx_len = prompt_len
    else:
        t_kv, d_kv, prefix_len = prefix
        ctx_len = prefix_len + prompt_len
        caches = []
        for m, kv in ((model, t_kv), (draft_model, d_kv)):
            cache = init_cache(m, b, prefix_bucket_len(kv) + margin,
                               prompt.device)
            splice_prefix(cache, kv, prefix_len, b)
            caches.append(prefill_continue(m, cache, prompt, prefix_len,
                                           ctx_len))
        (t_cache, t_last), (d_cache, _) = caches
    slots = min(t_cache["cached_key"].shape[2],
                d_cache["cached_key"].shape[2])
    return t_cache, d_cache, t_last, ctx_len, slots - k - 1


def _generate(model, draft_model, prompt, max_new_tokens, k, prompt_len,
              prefix, first, sampled):
    """The round loop both variants share: ``first`` picks the first
    token from the target's prefill logits; ``sampled`` is
    :func:`spec_round`'s map (None: greedy)."""
    if not (getattr(model, "decode", False)
            and getattr(draft_model, "decode", False)):
        raise ValueError("speculative decoding needs decode=True models")
    if k < 1:
        raise ValueError("k must be >= 1")
    b, plen = prompt.shape
    dev = prompt.device
    if prompt_len is None:
        prompt_len = plen
    t_cache, d_cache, t_last_logits, ctx_len, last_start = _spec_setup(
        model, draft_model, prompt, max_new_tokens, k, prompt_len, prefix)
    # Room for a whole round's tokens past the last kept one.
    out = torch.cat([prompt, torch.zeros((b, max_new_tokens + k + 1),
                                         dtype=prompt.dtype, device=dev)], 1)
    t_last = first(t_last_logits)
    out[:, torch.as_tensor(prompt_len, device=dev).reshape(1)] = (
        t_last.to(prompt.dtype)[:, None])
    g = torch.ones(b, dtype=torch.int32, device=dev)  # tokens emitted
    stats = {"rounds": 0,
             "drafted": torch.zeros(b, dtype=torch.int32, device=dev),
             "accepted": torch.zeros(b, dtype=torch.int32, device=dev)}
    steps = torch.arange(k + 1, device=dev)
    while int(g.min()) < max_new_tokens:
        active = g < max_new_tokens
        # A finished row is parked where its writes stay inside the
        # margin (the margin rule in the module docstring).
        pos = (ctx_len + g - 1).clamp(max=last_start).to(torch.int32)
        _rewind_cache_index(t_cache, pos)
        _rewind_cache_index(d_cache, pos)
        tokens, m = spec_round(model, draft_model, t_cache, d_cache, pos,
                               t_last, k, sampled)
        # Live rows write at prompt_len + g; finished rows into the tail.
        at = torch.where(active, prompt_len + g, plen + max_new_tokens)
        out.scatter_(1, at[:, None].long() + steps, tokens.to(prompt.dtype))
        t_last = torch.where(active, tokens.gather(1, m[:, None])[:, 0],
                             t_last)
        g = torch.where(active, g + m.to(g.dtype) + 1, g)
        stats["rounds"] += 1
        stats["drafted"] += torch.where(active, k, 0).to(torch.int32)
        stats["accepted"] += torch.where(active, m, 0).to(torch.int32)
    return out[:, :plen + max_new_tokens], stats


def generate_speculative(model, draft_model, prompt, max_new_tokens: int,
                         k: int = 4, prompt_len=None, prefix=None):
    """Greedy-decode ``max_new_tokens`` past ``prompt`` [B, P] with k-token
    speculation -> (tokens [B, P+N], stats).

    Both models must be decode-mode ``TransformerLM``s sharing the
    vocabulary.  ``prompt_len`` has ``generate()``'s bucket-padding
    semantics.  ``stats``: ``rounds`` (int), ``drafted``/``accepted``
    ([B], counted while the row was still generating).  The generated
    tokens equal the target's own greedy continuation.

    ``prefix=(target_kv, draft_kv, prefix_len)`` composes with the prefix
    cache: each model's own block for the shared prompt (a
    ``PrefixCache`` per model); ``prompt`` then carries only the suffix
    and the output stays suffix-local, as ``generate_with_prefix``'s.
    """
    return _generate(model, draft_model, prompt, max_new_tokens, k,
                     prompt_len, prefix, lambda logits: logits.argmax(-1),
                     None)


def generate_speculative_sampled(model, draft_model, prompt,
                                 max_new_tokens: int, k: int = 4,
                                 temperature: float = 1.0,
                                 generator: Optional[torch.Generator] = None,
                                 prompt_len=None, prefix=None):
    """Distribution-exact sampled speculative decoding -> (tokens, stats),
    with :func:`generate_speculative`'s layout, ``prefix`` and stats.
    ``temperature`` must be > 0 (greedy is :func:`generate_speculative`).
    The first token is sampled from the prefill logits, as in
    ``generate()``; every row draws from ``generator`` (seed 0 if None)
    in row order."""
    if not temperature > 0:
        raise ValueError("temperature must be > 0 (greedy is "
                         "generate_speculative)")
    if generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    sampled = {r: (generator, temperature) for r in range(prompt.shape[0])}

    def first(logits):
        return torch.cat([sample_token(logits[r:r + 1], temperature,
                                       generator)
                          for r in range(logits.shape[0])])

    return _generate(model, draft_model, prompt, max_new_tokens, k,
                     prompt_len, prefix, first, sampled)
