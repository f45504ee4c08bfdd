"""Autoregressive generation for the transformer LM (KV-cache decode) —
PyTorch counterpart of ``container_engine_accelerators_tpu/models/
generate.py``.

Generation is two-phase:

1. **Batched prefill** — one forward over the whole (bucket-padded)
   prompt fills every layer's KV cache; only the last real position's
   hidden row is projected to logits.
2. **Decode loop** — ``max_new_tokens - 1`` single-token steps (greedy at
   ``temperature=0``, Gumbel-max categorical sampling otherwise), a
   Python loop where the JAX package scans.  Nothing in the loop reads a
   device value on the host, so the steps queue without host round
   trips.

``prefill_chunked`` runs phase 1 in fixed-size pieces (a Python loop
where the JAX package scans), and ``splice_prefix`` starts a cache from
a stored prefix block (``models/prefix_cache.py``).  The port's forward
writes the cache in place, so a splice copies the block into the
request's own cache: a cached block is never aliased, or the first
request's suffix would overwrite it.

A decode model sharded over a (1, tp) mesh (``cmd/serve_lm.py --tp``)
runs the same functions: its forward takes and returns plain tensors,
whole on every rank, and its cache holds this rank's KV heads
(:func:`init_cache`), so the loop, the cursor and sampling are the same
on every rank.  Every rank must make the same calls, in the same order:
each forward is a collective.

``prompt_len`` and ``start`` may be Python ints or 0-d integer tensors.
Sampling draws from an explicit ``torch.Generator``: it cannot reproduce
``jax.random.categorical``'s stream, so only greedy output is held
token-exact against the JAX package.
"""

from typing import Optional

import torch

from container_engine_accelerators_tpu_torch.models.transformer import lm_head
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    full,
    local_heads,
    replicate,
)


def init_cache(model, batch: int, max_len: int, device=None) -> dict:
    """Zero-filled cache for ``max_len`` tokens on the model's device:
    ``cached_key``/``cached_value`` [layers, B, L, KVH, hd] in the
    compute dtype and a per-sample ``cache_index`` [layers, B] int32.
    On a mesh KVH is this rank's share of the KV heads when the model
    axis divides them (``parallel/mesh.py::local_heads``)."""
    device = model.embed.device if device is None else device
    shape = (model.num_layers, batch, max_len,
             local_heads(model.mesh, model.num_kv_heads), model.head_dim)
    return {
        "cached_key": torch.zeros(shape, dtype=model.dtype, device=device),
        "cached_value": torch.zeros(shape, dtype=model.dtype, device=device),
        "cache_index": torch.zeros((model.num_layers, batch),
                                   dtype=torch.int32, device=device),
    }


def _rewind_cache_index(cache, position):
    """Set every layer's ``cache_index`` to ``position`` (in place): a
    scalar (an int or a 0-d tensor) for every lane, or a [B] tensor of
    each lane's own position (the batching engine's fleet).

    After a prefill over a PADDED prompt the write cursor sits past the
    pad slots; rewinding it to the true prompt length makes decode
    overwrite those slots in order, and the visibility mask (key slot <=
    query position) hides any slot not yet overwritten — so pads never
    influence the continuation.
    """
    idx = cache["cache_index"]
    if torch.is_tensor(position) and position.dim():
        idx.copy_(position.to(idx.dtype).expand_as(idx))
    else:
        idx.fill_(position)
    return cache


def splice_prefix(cache, prefix_kv, prefix_len, batch: int):
    """Copy a stored prefix KV block (a one-lane cache, [layers, 1, PFX,
    KVH, hd]) into slots [0, PFX) of every lane of ``cache`` and cue the
    cursor at ``prefix_len`` (in place).  A copy, never an alias: the
    forward then writes the suffix into ``cache`` alone."""
    pfx = prefix_bucket_len(prefix_kv)
    for name in ("cached_key", "cached_value"):
        cache[name][:, :batch, :pfx] = prefix_kv[name]
    return _rewind_cache_index(cache, prefix_len)


def prefix_bucket_len(prefix_kv) -> int:
    """Bucket (slot-axis) length of a stored prefix KV block."""
    return prefix_kv["cached_key"].shape[2]


def _positions(start, n: int, device):
    return start + torch.arange(n, dtype=torch.int32, device=device)


def _forward_chunk(model, cache, tokens, start):
    """One decode-mode forward of ``tokens`` [B, S] at positions ``start +
    arange(S)`` -> (cache with cursor advanced by S, hidden [B, S, D])."""
    hidden = model(tokens, positions=_positions(start, tokens.shape[1],
                                                tokens.device),
                   cache=cache, project=False)
    return cache, hidden


def _project_last(model, h_row):
    """LM-head projection of one hidden row [B, D] -> f32 logits [B, V]
    (whole on every rank of a mesh)."""
    mesh = model.mesh
    if mesh is None:
        return lm_head(h_row, model.embed)
    return full(lm_head(replicate(h_row, mesh), model.embed))


def prefill_continue(model, cache, tokens, start, true_end):
    """Continue a prefill: one forward over ``tokens`` [B, S] into a cache
    whose write cursor sits at ``start`` -> (cache cued at ``true_end``,
    last real position's logits).  ``true_end`` counts the real tokens
    now in the cache; the tail of ``tokens`` beyond it is bucket
    padding."""
    cache, hidden = _forward_chunk(model, cache, tokens, start)
    _rewind_cache_index(cache, true_end)
    row = torch.as_tensor(true_end - start - 1, device=hidden.device)
    h_last = hidden.index_select(1, row.clamp(min=0).reshape(1))[:, 0]
    return cache, _project_last(model, h_last)


def prefill(model, prompt, prompt_len, max_len: int):
    """Batched prefill -> (cache cued at ``prompt_len``, last logits)."""
    cache = init_cache(model, prompt.shape[0], max_len, prompt.device)
    return prefill_continue(model, cache, prompt, 0, prompt_len)


def prefill_chunked(model, prompt, prompt_len, max_len: int, chunk: int):
    """Prefill in ``chunk``-token pieces -> (cache cued at ``prompt_len``,
    last logits), the same result as :func:`prefill` (each piece attends
    the cache written so far).  The einsum prefill's score tensor is [B,
    H, P, L]; pieces cap it at [B, H, chunk, L].

    Every piece advances the cursor to its own end and yields its
    candidate for the hidden row of token ``prompt_len - 1``; ascending
    pieces make "take the candidate whenever ``prompt_len - 1 >= start``"
    select the piece that holds it.  The cursor then rewinds to
    ``prompt_len``, as after a padded single-shot prefill."""
    b, plen = prompt.shape
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if chunk >= plen:
        return prefill(model, prompt, prompt_len, max_len)
    cache = init_cache(model, b, max_len, prompt.device)
    last = torch.as_tensor(prompt_len, device=prompt.device) - 1
    h_last = None
    for start in range(0, plen, chunk):
        piece = prompt[:, start:start + chunk]
        cache, hidden = _forward_chunk(model, cache, piece, start)
        row = (last - start).clamp(0, piece.shape[1] - 1).reshape(1)
        cand = hidden.index_select(1, row)[:, 0]
        h_last = cand if h_last is None else torch.where(
            last >= start, cand, h_last)
    _rewind_cache_index(cache, prompt_len)
    return cache, _project_last(model, h_last)


def sample_token(logits, temperature, generator: torch.Generator):
    """Gumbel-max categorical sample of f32 ``logits`` [B, V] at
    ``temperature`` -> [B] (int64), drawing one ``torch.rand`` of the
    logits' shape from ``generator``.  The per-request loop and the
    batching engine's sampled lanes both sample through here, so a lane
    that draws from its own generator at shape [1, V] gives per-request
    sampling's tokens."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(
        u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (logits / temperature + gumbel).argmax(-1)


def decode_loop(model, cache, last_logits, prompt_len, max_new_tokens: int,
                temperature=0.0, generator: Optional[torch.Generator] = None,
                dtype=torch.long):
    """Sample from ``last_logits``, then run ``max_new_tokens - 1``
    single-token steps -> generated [B, N].  The cache must be cued at
    ``prompt_len``.  ``temperature == 0`` is greedy."""
    device = last_logits.device
    greedy = temperature == 0
    if not greedy and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def sample_from(logits):
        if greedy:
            return logits.argmax(-1).to(dtype)
        return sample_token(logits, temperature, generator).to(dtype)

    tok = sample_from(last_logits)
    toks = [tok]
    # Step j feeds the token at output position prompt_len + j.
    for j in range(max_new_tokens - 1):
        logits = model(tok[:, None], positions=_positions(prompt_len + j, 1,
                                                          device),
                       cache=cache)
        tok = sample_from(logits[:, 0, :])
        toks.append(tok)
    return torch.stack(toks, dim=1)


def generate(model, prompt, max_new_tokens: int, temperature=0.0,
             generator: Optional[torch.Generator] = None, prompt_len=None,
             prefill_chunk: Optional[int] = None):
    """Generate ``max_new_tokens`` past ``prompt`` [B, P] -> [B, P+N].

    ``prompt_len`` (optional) is the number of leading ``prompt`` tokens
    that are real; the rest is bucket padding.  Pad K/V land in cache
    slots during the prefill but are dead on arrival: the causal mask
    keeps them out of every real position's attention, the write cursor
    is rewound to ``prompt_len`` so decode overwrites them in order, and
    slots beyond the current position are always masked.

    Output layout: positions ``[0, prompt_len)`` echo the prompt,
    ``[prompt_len, prompt_len + max_new_tokens)`` are generated; with
    bucket padding the tail beyond that is meaningless — consumers slice
    ``[:, :prompt_len + max_new_tokens]``.

    ``prefill_chunk`` prefills in pieces of that many tokens
    (:func:`prefill_chunked`), with the same tokens.
    """
    if not getattr(model, "decode", False):
        raise ValueError("generate() needs a model built with decode=True")
    b, plen = prompt.shape
    if prompt_len is None:
        prompt_len = plen
    if isinstance(prompt_len, int) and not 0 < prompt_len <= plen:
        raise ValueError(f"prompt_len {prompt_len} outside (0, {plen}]")
    if prefill_chunk:
        cache, last = prefill_chunked(model, prompt, prompt_len,
                                      plen + max_new_tokens, prefill_chunk)
    else:
        cache, last = prefill(model, prompt, prompt_len,
                              plen + max_new_tokens)
    gen = decode_loop(model, cache, last, prompt_len, max_new_tokens,
                      temperature, generator, prompt.dtype)
    out = torch.cat([prompt, torch.zeros((b, max_new_tokens),
                                         dtype=prompt.dtype,
                                         device=prompt.device)], dim=1)
    out[:, _positions(prompt_len, max_new_tokens, prompt.device).long()] = gen
    return out
