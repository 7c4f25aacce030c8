"""Batch logits processing and sampling (port of
hydrainfer_tpu/ops/sampling.py).

Frequency, presence and repetition penalties, temperature, top-k and top-p
as plain transforms over (n_seqs, vocab) logits, the full chain
(`process_logits`) and the speculative-verify acceptance
(`spec_verify_tokens`). The tie rules are the JAX package's: top-k keeps
every logit equal to the k-th largest, top-p keeps the smallest sorted prefix
whose probability mass before each token is below top_p (at least one
token); top_k <= 0 and top_p >= 1 turn their filter off.

Random draws come from an explicit torch.Generator, never from the global
RNG: a categorical draw is Gumbel-max over `torch.rand(..., generator=g)`.
Nothing here reads a value back to the host, so the chain can run inside a
CUDA graph (models/step_graphs.py registers the generator with each graph,
so every replay draws fresh numbers). Seeds cannot match jax.random:
stochastic agreement with the JAX package is by distribution.
"""
from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


def apply_count_penalties(logits: torch.Tensor, token_counts: torch.Tensor,
                          frequency_penalty: torch.Tensor,
                          presence_penalty: torch.Tensor) -> torch.Tensor:
    """token_counts: (S, vocab) occurrence counts of generated tokens."""
    logits = logits - frequency_penalty[:, None] * token_counts
    return logits - presence_penalty[:, None] * (token_counts > 0)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             repetition_penalty: torch.Tensor) -> torch.Tensor:
    """seen_mask: (S, vocab) bool, the tokens present in prompt or output."""
    rp = repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen_mask, penalized, logits)


def apply_temperature(logits: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    return logits / torch.clamp(temperature, min=1e-6)[:, None]


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """top_k: (S,) int; <= 0 disables. Every logit equal to the k-th largest
    stays."""
    vocab = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, vocab, top_k)
    idx = torch.clamp(k - 1, max=vocab - 1).long()[:, None]
    kth = sorted_logits.gather(-1, idx)
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering; top_p: (S,) float, >= 1 disables."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # the smallest prefix whose mass reaches top_p (always >= 1 token)
    keep = (cum - probs) < top_p[:, None]
    cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, NEG_INF, logits)


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits), by Gumbel-max: (S, V) -> (S,)
    int32."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def _filtered_probs(lg: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    lg = apply_temperature(lg, temperature)
    if top_k is not None:
        lg = apply_top_k(lg, top_k)
    if top_p is not None:
        lg = apply_top_p(lg, top_p)
    return torch.softmax(lg, dim=-1)


def spec_verify_tokens(logits: torch.Tensor, draft_next: torch.Tensor,
                       draft_lens: torch.Tensor,
                       temperature: Optional[torch.Tensor] = None,
                       top_k: Optional[torch.Tensor] = None,
                       top_p: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
    """Speculative verification over S segments of K1 rows.

    logits (S, K1, V): row j's next-token distribution after consuming
    position j. draft_next (S, K1): the token proposed as row j's output
    (draft j+1); only the first draft_lens entries of a row are real.
    Returns (emitted (S, K1) int32, acc (S,) int32): emitted[i, :acc[i]] are
    the accepted drafts, emitted[i, acc[i]] the final token; entries past
    acc are padding the caller drops.

    Greedy rows (no temperature, or temperature <= 0) accept a draft on an
    exact argmax match, so they emit plain greedy decoding's tokens.
    Stochastic rows use rejection sampling against the one-hot draft: draft
    d at row j is accepted with probability p_j(d), p being the
    temperature/top-k/top-p filtered distribution; on the first rejection
    the final token is drawn from p with d zeroed, renormalized, which keeps
    the target distribution exactly. When every real draft is accepted, the
    final token is drawn from the last row's p."""
    S, K1, V = logits.shape
    lg = logits.float()
    greedy_tok = torch.argmax(lg, dim=-1).to(torch.int32)           # (S, K1)
    dn = torch.clamp(draft_next, 0, V - 1).long()
    dl = torch.clamp(draft_lens, 0, K1 - 1)

    probs = None
    if temperature is not None and generator is not None:
        stoch = temperature > 0
        rep = lambda t: None if t is None else t.repeat_interleave(K1)
        probs = _filtered_probs(lg.reshape(S * K1, V), rep(temperature), rep(top_k),
                                rep(top_p)).reshape(S, K1, V)
        p_draft = probs.gather(-1, dn[..., None])[..., 0]
        u = torch.rand((S, K1), generator=generator, device=lg.device)
        accept = torch.where(stoch[:, None], u < p_draft, greedy_tok == dn)
    else:
        accept = greedy_tok == dn

    j = torch.arange(K1, dtype=torch.int32, device=lg.device)
    in_draft = j[None, :] < dl[:, None]
    acc = torch.cumprod((accept & in_draft).to(torch.int32), dim=1).sum(dim=1)
    row = torch.arange(S, device=lg.device)
    acc_l = acc.long()
    final = greedy_tok[row, acc_l]
    if probs is not None:
        p_row = probs[row, acc_l]                                    # (S, V)
        resid = p_row.scatter(1, dn[row, acc_l][:, None], 0.0)
        dist = torch.where((acc < dl)[:, None], resid, p_row)
        dist = dist / torch.clamp(dist.sum(-1, keepdim=True), min=1e-20)
        samp = categorical(torch.log(torch.clamp(dist, min=1e-30)), generator)
        final = torch.where(stoch, samp, final)
    emitted = torch.where(j[None, :] < acc[:, None], dn, 0).to(torch.int32)
    emitted = emitted.scatter(1, acc_l[:, None], final[:, None])
    return emitted, acc.to(torch.int32)


def process_logits(logits: torch.Tensor,
                   token_counts: Optional[torch.Tensor] = None,
                   seen_mask: Optional[torch.Tensor] = None,
                   frequency_penalty: Optional[torch.Tensor] = None,
                   presence_penalty: Optional[torch.Tensor] = None,
                   repetition_penalty: Optional[torch.Tensor] = None,
                   temperature: Optional[torch.Tensor] = None,
                   top_k: Optional[torch.Tensor] = None,
                   top_p: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   greedy: bool = False) -> torch.Tensor:
    """The full chain -> (S,) int32 token ids: argmax when greedy or when no
    generator is given, else one draw per row."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_count_penalties(logits, token_counts, frequency_penalty,
                                       presence_penalty)
    if seen_mask is not None and repetition_penalty is not None:
        logits = apply_repetition_penalty(logits, seen_mask, repetition_penalty)
    if temperature is not None:
        logits = apply_temperature(logits, temperature)
    if top_k is not None:
        logits = apply_top_k(logits, top_k)
    if top_p is not None:
        logits = apply_top_p(logits, top_p)
    if greedy or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return categorical(logits, generator)
