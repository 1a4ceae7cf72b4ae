"""Speculative decoding on the chunk path, as the reference's
``repro.core.spec``.

Two pieces live here, both free of engine state:

  PromptLookupDraft   the draft source: prompt-lookup (n-gram) drafting. A
                      slot's recent token suffix is matched against its own
                      prompt+output history; the tokens that followed the
                      most recent earlier occurrence become the draft. No
                      second model, no extra weights: suited to extractive
                      traffic where the model copies spans of the prompt.

  verify_draft        the accept/reject rule applied to the target model's
                      chunk logits (``LM.decode_chunk(all_logits=True)``
                      scores all K+1 fed tokens in one call). Greedy
                      requests accept a draft token iff it equals the
                      argmax, so the output equals non-speculative decoding.
                      Sampled requests use rejection sampling against the
                      temperature/top-p target distribution: a draft token x
                      (point-mass proposal) is accepted with probability
                      p(x); on rejection the replacement is drawn from the
                      residual p with x removed and renormalized, so the
                      committed stream is distributed exactly as
                      non-speculative sampling (Leviathan et al. 2211.17192,
                      specialized to a deterministic proposal).

Everything here is pure: the engine owns KV rollback and page accounting.
The verify rule is plain PyTorch, as the reference's is plain JAX: it runs
on the (M, C, vocab) logits the head already produced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch


@dataclass
class PromptLookupDraft:
    """Prompt-lookup n-gram drafting over a slot's token history.

    ``propose`` tries suffix n-grams from ``ngram_max`` down to
    ``ngram_min``; the first n with an earlier occurrence wins, and the
    (up to k) tokens following its most recent occurrence are the draft.
    Returns [] when nothing matches — the slot decodes normally.
    """
    ngram_max: int = 3
    ngram_min: int = 1

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        L = len(tokens)
        if k <= 0 or L < self.ngram_min + 1:
            return []
        toks = tokens if isinstance(tokens, list) else [int(t) for t in tokens]
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            suffix = toks[L - n:]
            # scan most-recent-first for an earlier occurrence ending
            # strictly before the final suffix; start <= L-n-1 guarantees at
            # least one continuation token. A backward scan is O(1) on the
            # common case (repetitive history matches near the tail) where a
            # vectorized all-positions match would pay O(L*n) every call.
            for start in range(L - n - 1, -1, -1):
                if toks[start:start + n] == suffix:
                    draft = toks[start + n:start + n + k]
                    # a match close to the tail implies a cycle of period
                    # L - n - start; extend the short continuation
                    # periodically so runs ("x x x") and short cycles fill
                    # the full k-token draft instead of 1-2 tokens
                    period = L - n - start
                    while len(draft) < k:
                        draft.append(draft[len(draft) - period])
                    return draft
        return []


def target_probs(logits, temperature: float, top_p: float):
    """The engine's sampling distribution as explicit probabilities:
    temperature-scaled softmax truncated to the top-p nucleus and
    renormalized (the first token of the sorted order is always kept, as in
    ``engine.sample_tokens``). logits (..., V) -> probs (..., V) fp32."""
    scaled = logits.float() / temperature
    sl, si = torch.sort(scaled, dim=-1, descending=True)
    p = torch.softmax(sl, dim=-1)
    keep = (torch.cumsum(p, dim=-1) - p) < top_p
    p_kept = torch.softmax(torch.where(keep, sl, torch.full_like(sl, -torch.inf)), dim=-1)
    return torch.empty_like(p_kept).scatter_(-1, si, p_kept)   # back to vocab order


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from ``generator``: Gumbel-argmax draws a
    token from unnormalized log-probabilities."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def verify_draft(logits, tokens, nvalid, generator: torch.Generator, temperature: float,
                 top_p: float, greedy: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept/reject one speculative chunk per row.

    logits (M, C, V): decode_chunk(all_logits=True) output for rows that fed
    ``tokens`` (M, C) = [last_token, d_1 .. d_K] (C = 1 + K); row position j
    scores the token at index j+1. nvalid (M,): tokens actually fed per row
    (1 + k_i; 0 = inactive row). ``generator`` draws the acceptance
    uniforms and the residual's Gumbel noise of sampled rows.

    Returns (n_acc (M,), out (M,)) int32: the length of the accepted draft
    prefix and the token to commit after it — the bonus token when every
    draft was accepted, the greedy/residual-sampled correction otherwise.
    Committing d_1..d_{n_acc} then ``out`` reproduces the non-speculative
    engine (token for token for greedy, in distribution for sampling).
    """
    M, C, _ = logits.shape
    K = C - 1
    dev = logits.device
    tokens = tokens.long()
    drafts = tokens[:, 1:]                                   # (M, K)
    valid = torch.arange(K, device=dev)[None, :] < (nvalid.long()[:, None] - 1)
    det = greedy or temperature <= 0.0
    if det:
        acc = (torch.argmax(logits[:, :K], dim=-1) == drafts) & valid
    else:
        p = target_probs(logits[:, :K], temperature, top_p)  # (M, K, V)
        p_draft = torch.gather(p, -1, drafts[..., None])[..., 0]
        u = torch.rand((M, K), generator=generator, device=dev)
        acc = (u < p_draft) & valid                          # q is a point mass
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)

    sel = logits[torch.arange(M, device=dev), n_acc]         # (M, V)
    if det:
        out = torch.argmax(sel, dim=-1)
    else:
        p_sel = target_probs(sel, temperature, top_p)        # (M, V)
        rejected = torch.gather(tokens, 1, torch.clamp(n_acc + 1, max=C - 1)[:, None])[:, 0]
        had_reject = n_acc < (nvalid.long() - 1)
        hit = torch.arange(p_sel.shape[-1], device=dev)[None, :] == rejected[:, None]
        p_res = torch.where(hit & had_reject[:, None], torch.zeros_like(p_sel), p_sel)
        # gumbel-argmax over the unnormalized residual == categorical over
        # the renormalized residual; a rejected token with p(x) == 1 cannot
        # reach here (its rejection probability is 0)
        logp = torch.where(p_res > 0, torch.log(p_res), torch.full_like(p_res, -torch.inf))
        out = torch.argmax(logp + gumbel(p_res.shape, generator, dev), dim=-1)
    return n_acc.to(torch.int32), out.to(torch.int32)
