"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample drawn
from the seed of the requests the clients received whole (the longest among
them, and enough others that a fault in some of the batch's rows cannot
hide) is run through the plain reference over each prompt and its served
tokens. The number compared is the widest gap by which a served token's
reference logit lies below the reference's best at its position
(``logit_gap``): greedy decoding serves the best token, so a sound program
reads no more than its rounding moves the logits. Beside it, an exact
count: finished requests whose frames did not carry 0, 1, ... n - 1 tokens
of their length, or a token id outside the vocabulary (``bad_streams``).

The control (``control_*``) is the same number for the token that the
reference in the next lower precision puts first at each position of the
same sequences; in a control run the cell's limits hold it in the
program's place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.client import ClientRecord


def bad_streams(records: Sequence[ClientRecord], vocab: int) -> int:
    """Finished requests that did not deliver exactly their length of token
    ids inside the vocabulary."""
    bad = 0
    for r in records:
        if not r.finished:
            continue
        ok = (r.error is None and len(r.tokens) == r.max_new_tokens
              and all(0 <= t < vocab for t in r.tokens))
        bad += not ok
    return bad


def misindexed(records: Sequence[ClientRecord]) -> int:
    """Finished requests whose frames' token indices are not 0 .. n - 1.
    Counted, not judged: the tokens arrive in order whatever the index."""
    return sum(1 for r in records if r.finished and r.indices != list(range(len(r.indices))))


def sample(records: Sequence[ClientRecord], seed: int, n: int) -> List[ClientRecord]:
    """``n`` finished, whole requests: the one with the most served tokens
    and others drawn from ``seed``."""
    done = sorted((r for r in records if r.finished and r.error is None and r.tokens),
                  key=lambda r: r.req_id)
    if not done:
        return []
    first = max(done, key=lambda r: (len(r.tokens), r.req_id))
    rest = [r for r in done if r is not first]
    order = np.random.default_rng((int(seed), 0xC4EC)).permutation(len(rest))
    return [first] + [rest[i] for i in order[:n - 1]]


def sequences(picked: Sequence[ClientRecord]):
    """(token sequences, positions scored, served tokens) of each request:
    the prompt with all but the last served token, scored at the prompt's
    last position and at every served token but the last."""
    seqs, poss, toks = [], [], []
    for r in picked:
        seq = np.concatenate([r.prompt.astype(np.int64), np.asarray(r.tokens[:-1], np.int64)])
        seqs.append(torch.from_numpy(seq))
        p0 = r.prompt_len - 1
        poss.append(list(range(p0, p0 + len(r.tokens))))
        toks.append(torch.as_tensor(r.tokens, dtype=torch.long))
    return seqs, poss, toks


def gaps(logits: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every position's gap: best logit - logit of the chosen token."""
    out = []
    for lg, c in zip(logits, chosen):
        c = c.to(lg.device)
        out.append((lg.max(dim=-1).values - lg.gather(1, c[:, None])[:, 0]).cpu())
    return torch.cat(out) if out else torch.zeros(0)


def summary(g: torch.Tensor, prefix: str) -> Dict[str, float]:
    """Of the positions' gaps: the widest, the mean, the mean square, the
    99th percentile, and the shares of positions whose chosen token is not
    the reference's best, or lies more than 0.05 / 0.1 / 0.2 below it."""
    if g.numel() == 0:
        return {}
    g = g.double()
    out = {f"{prefix}_gap": float(g.max()), f"{prefix}_mean_gap": float(g.mean()),
           f"{prefix}_msq_gap": float((g * g).mean()),
           f"{prefix}_p99_gap": float(torch.quantile(g, 0.99)),
           f"{prefix}_miss_share": float((g > 0).double().mean())}
    for t, name in ((0.05, "005"), (0.1, "01"), (0.2, "02")):
        out[f"{prefix}_over{name}_share"] = float((g > t).double().mean())
    return out


def readings(ref_logits: Dict[str, List[torch.Tensor]], truth: str, served, control=None):
    """The served tokens' gaps against the ``truth`` precision (``logit_*``)
    and those of the tokens the ``control`` precision ranks first
    (``control_*``)."""
    out = summary(gaps(ref_logits[truth], served), "logit")
    if control is not None:
        firsts = [lg.argmax(dim=-1) for lg in ref_logits[control]]
        out.update(summary(gaps(ref_logits[truth], firsts), "control"))
    return out
