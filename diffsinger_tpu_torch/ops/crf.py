"""Linear-chain CRF of the ``dur_loss: crf`` duration head (counterpart of
diffsinger_tpu/ops/crf.py).

Semantics of torchcrf 0.7.2, as the JAX package implements them: the
parameters ``start_transitions`` [K], ``end_transitions`` [K] and
``transitions`` [K, K] (from-tag, to-tag), initialised U(-0.1, 0.1); the log
likelihood is the score of a tag path minus log Z per sequence, masked steps
skipped, the end transition applied at each sequence's last valid step; the
decode is the Viterbi path over the valid steps. ``mask[:, 0]`` must be on.

The forward recursion and the Viterbi pass are loops over T of one
[B, K, K] broadcast each. Ties in the Viterbi argmax take the first index,
as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def crf_score(emissions: torch.Tensor, tags: torch.Tensor, mask: torch.Tensor,
              start: torch.Tensor, end: torch.Tensor,
              transitions: torch.Tensor) -> torch.Tensor:
    """Unnormalised score of a tag path: emissions [B, T, K], tags [B, T]
    int, mask [B, T] (1 = valid, ``mask[:, 0]`` on) -> [B]."""
    tags = tags.to(torch.long)
    maskf = mask.to(emissions.dtype)
    first = tags[:, 0]
    score = start[first] + emissions[:, 0].gather(1, first[:, None])[:, 0]
    if tags.shape[1] > 1:
        trans = transitions[tags[:, :-1], tags[:, 1:]]                   # [B, T-1]
        emit = emissions[:, 1:].gather(2, tags[:, 1:, None])[..., 0]     # [B, T-1]
        score = score + ((trans + emit) * maskf[:, 1:]).sum(-1)
    last_idx = maskf.sum(-1).to(torch.long) - 1
    last_tag = tags.gather(1, last_idx[:, None])[:, 0]
    return score + end[last_tag]


def crf_log_partition(emissions: torch.Tensor, mask: torch.Tensor, start: torch.Tensor,
                      end: torch.Tensor, transitions: torch.Tensor) -> torch.Tensor:
    """log Z by the forward algorithm -> [B]."""
    mask = mask.to(torch.bool)
    alpha = start[None, :] + emissions[:, 0]                              # [B, K]
    for t in range(1, emissions.shape[1]):
        nxt = torch.logsumexp(alpha[:, :, None] + transitions[None]
                              + emissions[:, t, None, :], dim=1)
        alpha = torch.where(mask[:, t, None], nxt, alpha)
    return torch.logsumexp(alpha + end[None, :], dim=-1)


def crf_viterbi(emissions: torch.Tensor, mask: torch.Tensor, start: torch.Tensor,
                end: torch.Tensor, transitions: torch.Tensor) -> torch.Tensor:
    """Best tag path [B, T]. A masked step carries the score on and points
    every tag at itself, so padded steps repeat the last valid tag (the
    caller masks them out)."""
    mask = mask.to(torch.bool)
    b, t_len, k = emissions.shape
    score = start[None, :] + emissions[:, 0]
    ident = torch.arange(k, device=emissions.device).expand(b, k)
    backptrs = []
    for t in range(1, t_len):
        cand = score[:, :, None] + transitions[None] + emissions[:, t, None, :]
        best_score, best_prev = cand.max(dim=1)
        score = torch.where(mask[:, t, None], best_score, score)
        backptrs.append(torch.where(mask[:, t, None], best_prev, ident))
    tag = (score + end[None, :]).argmax(dim=-1)
    path = [tag]
    for bp in reversed(backptrs):
        tag = bp.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1)


def crf_viterbi_gap(emissions: torch.Tensor, mask: torch.Tensor, start: torch.Tensor,
                    end: torch.Tensor, transitions: torch.Tensor) -> torch.Tensor:
    """Score of the best path minus that of the second best, per row [B].

    The second-best path leaves the best one at some decision (the last tag,
    or the predecessor chosen for a tag of the best path) and is optimal
    otherwise, so the gap is the smallest margin between the best and the
    second-best candidate over the decisions along the best path. A gap near
    0 marks a near-tie that float rounding can flip."""
    mask = mask.to(torch.bool)
    b, t_len, k = emissions.shape
    scores = [start[None, :] + emissions[:, 0]]
    for t in range(1, t_len):
        cand = scores[-1][:, :, None] + transitions[None] + emissions[:, t, None, :]
        scores.append(torch.where(mask[:, t, None], cand.max(dim=1).values, scores[-1]))
    final = scores[-1] + end[None, :]
    top = final.topk(min(2, k), dim=-1)
    gap = (top.values[:, 0] - top.values[:, -1]) if k > 1 else final.new_full((b,), float("inf"))
    tag = top.indices[:, 0]
    rows = torch.arange(b, device=emissions.device)
    for t in range(t_len - 1, 0, -1):
        cand = scores[t - 1] + transitions[:, tag].T + emissions[rows, t, tag][:, None]
        two = cand.topk(min(2, k), dim=-1)
        step_gap = torch.where(mask[:, t], two.values[:, 0] - two.values[:, -1],
                               torch.full_like(gap, float("inf")))
        gap = torch.minimum(gap, step_gap if k > 1 else gap)
        tag = torch.where(mask[:, t], two.indices[:, 0], tag)
    return gap


class LinearChainCRF(nn.Module):
    """The three transition tables, torchcrf's parameter names."""

    def __init__(self, num_tags: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_tags = num_tags
        self.start_transitions = nn.Parameter(torch.empty(num_tags))
        self.end_transitions = nn.Parameter(torch.empty(num_tags))
        self.transitions = nn.Parameter(torch.empty(num_tags, num_tags))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for p in (self.start_transitions, self.end_transitions, self.transitions):
            p.uniform_(-0.1, 0.1, generator=generator)

    def tables(self):
        return self.start_transitions, self.end_transitions, self.transitions

    def log_likelihood(self, emissions: torch.Tensor, tags: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """Per-sequence log p(tags | emissions) -> [B]."""
        return (crf_score(emissions, tags, mask, *self.tables())
                - crf_log_partition(emissions, mask, *self.tables()))

    def decode(self, emissions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return crf_viterbi(emissions, mask, *self.tables())
