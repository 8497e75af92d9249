"""Structured-prediction op lowerings (counterpart of
``paddle_tpu/ops/structured_ops.py``): ``linear_chain_crf`` and
``crf_decoding``.

The JAX package runs the CRF's forward algorithm and the Viterbi pass
as dense batched ``lax.scan``s in log space.  Here each is a Python loop
over the padded time axis of [B, C] tensor ops (no host reads of a
length), so a program of them captures as one CUDA graph.
``linear_chain_crf``'s grad is derived by the registry (autograd through
the logsumexp recurrence); ``crf_decoding`` has none.

``beam_search`` and ``beam_search_decode`` keep the JAX package's dense
[B, K] beam.  ``lax.top_k`` puts the lower index first among equal
scores, and ties are there by design (the -1e9 scores of the beams that
are not alive at the first step, a finished beam's candidates), while
``torch.topk`` on the card promises no order among them: the step takes
its K best with a stable descending sort instead, so ids and parents
are the JAX op's.  Still to come: ``nce`` and ``hierarchical_sigmoid``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op

from .common import length_mask


def _len_mask(length, b, t, device):
    m = length_mask(length, t)
    if m is None:
        return torch.ones((b, t), dtype=torch.bool, device=device)
    return m


def _split_transition(transition):
    """(start [C], end [C], transitions [C, C]) in fp32: row 0 is the
    start row, row 1 the end row, rows 2.. the transitions."""
    tr = transition.float()
    return tr[0], tr[1], tr[2:]


@simple_op("linear_chain_crf", ["Emission", "Transition", "Label", "Length"],
           ["Alpha", "EmissionExps", "TransitionExps", "LogLikelihood"],
           optional=("Length",), no_grad_inputs=("Label", "Length"))
def _linear_chain_crf(ctx, emission, transition, label, length, attrs):
    """Negative log-likelihood of the gold path [B, 1] (the reference
    returns -ll).  Emission [B,T,C]; Transition [(C+2),C].  Also the
    forward variables Alpha [B,T,C] (log space), the emissions'
    softmax over tags and exp(Transition)."""
    b, t, c = emission.shape
    em = emission.float()
    a, e, w = _split_transition(transition)
    lbl = label.reshape(b, t).long()
    mask = _len_mask(length, b, t, emission.device)

    # partition function: the alpha recurrence over time
    alpha = a[None, :] + em[:, 0, :]
    alphas = [alpha]
    for s in range(1, t):
        nxt = em[:, s, :] + torch.logsumexp(
            alpha[:, :, None] + w[None, :, :], dim=1)
        alpha = torch.where(mask[:, s, None], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + e[None, :], dim=-1)  # [B]

    # gold-path score
    first = lbl[:, 0]
    score = a[first] + em[:, 0, :].gather(1, first[:, None])[:, 0]
    em_t = em.gather(2, lbl[:, :, None])[:, :, 0]  # [B,T]
    score = score + torch.where(mask[:, 1:], em_t[:, 1:], 0.0).sum(dim=1)
    trans_t = w[lbl[:, :-1], lbl[:, 1:]]  # [B,T-1]
    score = score + torch.where(mask[:, 1:], trans_t, 0.0).sum(dim=1)
    if length is None:
        last = lbl[:, -1]
    else:
        last_idx = torch.clamp_min(length.reshape(b).long() - 1, 0)
        last = lbl.gather(1, last_idx[:, None])[:, 0]
    score = score + e[last]

    nll = (log_z - score)[:, None].to(emission.dtype)
    return (torch.stack(alphas, dim=1).to(emission.dtype),
            torch.softmax(em, dim=-1).to(emission.dtype),
            torch.exp(transition).to(emission.dtype),
            nll)


@simple_op("crf_decoding", ["Emission", "Transition", "Label", "Length"],
           ["ViterbiPath"], optional=("Label", "Length"), grad=None)
def _crf_decoding(ctx, emission, transition, label, length, attrs):
    """Viterbi decode.  Without Label the output is the best path [B,T]
    (int64, 0 past a row's length); with Label it is a 0/1 int64 tensor
    marking the steps whose decoded tag equals the label.  A tie takes
    the first (lowest) tag, as ``jnp.argmax`` does."""
    b, t, c = emission.shape
    em = emission.float()
    a, e, w = _split_transition(transition)
    mask = _len_mask(length, b, t, emission.device)
    identity = torch.arange(c, device=emission.device)[None, :].expand(b, c)

    v = a[None, :] + em[:, 0, :]
    bps = []
    for s in range(1, t):
        cand = v[:, :, None] + w[None, :, :]          # [B, C_prev, C]
        best_prev = cand.argmax(dim=1)                # the first of a tie
        valid = mask[:, s, None]
        v = torch.where(valid, em[:, s, :] + cand.amax(dim=1), v)
        # an invalid step's backpointer is the identity (it keeps the
        # last valid tag)
        bps.append(torch.where(valid, best_prev, identity))
    tag = (v + e[None, :]).argmax(dim=-1)
    path = [tag]
    for bp in reversed(bps):
        tag = bp.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)  # [B,T]
    path = torch.where(mask, path, 0).long()
    if label is not None:
        lbl = label.reshape(b, t).long()
        return torch.where(mask, (path == lbl).long(), 0)
    return path


_NEG = -1e30


@simple_op("beam_search", ["PreIds", "PreScores", "Scores"],
           ["SelectedIds", "SelectedScores", "ParentIdx"], grad=None)
def _beam_search(ctx, pre_ids, pre_scores, scores, attrs):
    """One beam step on the dense [B, K] beam.  pre_ids, pre_scores:
    [B, K]; scores: [B, K, V] log-probs of the next token.  A finished
    beam (pre_id == end_id) keeps its score, with end_id its only
    candidate.  Returns the K best (id, score) pairs over the K x V
    candidates of a row, best first (the lower flat index first among
    equal scores), and each one's parent beam."""
    end_id = int(attrs.get("end_id", 0))
    b, k, v = scores.shape
    finished = pre_ids.to(torch.int32) == end_id
    total = pre_scores[:, :, None].float() + scores.float()
    carry = torch.full((b, k, v), _NEG, dtype=torch.float32,
                       device=scores.device)
    carry[:, :, end_id] = pre_scores.float()
    total = torch.where(finished[:, :, None], carry, total)
    top, idx = torch.sort(total.reshape(b, k * v), dim=1, descending=True,
                          stable=True)
    top, idx = top[:, :k], idx[:, :k]
    return ((idx % v).to(torch.int64), top.to(pre_scores.dtype),
            torch.div(idx, v, rounding_mode="floor").to(torch.int32))


@simple_op("beam_search_decode", ["Ids", "ParentIdx"],
           ["SentenceIds", "SentenceScores"], grad=None,
           optional=("ParentIdx",))
def _beam_search_decode(ctx, ids, parents, attrs):
    """Backtrack T stacked beam steps (ids, parents: [T, B, K]) into
    sentences [B, K, T]: beam j's tokens, walking its parents from the
    last step back.  SentenceScores stays empty (the scores are the
    last step's PreScores), as in the JAX op."""
    t, b, k = ids.shape
    cur = torch.arange(k, device=ids.device).expand(b, k)
    toks = []
    for s in reversed(range(t)):
        toks.append(torch.gather(ids[s].long(), 1, cur))
        if parents is not None:
            cur = torch.gather(parents[s].long(), 1, cur)
    return torch.stack(toks[::-1], dim=-1), None
