"""Metric and sequence-distance ops (counterpart of
``paddle_tpu/ops/metric_ops.py`` and of ``chunk_eval`` in
``paddle_tpu/ops/misc_ops.py``): ``auc``, ``precision_recall``,
``edit_distance``, ``warpctc`` and ``chunk_eval``.

The JAX package keeps them inside the compiled block; here they stay on
the device too, with no host read in a lowering, so a captured step
holds them.  ``auc`` and ``precision_recall`` keep the reference's
streaming state: ``auc`` adds its batch histogram into the scope's
``StatPos``/``StatNeg`` tensors in place (``inplace`` names the
aliases), so a graph replay updates the buffers it was captured on.
CTC is the log-space alpha recursion as a loop over time (its grad
derived by the registry), edit distance the Levenshtein DP a hyp
position at a time, each row closed in one ``cummin``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.fluid.registry import simple_op

_NEG = -1e30


@simple_op("auc", ["Predict", "Label", "StatPos", "StatNeg"],
           ["AUC", "StatPosOut", "StatNegOut"], grad=None,
           inplace={"StatPosOut": "StatPos", "StatNegOut": "StatNeg"})
def _auc(ctx, predict, label, stat_pos, stat_neg, attrs):
    """Streaming AUC: P(class 1) bucketed into num_thresholds + 1 bins
    added to the pos/neg histograms in place, then the curve ('ROC':
    trapezoids over the FPR; 'PR': precision over recall) integrated
    from the highest threshold down, in fp64 over int64 stats (fp32
    over narrower ones), as the JAX lowering does."""
    curve = str(attrs.get("curve", "ROC")).upper()
    if curve not in ("ROC", "PR"):
        raise ValueError(f"auc: unknown curve {curve!r} (ROC or PR)")
    num_th = int(attrs.get("num_thresholds", 4095))
    p1 = predict[:, -1].float()
    lbl = label.reshape(-1).to(torch.int32)
    idx = (p1 * num_th).to(torch.int32).clamp(0, num_th).long()
    stat_pos.index_add_(0, idx, (lbl == 1).to(stat_pos.dtype))
    stat_neg.index_add_(0, idx, (lbl == 0).to(stat_neg.dtype))

    ft = torch.float64 if stat_pos.dtype == torch.int64 else torch.float32
    pos_d = torch.flip(stat_pos, (0,)).to(ft)
    neg_d = torch.flip(stat_neg, (0,)).to(ft)
    cum_pos = torch.cumsum(pos_d, 0)
    cum_neg = torch.cumsum(neg_d, 0)
    tot_pos, tot_neg = cum_pos[-1], cum_neg[-1]
    prev_pos = cum_pos - pos_d
    prev_neg = cum_neg - neg_d
    zero = torch.zeros((), dtype=ft, device=p1.device)
    if curve == "ROC":
        area = torch.sum((cum_neg - prev_neg) * (cum_pos + prev_pos) / 2.0)
        auc = torch.where(tot_pos * tot_neg > 0,
                          area / torch.clamp(tot_pos * tot_neg, min=1.0),
                          zero)
    else:
        prec = cum_pos / torch.clamp(cum_pos + cum_neg, min=1e-9)
        prev_prec = prev_pos / torch.clamp(prev_pos + prev_neg, min=1e-9)
        prev_prec = torch.where(prev_pos + prev_neg > 0, prev_prec, prec)
        rec = cum_pos / torch.clamp(tot_pos, min=1e-9)
        prev_rec = prev_pos / torch.clamp(tot_pos, min=1e-9)
        area = torch.sum((rec - prev_rec) * (prec + prev_prec) / 2.0)
        auc = torch.where(tot_pos > 0, area, zero)
    return auc.to(torch.float32), stat_pos, stat_neg


def _one_hot(ids, c):
    """fp32 one-hot rows; an id outside [0, c) gives a zero row."""
    return (ids.long()[:, None]
            == torch.arange(c, device=ids.device)).to(torch.float32)


def _pr_metrics(st):
    """Macro P/R/F1 then micro P/R/F1 of [C, 4] (TP, FP, TN, FN) rows."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
    zero = torch.zeros((), device=st.device)

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1e-9), zero)

    prec = ratio(tp, tp + fp)
    rec = ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mic_p = ratio(stp, stp + sfp)
    mic_r = ratio(stp, stp + sfn)
    mic_f = ratio(2 * mic_p * mic_r, mic_p + mic_r)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(),
                        mic_p, mic_r, mic_f]).to(torch.float32)


@simple_op("precision_recall",
           ["MaxProbs", "Indices", "Labels", "Weights", "StatesInfo"],
           ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
           optional=("MaxProbs", "Weights", "StatesInfo"), grad=None,
           inplace={"AccumStatesInfo": "StatesInfo"})
def _precision_recall(ctx, max_probs, indices, labels, weights, states,
                      attrs):
    """Per-class streaming precision/recall/F1: Indices [B, 1] the
    predicted class, Labels [B, 1], StatesInfo [C, 4] rows of (TP, FP,
    TN, FN); a 6-vector (macro P/R/F1, micro P/R/F1) for the batch and
    for the accumulated states."""
    c = int(attrs["class_number"])
    pred = indices.reshape(-1)
    lbl = labels.reshape(-1)
    w = (weights.reshape(-1).float() if weights is not None
         else torch.ones(pred.shape, device=pred.device))
    onehot_pred = _one_hot(pred, c) * w[:, None]
    onehot_lbl = _one_hot(lbl, c) * w[:, None]
    tp = torch.sum(onehot_pred * _one_hot(lbl, c), 0)
    fp = torch.sum(onehot_pred, 0) - tp
    fn = torch.sum(onehot_lbl, 0) - tp
    tn = torch.sum(w) - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], 1)
    accum = batch_states if states is None \
        else states.float() + batch_states
    return _pr_metrics(batch_states), _pr_metrics(accum), accum


@simple_op("edit_distance", ["Hyps", "Refs", "HypsLength", "RefsLength"],
           ["Out", "SequenceNum"], optional=("HypsLength", "RefsLength"),
           grad=None)
def _edit_distance(ctx, hyps, refs, hyp_len, ref_len, attrs):
    """Levenshtein distance vectorized over the batch: the DP a hyp
    position at a time.  Row i + 1 is val[c] = min(a[c], val[c-1] + 1)
    with a[c] = min(prev[c] + 1, prev[c-1] + sub) and a[0] = i + 1,
    which is c + cummin(a[k] − k): the JAX lowering's inner scan in one
    op, exact on these integer values."""
    normalized = bool(attrs.get("normalized", False))
    b, th = hyps.shape[0], hyps.shape[1]
    tr = refs.shape[1]
    dev = hyps.device
    hyps = hyps.to(torch.int32)
    refs = refs.to(torch.int32)
    hl = (hyp_len.reshape(-1).long() if hyp_len is not None
          else torch.full((b,), th, dtype=torch.long, device=dev))
    rl = (ref_len.reshape(-1).long() if ref_len is not None
          else torch.full((b,), tr, dtype=torch.long, device=dev))
    cols = torch.arange(tr + 1, dtype=torch.float32, device=dev)
    row = cols[None, :].expand(b, tr + 1)
    rows = [row]
    for i in range(th):
        sub = (hyps[:, i:i + 1] != refs).to(torch.float32)
        a = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)
        first = torch.full((b, 1), float(i + 1), device=dev)
        a = torch.cat([first, a], 1)
        row = cols + torch.cummin(a - cols, 1).values
        rows.append(row)
    all_rows = torch.stack(rows, 0)  # [Th+1, B, Tr+1]
    d = all_rows[hl, torch.arange(b, device=dev)]
    d = torch.gather(d, 1, rl[:, None])[:, 0]
    if normalized:
        d = d / torch.clamp(rl.to(torch.float32), min=1.0)
    return (d[:, None].to(torch.float32),
            torch.full((), b, dtype=torch.int64, device=dev))


@simple_op("warpctc", ["Logits", "Label", "LogitsLength", "LabelLength"],
           ["WarpCTCGrad", "Loss"],
           optional=("LogitsLength", "LabelLength"),
           no_grad_inputs=("Label", "LogitsLength", "LabelLength"))
def _warpctc(ctx, logits, label, logits_len, label_len, attrs):
    """CTC loss: the log-space alpha recursion over the blank-extended
    label, a loop over time.  Logits [B, T, C] raw (log-softmax here),
    Label [B, L] padded with blank, lengths [B]; Loss [B, 1] =
    −log p(label | logits).  ``WarpCTCGrad`` is None: the grad is
    derived through the loop."""
    blank = int(attrs.get("blank", 0))
    norm_by_times = bool(attrs.get("norm_by_times", False))
    b, t, _ = logits.shape
    l = label.shape[1]
    s = 2 * l + 1
    dev = logits.device
    logp = F.log_softmax(logits.float(), dim=-1)
    t_len = (logits_len.reshape(-1).long() if logits_len is not None
             else torch.full((b,), t, dtype=torch.long, device=dev))
    l_len = (label_len.reshape(-1).long() if label_len is not None
             else torch.full((b,), l, dtype=torch.long, device=dev))
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label.long()
    can_skip = torch.zeros((b, s), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((), _NEG, device=dev)

    def emit(logp_t):  # [B, C] -> [B, S]
        return torch.gather(logp_t, 1, ext)

    e0 = emit(logp[:, 0])
    alpha = torch.cat([e0[:, :1],
                       torch.where(l_len > 0, e0[:, 1], neg)[:, None],
                       neg.expand(b, s - 2)], 1)
    pad1 = neg.expand(b, 1)
    pad2 = neg.expand(b, 2)
    for ti in range(1, t):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip,
                            torch.cat([pad2, alpha[:, :-2]], 1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) \
            + emit(logp[:, ti])
        alpha = torch.where((ti < t_len)[:, None], new, alpha)
    idx_last = torch.clamp(2 * l_len, 0, s - 1)
    idx_prev = torch.clamp(2 * l_len - 1, 0, s - 1)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, idx_prev[:, None])[:, 0]
    loss = -torch.where(l_len > 0, torch.logaddexp(a_last, a_prev), a_last)
    if norm_by_times:
        loss = loss / torch.clamp(t_len.to(torch.float32), min=1.0)
    return None, loss[:, None].to(logits.dtype)


@simple_op("chunk_eval", ["Inference", "Label", "Length"],
           ["Precision", "Recall", "F1-Score", "NumInferChunks",
            "NumLabelChunks", "NumCorrectChunks"],
           optional=("Length",), grad=None)
def _chunk_eval(ctx, infer, label, length, attrs):
    """Chunking precision/recall/F1 in the IOB scheme: tag t =
    chunk_type·2 + (0 for B, 1 for I); tags at or past num_chunk_types·2
    are outside.  A chunk is correct when it begins and ends at the same
    positions with the same type in both; the match runs a position at a
    time.  Counts are int32, as the JAX lowering gives them."""
    scheme = attrs.get("chunk_scheme", "IOB")
    if scheme != "IOB":
        raise NotImplementedError(
            f"chunk_eval: scheme {scheme!r} not supported (IOB only; "
            f"plain/IOE/IOBES use different tag encodings)")
    num_chunk_types = int(attrs["num_chunk_types"])
    b, t = infer.shape[0], infer.shape[1]
    dev = infer.device
    inf = infer.reshape(b, t).to(torch.int32)
    lbl = label.reshape(b, t).to(torch.int32)
    steps = torch.arange(t, device=dev)[None, :]
    valid = steps < (length.reshape(-1, 1).long() if length is not None
                     else torch.full((b, 1), t, device=dev))

    def stats(tags):
        inside = (tags >= 0) & (tags < num_chunk_types * 2) & valid
        ctype = torch.where(inside, tags // 2, -1)
        is_b = inside & (tags % 2 == 0)
        prev_ctype = F.pad(ctype[:, :-1], (1, 0), value=-1)
        prev_inside = F.pad(inside[:, :-1], (1, 0), value=False)
        begin = inside & (is_b | ~prev_inside | (prev_ctype != ctype))
        return begin, inside, ctype

    bi, ii, ti = stats(inf)
    bl, il, tl = stats(lbl)
    n_inf = bi.sum()
    n_lbl = bl.sum()
    both_begin = bi & bl & (ti == tl)
    inf_cont = ii & ~bi
    lbl_cont = il & ~bl
    m = torch.zeros((b,), dtype=torch.bool, device=dev)
    n_ended = torch.zeros((), dtype=torch.long, device=dev)
    for k in range(t):
        ended = m & ~inf_cont[:, k] & ~lbl_cont[:, k]
        n_ended = n_ended + ended.sum()
        m = (m & inf_cont[:, k] & lbl_cont[:, k]) | both_begin[:, k]
    n_correct = n_ended + m.sum()
    zero = torch.zeros((), device=dev)
    prec = torch.where(n_inf > 0, n_correct / torch.clamp(n_inf, min=1),
                       zero)
    rec = torch.where(n_lbl > 0, n_correct / torch.clamp(n_lbl, min=1),
                      zero)
    f1 = torch.where(prec + rec > 0,
                     2 * prec * rec / torch.clamp(prec + rec, min=1e-9),
                     zero)
    return (prec.to(torch.float32), rec.to(torch.float32),
            f1.to(torch.float32), n_inf.to(torch.int32),
            n_lbl.to(torch.int32), n_correct.to(torch.int32))
