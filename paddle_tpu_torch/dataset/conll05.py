"""CoNLL-2005-shaped synthetic SRL dataset
(reference python/paddle/dataset/conll05.py — label_semantic_roles book test).

test() yields 9-slot samples: (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1,
ctx_p2, pred_id, mark, label_ids) — all sequences share one length.  Labels
are a deterministic function of word-vs-predicate distance, so a tagger can
learn them.
"""

from __future__ import annotations

import numpy as np

from . import common

_WORD_VOCAB = 512
_PRED_VOCAB = 64
_N_LABELS = 10


def get_dict():
    word_dict = {f"w{i}": i for i in range(_WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(_PRED_VOCAB)}
    label_dict = {f"L{i}": i for i in range(_N_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    r = common.rng(61)
    return r.randn(_WORD_VOCAB, 32).astype("float32")


def _ctx(words, off):
    n = len(words)
    return [int(words[min(max(i + off, 0), n - 1)]) for i in range(n)]


def _make(n, seed):
    r = common.rng(seed)
    out = []
    for _ in range(n):
        L = int(r.randint(4, 12))
        words = r.randint(0, _WORD_VOCAB, L).astype("int64")
        pred_pos = int(r.randint(0, L))
        pred = int(r.randint(0, _PRED_VOCAB))
        mark = [1 if i == pred_pos else 0 for i in range(L)]
        label = [int(min(abs(i - pred_pos), _N_LABELS - 1)) for i in range(L)]
        out.append((
            words.tolist(), _ctx(words, -2), _ctx(words, -1), _ctx(words, 0),
            _ctx(words, 1), _ctx(words, 2), [pred] * L, mark, label,
        ))
    return out


def test():
    return common.make_reader(_make(512, seed=62))


def train():
    return common.make_reader(_make(2048, seed=63))
