"""WMT16-shaped synthetic translation dataset
(reference python/paddle/dataset/wmt16.py — machine_translation book test).

train(src_dict_size, trg_dict_size) yields (src_ids, trg_ids, trg_next_ids)
— target is a deterministic "translation" (reversed source mapped through a
fixed permutation) so a seq2seq model can learn it.  Special ids: 0 <s>,
1 <e>, 2 <unk>.
"""

from __future__ import annotations

import numpy as np

from . import common

BOS, EOS, UNK = 0, 1, 2
_RESERVED = 3


def get_dict(lang, dict_size, reverse=False):
    d = {"<s>": BOS, "<e>": EOS, "<unk>": UNK}
    for i in range(_RESERVED, dict_size):
        d[f"{lang}{i}"] = i
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def _perm(n, seed):
    r = common.rng(seed)
    p = np.arange(_RESERVED, n)
    r.shuffle(p)
    return p


def _make(n_pairs, src_dict_size, trg_dict_size, seed):
    r = common.rng(seed)
    usable_src = src_dict_size - _RESERVED
    perm = _perm(trg_dict_size, seed=51)
    out = []
    for _ in range(n_pairs):
        L = int(r.randint(3, 10))
        src = (r.randint(0, usable_src, L) + _RESERVED).astype("int64")
        # "translation": reverse + permute (mod the target vocab)
        trg_core = perm[(src[::-1] - _RESERVED) % len(perm)]
        trg = np.concatenate([[BOS], trg_core]).astype("int64")
        trg_next = np.concatenate([trg_core, [EOS]]).astype("int64")
        out.append((src.tolist(), trg.tolist(), trg_next.tolist()))
    return out


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return common.make_reader(_make(2048, src_dict_size, trg_dict_size, seed=52))


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return common.make_reader(_make(256, src_dict_size, trg_dict_size, seed=53))


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return common.make_reader(_make(256, src_dict_size, trg_dict_size, seed=54))
