"""WMT14-shaped synthetic translation dataset (reference
python/paddle/dataset/wmt14.py).

Same reader contract as the reference: train(dict_size) yields
(src_ids, trg_ids, trg_next_ids); dicts via get_dict(dict_size).
Reuses the deterministic reverse+permute "translation" of wmt16 so seq2seq
models converge."""

from __future__ import annotations

from . import wmt16

START, END, UNK = wmt16.BOS, wmt16.EOS, wmt16.UNK


def get_dict(dict_size, reverse=False):
    src = wmt16.get_dict("en", dict_size, reverse=reverse)
    trg = wmt16.get_dict("fr", dict_size, reverse=reverse)
    return src, trg


def train(dict_size):
    return wmt16.train(dict_size, dict_size)


def test(dict_size):
    return wmt16.test(dict_size, dict_size)


def validation(dict_size):
    return wmt16.validation(dict_size, dict_size)
