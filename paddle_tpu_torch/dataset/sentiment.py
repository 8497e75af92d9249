"""Movie-review sentiment dataset, NLTK-corpus-shaped (reference
python/paddle/dataset/sentiment.py).

Samples: (word_ids[list], label in {0,1}).  Delegates to the imdb-shaped
generator (same contract), exposing the reference's function names."""

from __future__ import annotations

from . import imdb


def get_word_dict():
    return sorted(imdb.word_dict().items(), key=lambda kv: kv[1])


def train():
    return imdb.train()


def test():
    return imdb.test()
