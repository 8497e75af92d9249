"""Shared helpers for synthetic dataset generation."""

from __future__ import annotations

import numpy as np


def rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed)


def make_reader(samples):
    """Wrap a materialized list of samples as a reader creator."""

    def reader():
        return iter(samples)

    return reader


def class_blobs(n, n_classes, dim, seed, spread=3.0, noise=1.0):
    """Gaussian blob per class — linearly separable-ish features."""
    r = rng(seed)
    centers = r.uniform(-spread, spread, (n_classes, dim)).astype("float32")
    labels = r.randint(0, n_classes, n)
    feats = centers[labels] + noise * r.randn(n, dim).astype("float32")
    return feats.astype("float32"), labels.astype("int64")
