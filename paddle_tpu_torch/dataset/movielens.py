"""MovieLens-shaped synthetic dataset
(reference python/paddle/dataset/movielens.py — recommender_system book test).

Samples: (user_id, gender_id, age_id, job_id, movie_id, category_ids[list],
title_ids[list], score: float).  A low-rank latent model generates scores so
the recommender net has structure to learn.
"""

from __future__ import annotations

import numpy as np

from . import common

_N_USERS = 128
_N_MOVIES = 256
_N_JOBS = 21
_N_AGES = 7
_N_CATEGORIES = 18
_TITLE_VOCAB = 512
_RANK = 6


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return _N_JOBS - 1


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def movie_categories():
    return {f"cat{i}": i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(_TITLE_VOCAB)}


def _latent():
    r = common.rng(31)
    u = r.randn(_N_USERS + 1, _RANK).astype("float32")
    m = r.randn(_N_MOVIES + 1, _RANK).astype("float32")
    return u, m


def _user_meta():
    r = common.rng(32)
    gender = r.randint(0, 2, _N_USERS + 1)
    age = r.randint(0, _N_AGES, _N_USERS + 1)
    job = r.randint(0, _N_JOBS, _N_USERS + 1)
    return gender, age, job


def _movie_meta():
    r = common.rng(33)
    cats = [sorted(set(r.randint(0, _N_CATEGORIES, r.randint(1, 4)).tolist()))
            for _ in range(_N_MOVIES + 1)]
    titles = [r.randint(0, _TITLE_VOCAB, r.randint(2, 6)).astype("int64").tolist()
              for _ in range(_N_MOVIES + 1)]
    return cats, titles


def _make(n, seed):
    u, m = _latent()
    gender, age, job = _user_meta()
    cats, titles = _movie_meta()
    r = common.rng(seed)
    uid = r.randint(1, _N_USERS + 1, n)
    mid = r.randint(1, _N_MOVIES + 1, n)
    raw = (u[uid] * m[mid]).sum(axis=1)
    score = np.clip(3.0 + raw + 0.2 * r.randn(n), 1.0, 5.0).astype("float32")
    out = []
    for i in range(n):
        out.append((
            int(uid[i]), int(gender[uid[i]]), int(age[uid[i]]), int(job[uid[i]]),
            int(mid[i]), [int(c) for c in cats[mid[i]]],
            [int(t) for t in titles[mid[i]]], float(score[i]),
        ))
    return out


def train():
    return common.make_reader(_make(2048, seed=34))


def test():
    return common.make_reader(_make(512, seed=35))
