"""MQ2007 learning-to-rank dataset (reference python/paddle/dataset/mq2007.py).

LETOR MQ2007: queries paired with candidate documents, each pair a 46-dim
feature vector with a relevance label in {0, 1, 2}.  The reference
downloads the corpus; this module, as the JAX package's, synthesizes a
deterministic, learnable stand-in (a planted linear ranking function plus
noise) with the same Query/QueryList API, text format parser, and
pointwise / pairwise / listwise generators.
"""

from __future__ import annotations

import numpy as np

from . import common

__all__ = [
    "Query", "QueryList", "gen_plain_txt", "gen_point", "gen_pair",
    "gen_list", "query_filter", "load_from_text", "train", "test", "fetch",
]

FEATURE_DIM = 46
TRAIN_QUERIES = 120
TEST_QUERIES = 30
_DOCS_PER_QUERY = 8


class Query:
    """One query-document pair: relevance label + dense features.

    Prints (and parses) the LETOR text format:
    `<rel> qid:<id> 1:<f1> 2:<f2> ... #<comment>`."""

    def __init__(self, query_id=-1, relevance_score=-1, feature_vector=None,
                 description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = list(feature_vector or [])
        self.description = description

    def __str__(self):
        feats = " ".join("%d:%.6f" % (i + 1, f)
                         for i, f in enumerate(self.feature_vector))
        return "%d qid:%d %s" % (self.relevance_score, self.query_id, feats)

    def _parse_(self, text, fill_missing=-1):
        """Parse a LETOR line into self; returns None on a malformed line."""
        comment_pos = text.find("#")
        if comment_pos >= 0:
            line, self.description = (text[:comment_pos].strip(),
                                      text[comment_pos + 1:].strip())
        else:
            line = text.strip()
        parts = line.split()
        if len(parts) < 2 or ":" not in parts[1]:
            return None
        feats = {}
        try:
            self.relevance_score = int(parts[0])
            self.query_id = int(parts[1].split(":")[1])
            for part in parts[2:]:
                idx, _, val = part.partition(":")
                feats[int(idx)] = float(val)
        except ValueError:
            return None  # malformed numeric field — skip the line
        top = max(feats) if feats else 0
        self.feature_vector = [feats.get(i + 1, fill_missing)
                               for i in range(max(top, FEATURE_DIM))]
        return self


class QueryList:
    """All candidate documents of one query_id, rankable by relevance."""

    def __init__(self, querylist=None):
        self.query_id = -1
        self.querylist = []
        for query in querylist or []:
            self._add_query(query)

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda q: q.relevance_score, reverse=True)

    def _add_query(self, query):
        if self.query_id == -1:
            self.query_id = query.query_id
        elif self.query_id != query.query_id:
            raise ValueError("query in list must share one query_id "
                             f"({self.query_id} vs {query.query_id})")
        self.querylist.append(query)


def _as_querylist(querylist):
    ql = (querylist if isinstance(querylist, QueryList)
          else QueryList(querylist))
    ql._correct_ranking_()
    return ql


def gen_plain_txt(querylist):
    """Yield (query_id, label, feature) per ranked document."""
    ql = _as_querylist(querylist)
    for query in ql:
        yield ql.query_id, query.relevance_score, np.array(
            query.feature_vector)


def gen_point(querylist):
    """Point-wise: yield (label, feature) per ranked document."""
    for query in _as_querylist(querylist):
        yield query.relevance_score, np.array(query.feature_vector)


def gen_pair(querylist, partial_order="full"):
    """Pair-wise: yield (label=1, better_doc, worse_doc) over doc pairs.

    partial_order "full" = every C(n,2) ordered pair with distinct labels;
    "neighbour" = adjacent ranks only (dedups the transitive closure)."""
    ql = _as_querylist(querylist)
    span = (1,) if partial_order == "neighbour" else range(1, len(ql))
    for gap in span:
        for i in range(len(ql) - gap):
            left, right = ql[i], ql[i + gap]
            if left.relevance_score > right.relevance_score:
                yield (np.array([1]), np.array(left.feature_vector),
                       np.array(right.feature_vector))
            elif left.relevance_score < right.relevance_score:
                yield (np.array([1]), np.array(right.feature_vector),
                       np.array(left.feature_vector))


def gen_list(querylist):
    """List-wise: yield (labels[n,1], features[n,dim]) once per query."""
    ql = _as_querylist(querylist)
    yield (np.array([[q.relevance_score] for q in ql]),
           np.array([q.feature_vector for q in ql]))


def query_filter(querylists):
    """Drop queries whose documents are all irrelevant (label sum 0) —
    they carry no ranking signal."""
    return [ql for ql in querylists
            if sum(q.relevance_score for q in ql) != 0]


def load_from_text(filepath, shuffle=False, fill_missing=-1):
    """Parse a LETOR-format text file into a list of QueryList."""
    by_id = {}
    with open(filepath) as f:
        for line in f:
            query = Query()._parse_(line, fill_missing=fill_missing)
            if query is None:
                continue
            by_id.setdefault(query.query_id, QueryList())._add_query(query)
    querylists = list(by_id.values())
    if shuffle:
        common.rng(0).shuffle(querylists)
    return querylists


def _synthetic_querylists(n_queries, seed):
    """Planted linear ranker: label = bucketed <w, x> + noise, so pairwise
    models have real signal to learn."""
    r = common.rng(seed)
    w = r.normal(size=FEATURE_DIM) / np.sqrt(FEATURE_DIM)
    querylists = []
    for qid in range(n_queries):
        ql = QueryList()
        feats = r.normal(size=(_DOCS_PER_QUERY, FEATURE_DIM))
        scores = feats @ w + 0.1 * r.normal(size=_DOCS_PER_QUERY)
        # top-2 docs get label 2, next 3 label 1, rest 0 — MQ2007's {0,1,2}
        order = np.argsort(-scores)
        labels = np.zeros(_DOCS_PER_QUERY, dtype=int)
        labels[order[:2]] = 2
        labels[order[2:5]] = 1
        for d in range(_DOCS_PER_QUERY):
            ql._add_query(Query(query_id=qid, relevance_score=int(labels[d]),
                                feature_vector=feats[d].tolist(),
                                description="synthetic doc %d" % d))
        querylists.append(ql)
    return querylists


def _reader(querylists, format="pairwise"):
    def reader():
        for querylist in query_filter(querylists):
            if format == "plain_txt":
                yield from gen_plain_txt(querylist)
            elif format == "pointwise":
                yield from gen_point(querylist)
            elif format == "pairwise":
                yield from gen_pair(querylist)
            elif format == "listwise":
                yield from gen_list(querylist)
            else:
                raise ValueError(f"unknown format {format!r}")
    return reader


def train(format="pairwise"):
    return _reader(_synthetic_querylists(TRAIN_QUERIES, seed=2007), format)


def test(format="pairwise"):
    return _reader(_synthetic_querylists(TEST_QUERIES, seed=7002), format)


def fetch():
    """Nothing to download: the synthetic corpus is generated in-process."""
    return None
