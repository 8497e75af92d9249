"""The book lane's ops, readers and datasets in the PyTorch port against
the JAX package, on the CPU.

Ops: ``expand``, ``squeeze2``, ``unsqueeze2`` (and ``squeeze``,
``unsqueeze``), ``dot``, ``l2_normalize``, the 14 ``sequence_*`` ops,
``lstm``, ``gru``, ``lstm_unit``, ``gru_unit``, ``cos_sim``,
``linear_chain_crf`` and ``crf_decoding``, and every differentiable
one's grad op (derived in both registries), through both registries
(``get_op(t).lower``) on the same seeded numpy inputs, compared by
value (the JAX side runs with x64 off, so its int64s are int32; labels
and lengths are compared as values, not dtypes).  The cases cover
lengths 1, T and mixed, a MAX-pool tie (the grad split among tied
maxima in both), a planted Viterbi tie (the first tag in both),
``is_reverse`` and ``origin_mode``, peepholes, a cell clip, and a
one-row ``Y`` for ``cos_sim``.  Tolerances, each stated with its case:
0 for integer outputs and data movement; 1e-6 for fp32 elementwise
math; 1e-5 for reductions and for the recurrences over T <= 40 (the
same fp32 math, summed or chained in another order).

Readers and datasets: every sample of every reader creator of the 16
``dataset`` modules, and every decorator of ``reader.py`` over them,
equal to the JAX package's exactly.  The decorators that start threads
(``buffered``, ``xmap_readers``, ``multiprocess_reader``) are drained
on a thread joined with a timeout, so a hang fails its test rather
than the suite's clock.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import importlib
import itertools
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import registry as jreg

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch.fluid import registry as treg

EXACT, ELEM, RED = 0.0, 1e-6, 1e-5


def _run_jax(op_type, inputs, attrs):
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    vals = [None if a is None else
            [jnp.asarray(x) for x in a] if isinstance(a, list) else
            jnp.asarray(a) for a in inputs]
    out = jreg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _run_port(op_type, inputs, attrs):
    ctx = treg.LowerContext("cpu")
    vals = [None if a is None else
            [torch.from_numpy(np.array(x)) for x in a] if isinstance(a, list)
            else torch.from_numpy(np.array(a)) for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _flat(outs):
    """Outputs with a variadic (list) output spread into its items."""
    return [x for o in outs
            for x in (o if isinstance(o, (list, tuple)) else [o])]


def _compare(op_type, inputs, attrs, tol):
    got = _flat(_run_port(op_type, inputs, attrs))
    want = _flat(_run_jax(op_type, inputs, attrs))
    assert len(got) == len(want), op_type
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            # an output one side leaves unset must be one the other
            # computes as zeros (a grad of a non-differentiated input)
            assert g is None and w is None or np.all(
                np.asarray(w if g is None else g) == 0), (op_type, i)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (op_type, i, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{op_type} output {i}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{op_type} output {i}")


r = np.random.RandomState(0)


def _f(*shape, scale=1.0):
    return np.asarray(r.randn(*shape) * scale, np.float32)


def _i(lo, hi, *shape, dtype=np.int64):
    return r.randint(lo, hi, shape).astype(dtype)


B, T, D = 4, 7, 5
_LEN = np.array([7, 1, 4, 7], np.int32)      # T, 1 and mixed
_LEN64 = _LEN.astype(np.int64)
# a MAX-pool tie: rows whose valid steps hold equal values (as the
# padded steps of a sequence_conv -> tanh do), and a length-1 row
_tie = _f(B, T, D)
_tie[0, 2] = _tie[0, 5] = _tie[0].max(axis=0) + 1.0
_tie[2, 1, :] = _tie[2, 3, :] = 2.0
_tie[3, :, 1] = 0.25

# a planted Viterbi tie: integer-valued emissions and transitions sum
# exactly, so many paths score alike and argmax must take the first
_C = 6
_vit_em = r.randint(0, 3, (B, T, _C)).astype(np.float32)
_vit_tr = r.randint(-1, 2, (_C + 2, _C)).astype(np.float32)
_crf_label = _i(0, _C, B, T)


def _lstm_ins(d, peep, h0=False):
    ins = [_f(B, T, 4 * d, scale=0.5), _f(d, 4 * d, scale=0.5),
           _f(1, 7 * d if peep else 4 * d, scale=0.5)]
    ins += [_f(B, d) if h0 else None, _f(B, d) if h0 else None]
    return ins


def _gru_ins(d, h0=False):
    return [_f(B, T, 3 * d, scale=0.5), _f(d, 3 * d, scale=0.5),
            _f(1, 3 * d, scale=0.5), _f(B, d) if h0 else None]


_LSTM = {"gate_activation": "sigmoid", "cell_activation": "tanh",
         "candidate_activation": "tanh"}

# name: (op type, inputs, attrs, tolerance)
CASES = {
    # -- tensor ops --------------------------------------------------------
    "expand": ("expand", [_f(2, 1, 3)], {"expand_times": [1, 4, 2]}, EXACT),
    "expand_fewer_times": ("expand", [_f(2, 3)], {"expand_times": [3]},
                           EXACT),
    "squeeze2_axes": ("squeeze2", [_f(2, 1, 3, 1)], {"axes": [1, -1]},
                      EXACT),
    "squeeze2_all": ("squeeze2", [_f(1, 3, 1)], {}, EXACT),
    "squeeze": ("squeeze", [_f(2, 1, 3)], {"axes": [1]}, EXACT),
    "unsqueeze2": ("unsqueeze2", [_f(2, 3)], {"axes": [2, 0]}, EXACT),
    "unsqueeze": ("unsqueeze", [_f(2, 3)], {"axes": [1]}, EXACT),
    "dot": ("dot", [_f(4, 6), _f(4, 6)], {}, RED),
    "l2_normalize": ("l2_normalize", [_f(4, 6)], {"axis": -1}, RED),
    "cos_sim": ("cos_sim", [_f(4, 6), _f(4, 6)], {}, RED),
    "cos_sim_one_row_y": ("cos_sim", [_f(4, 2, 3), _f(1, 6)], {}, RED),
    # -- sequence ops ------------------------------------------------------
    "sequence_conv": ("sequence_conv", [_f(B, T, D), _f(3 * D, 8), _LEN],
                      {"contextLength": 3, "contextStart": -1}, RED),
    "sequence_conv_no_length_ctx4": (
        "sequence_conv", [_f(B, T, D), _f(4 * D, 8), None],
        {"contextLength": 4, "contextStart": -2}, RED),
    **{f"sequence_pool_{p.lower()}": (
        "sequence_pool", [_tie, _LEN], {"pooltype": p}, RED)
       for p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST")},
    **{f"sequence_pool_{p.lower()}_no_length": (
        "sequence_pool", [_tie, None], {"pooltype": p}, RED)
       for p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST")},
    "sequence_softmax": ("sequence_softmax", [_f(B, T), _LEN], {}, RED),
    "sequence_softmax_3d": ("sequence_softmax", [_f(B, T, 1), _LEN], {},
                            RED),
    "sequence_expand": ("sequence_expand", [_f(B, D), _f(B, T, 2)], {},
                        EXACT),
    "sequence_expand_as": ("sequence_expand_as", [_f(B, D), _f(B, T)], {},
                           EXACT),
    "sequence_reverse": ("sequence_reverse", [_f(B, T, D), _LEN], {},
                         EXACT),
    "sequence_reverse_no_length": ("sequence_reverse", [_f(B, T, D), None],
                                   {}, EXACT),
    "sequence_last_step": ("sequence_last_step", [_f(B, T, D), _LEN], {},
                           EXACT),
    "sequence_first_step": ("sequence_first_step", [_f(B, T, D), _LEN], {},
                            EXACT),
    "sequence_mask": ("sequence_mask", [_LEN],
                      {"maxlen": 9, "out_dtype": "float32"}, EXACT),
    "sequence_mask_int64": ("sequence_mask", [_LEN64],
                            {"maxlen": T, "out_dtype": "int64"}, EXACT),
    "sequence_pad": ("sequence_pad", [_f(B, T, D), _f(1), _LEN], {}, EXACT),
    "sequence_pad_no_length": ("sequence_pad", [_f(B, T, D), _f(1), None],
                               {}, EXACT),
    "sequence_unpad": ("sequence_unpad", [_f(B, T, D), _LEN], {}, EXACT),
    "sequence_unpad_2d": ("sequence_unpad", [_f(B, T), _LEN], {}, EXACT),
    "sequence_concat": ("sequence_concat",
                        [[_f(B, T, D), _f(B, 3, D)],
                         [_LEN, np.array([3, 0, 2, 1], np.int32)]], {},
                        EXACT),
    "sequence_concat_no_length": ("sequence_concat",
                                  [[_f(B, T, D), _f(B, 3, D)], []], {},
                                  EXACT),
    "sequence_slice": ("sequence_slice",
                       [_f(B, T, D), np.array([0, 2, 5, 6], np.int64),
                        np.array([3, 2, 2, 3], np.int64)], {}, EXACT),
    "sequence_enumerate": ("sequence_enumerate", [_i(0, 50, B, T), _LEN],
                           {"win_size": 3, "pad_value": -1}, EXACT),
    "sequence_enumerate_no_length": ("sequence_enumerate",
                                     [_i(0, 50, B, T), None],
                                     {"win_size": 2}, EXACT),
    # -- recurrences -------------------------------------------------------
    "lstm": ("lstm", _lstm_ins(4, False) + [_LEN],
             {**_LSTM, "use_peepholes": False}, RED),
    "lstm_peepholes_reverse_h0": (
        "lstm", _lstm_ins(4, True, h0=True) + [_LEN],
        {**_LSTM, "use_peepholes": True, "is_reverse": True}, RED),
    "lstm_no_length_cell_clip": (
        "lstm", _lstm_ins(3, True) + [None],
        {**_LSTM, "use_peepholes": True, "cell_clip": 0.3}, RED),
    "lstm_long": ("lstm", [_f(2, 40, 16, scale=0.5), _f(4, 16, scale=0.5),
                           _f(1, 16), None, None,
                           np.array([40, 23], np.int32)],
                  {**_LSTM, "use_peepholes": False, "is_reverse": True},
                  RED),
    "gru": ("gru", _gru_ins(4) + [_LEN], {}, RED),
    "gru_origin_mode_reverse_h0": ("gru", _gru_ins(4, h0=True) + [_LEN],
                                   {"origin_mode": True, "is_reverse": True},
                                   RED),
    "gru_no_length_int_acts": ("gru", _gru_ins(3) + [None],
                               {"gate_activation": 1, "activation": 3}, RED),
    "lstm_unit": ("lstm_unit", [_f(B, 4 * D), _f(B, D)],
                  {"forget_bias": 1.0}, ELEM),
    "gru_unit": ("gru_unit", [_f(B, 3 * D), _f(B, D), _f(D, 3 * D),
                              _f(1, 3 * D)], {}, RED),
    "gru_unit_origin_mode_no_bias": (
        "gru_unit", [_f(B, 3 * D), _f(B, D), _f(D, 3 * D), None],
        {"origin_mode": True}, RED),
    # -- CRF ----------------------------------------------------------------
    "linear_chain_crf": ("linear_chain_crf",
                         [_f(B, T, _C), _f(_C + 2, _C, scale=0.5),
                          _crf_label, _LEN64], {}, RED),
    "linear_chain_crf_no_length": ("linear_chain_crf",
                                   [_f(B, T, _C), _f(_C + 2, _C),
                                    _crf_label, None], {}, RED),
    "crf_decoding": ("crf_decoding", [_f(B, T, _C), _f(_C + 2, _C), None,
                                      _LEN64], {}, EXACT),
    "crf_decoding_planted_tie": ("crf_decoding",
                                 [_vit_em, _vit_tr, None, _LEN], {}, EXACT),
    "crf_decoding_no_length_tie": ("crf_decoding",
                                   [_vit_em, _vit_tr, None, None], {}, EXACT),
    "crf_decoding_label": ("crf_decoding", [_vit_em, _vit_tr, _crf_label,
                                            _LEN64], {}, EXACT),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    op_type, inputs, attrs, tol = CASES[name]
    _compare(op_type, inputs, attrs, tol)


def test_planted_viterbi_tie_is_a_tie():
    """The tie case does tie: some step's best previous tag is not
    unique, so the first-index rule decides the path."""
    em, tr = _vit_em, _vit_tr
    v = tr[0] + em[:, 0]
    ties = 0
    for s in range(1, T):
        cand = v[:, :, None] + tr[2:][None]
        ties += int(((cand == cand.max(axis=1, keepdims=True)).sum(1)
                     > 1).sum())
        v = em[:, s] + cand.max(axis=1)
    assert ties > 0


# grads that sum what their forward copied (the tiles of an expand): the
# sums run in another order
_SUMMING_GRADS = ("expand", "expand_fewer_times", "sequence_expand",
                  "sequence_expand_as")


def _grad_case(fwd_type, inputs, attrs, tol, seed=1):
    """The ``<fwd_type>_grad`` op on ``inputs`` and seeded cotangents of
    every float output (None for an output JAX leaves None)."""
    outs = _run_jax(fwd_type, inputs, attrs)
    rs = np.random.RandomState(seed)
    cots = [None if o is None or not np.issubdtype(np.asarray(o).dtype,
                                                   np.floating)
            else np.asarray(rs.randn(*np.shape(o)), np.float32)
            for o in outs]
    return (fwd_type + "_grad", list(inputs) + cots, attrs, tol)


GRAD_CASES = {
    name: _grad_case(*CASES[name][:3], RED if name in _SUMMING_GRADS
                     else CASES[name][3]) for name in (
        "expand", "expand_fewer_times", "squeeze2_axes", "unsqueeze2",
        "dot", "l2_normalize", "cos_sim", "cos_sim_one_row_y",
        "sequence_conv", "sequence_conv_no_length_ctx4",
        "sequence_pool_average", "sequence_pool_sum", "sequence_pool_sqrt",
        "sequence_pool_max", "sequence_pool_last", "sequence_pool_first",
        "sequence_pool_max_no_length", "sequence_softmax",
        "sequence_softmax_3d", "sequence_expand", "sequence_expand_as",
        "sequence_reverse", "sequence_last_step", "sequence_first_step",
        "sequence_pad", "sequence_unpad", "sequence_concat",
        "sequence_slice", "lstm", "lstm_peepholes_reverse_h0",
        "lstm_no_length_cell_clip", "lstm_long", "gru",
        "gru_origin_mode_reverse_h0", "gru_no_length_int_acts",
        "lstm_unit", "gru_unit", "gru_unit_origin_mode_no_bias",
        "linear_chain_crf", "linear_chain_crf_no_length")}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_grad_op_matches_jax(name):
    op_type, inputs, attrs, tol = GRAD_CASES[name]
    _compare(op_type, inputs, attrs, tol)


def test_max_pool_tie_splits_the_grad():
    """At a tie of the valid maxima the grad is split equally among the
    tied steps (as jnp.max's is; torch.max(dim=) would send it all to
    one), and masked steps take none."""
    x = np.zeros((1, 4, 1), np.float32)
    x[0, 1, 0] = x[0, 2, 0] = 3.0
    length = np.array([3], np.int32)
    dout = np.ones((1, 1), np.float32)
    (dx, _) = _run_port("sequence_pool_grad", [x, length, dout, None],
                        {"pooltype": "MAX"})
    np.testing.assert_array_equal(dx.numpy()[0, :, 0], [0, 0.5, 0.5, 0])


def test_crf_alpha_and_exps_outputs():
    """linear_chain_crf keeps its four outputs: Alpha [B,T,C], the
    emissions' softmax, exp(Transition) and the NLL [B,1]."""
    em, tr, lbl = _f(B, T, _C), _f(_C + 2, _C), _crf_label
    alpha, em_exps, tr_exps, nll = _run_port(
        "linear_chain_crf", [em, tr, lbl, _LEN64], {})
    assert tuple(alpha.shape) == (B, T, _C)
    np.testing.assert_allclose(em_exps.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(tr_exps.numpy(), np.exp(tr), rtol=1e-6)
    assert tuple(nll.shape) == (B, 1) and (nll.numpy() > 0).all()


# ---------------------------------------------------------------------------
# datasets and readers
# ---------------------------------------------------------------------------


def _same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{k}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_samples(jreader, treader, where, limit=None):
    n = 0
    sentinel = object()
    jit, tit = iter(jreader()), iter(treader())
    for n in itertools.count():
        if limit is not None and n >= limit:
            return n
        a, b = next(jit, sentinel), next(tit, sentinel)
        if a is sentinel or b is sentinel:
            assert a is b, f"{where}: lengths differ at {n}"
            return n
        _same(a, b, f"{where} sample {n}")


# (module, creator, args): every reader creator of the 16 modules
CREATORS = [
    ("cifar", "train10", ()), ("cifar", "test10", ()),
    ("cifar", "train100", ()), ("cifar", "test100", ()),
    ("conll05", "train", ()), ("conll05", "test", ()),
    ("flowers", "train", ()), ("flowers", "test", ()),
    ("flowers", "valid", ()),
    ("imdb", "train", ()), ("imdb", "test", ()),
    ("imikolov", "train", ("dict", 5)), ("imikolov", "test", ("dict", 3)),
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("movielens", "train", ()), ("movielens", "test", ()),
    *[("mq2007", split, (fmt,)) for split in ("train", "test")
      for fmt in ("plain_txt", "pointwise", "pairwise", "listwise")],
    ("sentiment", "train", ()), ("sentiment", "test", ()),
    ("uci_housing", "train", ()), ("uci_housing", "test", ()),
    ("voc2012", "train", ()), ("voc2012", "test", ()),
    ("voc2012", "val", ()),
    ("wmt14", "train", (64,)), ("wmt14", "test", (64,)),
    ("wmt14", "validation", (64,)),
    ("wmt16", "train", (64, 80)), ("wmt16", "test", (64, 80)),
    ("wmt16", "validation", (64, 80, "de")),
]


def _module(paddle, name):
    return importlib.import_module(f"{paddle.__name__}.dataset.{name}")


def _args(paddle, mod, args):
    return tuple(_module(paddle, mod).build_dict() if a == "dict" else a
                 for a in args)


@pytest.mark.parametrize("mod,creator,args", CREATORS,
                         ids=[f"{m}.{c}{''.join('_' + str(a) for a in x)}"
                              for m, c, x in CREATORS])
def test_dataset_samples_equal_jax(mod, creator, args):
    jr = getattr(_module(jpaddle, mod), creator)(*_args(jpaddle, mod, args))
    tr = getattr(_module(tpaddle, mod), creator)(*_args(tpaddle, mod, args))
    assert _same_samples(jr, tr, f"{mod}.{creator}") > 0


# the dictionaries, tables and helpers (the datasets' other public API)
TABLES = [
    ("conll05", "get_dict", ()), ("conll05", "get_embedding", ()),
    ("imdb", "word_dict", ()), ("imikolov", "build_dict", ()),
    ("movielens", "max_user_id", ()), ("movielens", "max_movie_id", ()),
    ("movielens", "max_job_id", ()), ("movielens", "age_table", ()),
    ("movielens", "movie_categories", ()),
    ("movielens", "get_movie_title_dict", ()),
    ("sentiment", "get_word_dict", ()),
    ("wmt14", "get_dict", (64,)), ("wmt14", "get_dict", (64, True)),
    ("wmt16", "get_dict", ("en", 64)), ("wmt16", "get_dict", ("de", 80, True)),
    ("mq2007", "fetch", ()),
    ("common", "class_blobs", (50, 3, 4, 7)),
]


@pytest.mark.parametrize("mod,fn,args", TABLES,
                         ids=[f"{m}.{f}{len(a)}" for m, f, a in TABLES])
def test_dataset_tables_equal_jax(mod, fn, args):
    _same(getattr(_module(jpaddle, mod), fn)(*args),
          getattr(_module(tpaddle, mod), fn)(*args), f"{mod}.{fn}")


def test_dataset_image_transforms_equal_jax():
    """dataset.image: the numpy transforms on one seeded HWC image."""
    im = (np.random.RandomState(3).rand(40, 60, 3) * 255).astype(np.uint8)
    ji, ti = _module(jpaddle, "image"), _module(tpaddle, "image")
    for name, args in (("resize_short", (im, 32)), ("to_chw", (im,)),
                       ("center_crop", (im, 24)),
                       ("left_right_flip", (im,)),
                       ("simple_transform", (im, 32, 24, False))):
        _same(getattr(ji, name)(*args), getattr(ti, name)(*args), name)
    np.random.seed(5)
    want = ji.random_crop(im, 24)
    np.random.seed(5)
    _same(want, ti.random_crop(im, 24), "random_crop")
    np.random.seed(6)
    want = ji.simple_transform(im, 32, 24, True)
    np.random.seed(6)
    _same(want, ti.simple_transform(im, 32, 24, True), "simple_transform")


def test_dataset_package_lists_all_modules():
    jmods, tmods = jpaddle.dataset.__all__, tpaddle.dataset.__all__
    assert sorted(tmods) == sorted(jmods) and len(tmods) == 15
    for m in tmods:  # each module and the package itself: 16
        assert getattr(tpaddle.dataset, m).__name__.startswith(
            "paddle_tpu_torch.dataset")


def _drain(reader, timeout=60):
    """Every sample of ``reader`` drained on a thread that must finish
    within ``timeout`` seconds."""
    out, err = [], []

    def run():
        try:
            out.extend(reader())
        except BaseException as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "reader hung"
    if err:
        raise err[0]
    return out


def _decorated(paddle, name):
    """{decorator case: reader creator} built with ``paddle``'s
    ``reader`` over its ``dataset``."""
    rd, ds = paddle.reader, paddle.dataset
    imdb, uci = ds.imdb.train(), ds.uci_housing.test()
    first = rd.firstn(imdb, 40)
    return {
        "batch": paddle.batch(first, 7),
        "batch_drop_last": paddle.batch(first, 7, drop_last=True),
        "shuffle": rd.shuffle(first, 16, seed=3),
        "buffered": rd.buffered(first, 5),
        "cache": rd.cache(first),
        "chain": rd.chain(first, rd.firstn(uci, 5)),
        "compose": rd.compose(rd.firstn(uci, 9), rd.firstn(imdb, 9)),
        "map_readers": rd.map_readers(lambda a, b: (len(a[0]), b[1]),
                                      first, rd.firstn(uci, 40)),
        "firstn": first,
        "xmap_readers_ordered": rd.xmap_readers(
            lambda s: (sum(s[0]), s[1]), first, 3, 4, order=True),
        "np_array": rd.creator.np_array(np.arange(12).reshape(4, 3)),
    }[name]


DECORATORS = ["batch", "batch_drop_last", "shuffle", "buffered", "cache",
              "chain", "compose", "map_readers", "firstn",
              "xmap_readers_ordered", "np_array"]


@pytest.mark.parametrize("name", DECORATORS)
def test_reader_decorator_equals_jax(name):
    want = _drain(_decorated(jpaddle, name))
    got = _drain(_decorated(tpaddle, name))
    assert len(got) == len(want) > 0
    _same(got, want, name)


def test_reader_unordered_xmap_and_multiprocess_give_the_same_multiset():
    """xmap_readers without order and multiprocess_reader interleave
    their workers' samples: the same samples as the JAX package's, in
    some order."""
    def key(s):
        return repr(s)

    for paddle_pair in ((jpaddle, tpaddle),):
        outs = []
        for paddle in paddle_pair:
            rd, ds = paddle.reader, paddle.dataset
            a = rd.firstn(ds.imdb.train(), 30)
            b = rd.firstn(ds.imdb.test(), 20)
            outs.append((
                sorted(map(key, _drain(rd.xmap_readers(
                    lambda s: (s[1], len(s[0])), a, 4, 8)))),
                sorted(map(key, _drain(rd.multiprocess_reader([a, b])))),
            ))
        assert outs[0] == outs[1]
        assert len(outs[1][0]) == 30 and len(outs[1][1]) == 50


def test_reader_errors_reach_the_consumer():
    """A source reader's error is raised in the consumer of buffered,
    xmap_readers and multiprocess_reader, not lost on their threads."""
    rd = tpaddle.reader

    def bad():
        yield 1
        raise RuntimeError("source failed")

    for wrapped in (rd.buffered(bad, 2), rd.xmap_readers(lambda s: s, bad, 2),
                    rd.multiprocess_reader([bad])):
        with pytest.raises(RuntimeError, match="source failed"):
            _drain(wrapped)
    with pytest.raises(rd.ComposeNotAligned):
        _drain(rd.compose(rd.firstn(bad, 1), lambda: iter([1, 2])))


def test_reader_text_file_and_recordio(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("a\nbb\n\nccc\n")
    assert (_drain(tpaddle.reader.creator.text_file(str(p)))
            == _drain(jpaddle.reader.creator.text_file(str(p))))
    with pytest.raises(NotImplementedError, match="native RecordIO"):
        tpaddle.reader.creator.recordio(str(p))


def test_fake_reader_replays_the_first_sample():
    fake = tpaddle.reader.Fake()
    got = _drain(fake(tpaddle.dataset.uci_housing.test(), 4))
    want = _drain(jpaddle.reader.Fake()(jpaddle.dataset.uci_housing.test(),
                                        4))
    _same(got, want, "Fake")
