"""The book programs (tests/book/), written once for either package.

Each book's program, reader, optimizer, epochs and loss threshold are
those of its script under tests/book/.  ``paddle`` is the package the
program is built with: ``paddle_tpu`` (the JAX package) or
``paddle_tpu_torch`` (the port); this module imports neither, so the
port's tests and chip_smoke.py use it without jax.

``BOOKS`` maps a book's name to a :class:`Book`.  The attention-fusion
Transformer book (tests/book/test_transformer_attention_fusion.py) is
``transformer_fusion``: its reader is one fixed batch, trained 8 steps.
"""

from __future__ import annotations

import importlib

import numpy as np

__all__ = ["Book", "BOOKS", "train_feeds", "first_feed", "pad_ids",
           "ctr_clicks", "mt_build_decode", "mt_build_decode_while"]


class Book:
    """One book program.

    build(paddle) -> (feeds, loss, predict) appends the program to the
    default main and startup programs; reader(paddle) is a creator of
    feed dicts (one epoch); optimizer(paddle) makes the optimizer;
    check(losses) raises AssertionError when the book's own threshold
    is missed; feed_names are the inference model's feeds."""

    def __init__(self, name, build, reader, epochs, optimizer, check,
                 feed_names=None, batch=None, graph_passes=None):
        self.name = name
        self.build = build
        self.reader = reader
        self.epochs = epochs
        self.optimizer = optimizer
        self.check = check
        self.feed_names = feed_names
        self.batch = batch
        self.graph_passes = graph_passes


def _adam(lr):
    return lambda paddle: paddle.fluid.optimizer.Adam(learning_rate=lr)


def _batched(dataset_reader, batch_size, to_feed):
    """A creator of feed dicts over ``dataset_reader``'s batches
    (drop_last, as the book harness batches)."""

    def make(paddle):
        def gen():
            for b in paddle.batch(dataset_reader(paddle), batch_size,
                                  drop_last=True)():
                yield to_feed(b)

        return gen

    return make


def _tail(losses, n):
    return float(np.mean(losses[-n:]))


def _below(threshold, n=5):
    """The harness's own gate: the mean of the last ``n`` losses under
    ``threshold``."""

    def check(losses):
        tail = _tail(losses, n)
        assert tail < threshold, (
            f"loss {tail} (first {losses[0]}) above {threshold}")

    return check


def _all(*checks):
    def check(losses):
        for c in checks:
            c(losses)

    return check


def _falls(losses):
    assert losses[-1] < losses[0], (losses[0], losses[-1])


def pad_ids(ids, length, pad=0):
    out = np.full(length, pad, dtype="int64")
    n = min(len(ids), length)
    out[:n] = ids[:n]
    return out, n


def _image_feed(batch):
    return {"img": np.stack([s[0] for s in batch]).astype("float32"),
            "label": np.array([[s[1]] for s in batch], dtype="int64")}


# ---------------------------------------------------------------------------
# 01 fit_a_line
# ---------------------------------------------------------------------------


def _fit_a_line(paddle):
    fluid = paddle.fluid
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, act=None)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return [x], loss, pred


def _fit_a_line_feed(batch):
    return {"x": np.stack([s[0] for s in batch]),
            "y": np.stack([s[1] for s in batch])}


# ---------------------------------------------------------------------------
# 02 recognize_digits
# ---------------------------------------------------------------------------


def _classifier_tail(fluid, feature, label):
    logits = fluid.layers.fc(input=feature, size=10)
    sm = fluid.layers.softmax(logits)
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=sm, label=label))
    return sm, loss


def _digits_mlp(paddle):
    fluid = paddle.fluid
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h1 = fluid.layers.fc(input=img, size=128, act="relu")
    h2 = fluid.layers.fc(input=h1, size=64, act="relu")
    pred, loss = _classifier_tail(fluid, h2, label)
    return [img], loss, pred


def _digits_conv(paddle):
    fluid = paddle.fluid
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    img4 = fluid.layers.reshape(img, shape=[-1, 1, 28, 28])
    c1 = fluid.nets.simple_img_conv_pool(
        input=img4, filter_size=5, num_filters=8, pool_size=2,
        pool_stride=2, act="relu")
    c2 = fluid.nets.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=16, pool_size=2,
        pool_stride=2, act="relu")
    flat = fluid.layers.flatten(c2, axis=1)
    pred, loss = _classifier_tail(fluid, flat, label)
    return [img], loss, pred


# ---------------------------------------------------------------------------
# 03 image_classification
# ---------------------------------------------------------------------------


def _image_vgg(paddle):
    fluid = paddle.fluid
    img = fluid.layers.data(name="img", shape=[3072], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    x = fluid.layers.reshape(img, shape=[-1, 3, 32, 32])
    g1 = fluid.nets.img_conv_group(
        x, conv_num_filter=[8, 8], pool_size=2, conv_act="relu",
        conv_with_batchnorm=True, pool_stride=2)
    g2 = fluid.nets.img_conv_group(
        g1, conv_num_filter=[16, 16], pool_size=2, conv_act="relu",
        conv_with_batchnorm=True, pool_stride=2)
    flat = fluid.layers.flatten(g2, axis=1)
    fc1 = fluid.layers.fc(input=flat, size=64, act="relu")
    pred, loss = _classifier_tail(fluid, fc1, label)
    return [img], loss, pred


def _image_resnet(paddle):
    fluid = paddle.fluid
    resnet = importlib.import_module(paddle.__name__ + ".models.resnet")
    img = fluid.layers.data(name="img", shape=[3072], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    x = fluid.layers.reshape(img, shape=[-1, 3, 32, 32])
    c = resnet.conv_bn_layer(x, 8, 3, stride=1, act="relu", name="c0")
    b1 = resnet.basic_block(c, 8, 1, name="b1")
    b2 = resnet.basic_block(b1, 16, 2, name="b2")
    pool = fluid.layers.pool2d(b2, pool_type="avg", global_pooling=True)
    flat = fluid.layers.flatten(pool, axis=1)
    pred, loss = _classifier_tail(fluid, flat, label)
    return [img], loss, pred


# ---------------------------------------------------------------------------
# 04 word2vec
# ---------------------------------------------------------------------------

W2V_EMB, W2V_N = 32, 5


def _word2vec(paddle):
    fluid = paddle.fluid
    vocab = len(paddle.dataset.imikolov.build_dict())
    words = [fluid.layers.data(name=f"w{i}", shape=[1], dtype="int64")
             for i in range(W2V_N - 1)]
    target = fluid.layers.data(name="target", shape=[1], dtype="int64")
    embs = [fluid.layers.embedding(
        input=w, size=[vocab, W2V_EMB],
        param_attr=fluid.ParamAttr(name="shared_emb")) for w in words]
    concat = fluid.layers.concat(input=embs, axis=1)
    hidden = fluid.layers.fc(input=concat, size=128, act="sigmoid")
    sm = fluid.layers.fc(input=hidden, size=vocab, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=sm, label=target))
    return words, loss, sm


def _word2vec_feed(batch):
    arr = np.asarray(batch, dtype="int64")
    feed = {f"w{i}": arr[:, i:i + 1] for i in range(W2V_N - 1)}
    feed["target"] = arr[:, W2V_N - 1:W2V_N]
    return feed


def _imikolov(paddle):
    ds = paddle.dataset.imikolov
    return ds.train(ds.build_dict(), W2V_N)


# ---------------------------------------------------------------------------
# 09 ctr (local)
# ---------------------------------------------------------------------------

CTR_USERS, CTR_ITEMS, CTR_EMB, CTR_DENSE = 100, 200, 16, 4


def _ctr(paddle):
    fluid = paddle.fluid
    user = fluid.layers.data(name="user_id", shape=[1], dtype="int64")
    item = fluid.layers.data(name="item_id", shape=[1], dtype="int64")
    dense = fluid.layers.data(name="dense", shape=[CTR_DENSE],
                              dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    emb_u = fluid.layers.embedding(user, size=[CTR_USERS, CTR_EMB],
                                   is_sparse=True)
    emb_i = fluid.layers.embedding(item, size=[CTR_ITEMS, CTR_EMB],
                                   is_sparse=True)
    merged = fluid.layers.concat([emb_u, emb_i, dense], axis=1)
    hidden = fluid.layers.fc(merged, size=32, act="relu")
    predict = fluid.layers.fc(hidden, size=2, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=predict, label=label))
    return [user, item, dense, label], loss, predict


def ctr_clicks(n_batches=30, batch=32, seed=0):
    """The ctr book's synthetic clicks: driven by latent user and item
    affinities and the dense features."""
    rng = np.random.RandomState(seed)
    wu = rng.randn(CTR_USERS).astype("float32")
    wi = rng.randn(CTR_ITEMS).astype("float32")
    wd = rng.randn(CTR_DENSE).astype("float32")
    out = []
    for _ in range(n_batches):
        u = rng.randint(0, CTR_USERS, (batch, 1)).astype("int64")
        i = rng.randint(0, CTR_ITEMS, (batch, 1)).astype("int64")
        d = rng.randn(batch, CTR_DENSE).astype("float32")
        score = wu[u[:, 0]] + wi[i[:, 0]] + d @ wd
        y = (score > 0).astype("int64")[:, None]
        out.append({"user_id": u, "item_id": i, "dense": d, "label": y})
    return out


def _ctr_reader(paddle):
    data = ctr_clicks()
    return lambda: iter(data)


# ---------------------------------------------------------------------------
# understand_sentiment: conv and stacked LSTM
# ---------------------------------------------------------------------------

SENT_VOCAB, SENT_EMB, SENT_MAXLEN, SENT_BATCH, SENT_HID = 1024, 32, 40, 128, 32


def _sentiment_feed(batch):
    words, lens, labels = [], [], []
    for ids, lbl in batch:
        w, n = pad_ids(ids, SENT_MAXLEN)
        words.append(w)
        lens.append(n)
        labels.append([lbl])
    return {"words": np.stack(words),
            "words_len": np.array(lens, dtype="int32"),
            "label": np.array(labels, dtype="int64")}


def _sentiment_inputs(fluid):
    words = fluid.layers.data(name="words", shape=[SENT_MAXLEN],
                              dtype="int64")
    words_len = fluid.layers.data(name="words_len", shape=[], dtype="int32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    emb = fluid.layers.embedding(words, size=[SENT_VOCAB, SENT_EMB])
    return words, words_len, label, emb


def _sentiment_conv(paddle):
    fluid = paddle.fluid
    words, words_len, label, emb = _sentiment_inputs(fluid)
    conv = fluid.layers.sequence_conv(emb, num_filters=32, filter_size=3,
                                      act="tanh", length=words_len)
    pooled = fluid.layers.sequence_pool(conv, "max", length=words_len)
    logits = fluid.layers.fc(input=pooled, size=2)
    sm = fluid.layers.softmax(logits)
    loss = fluid.layers.mean(fluid.layers.cross_entropy(sm, label))
    return [words, words_len], loss, sm


def _sentiment_lstm(paddle):
    fluid = paddle.fluid
    words, words_len, label, emb = _sentiment_inputs(fluid)
    hid = SENT_HID
    fc1 = fluid.layers.fc(input=emb, size=hid * 4, num_flatten_dims=2)
    lstm1, _ = fluid.layers.dynamic_lstm(fc1, size=hid * 4,
                                         use_peepholes=False,
                                         length=words_len)
    fc2 = fluid.layers.fc(input=lstm1, size=hid * 4, num_flatten_dims=2)
    lstm2, _ = fluid.layers.dynamic_lstm(fc2, size=hid * 4,
                                         use_peepholes=False,
                                         is_reverse=True, length=words_len)
    p1 = fluid.layers.sequence_pool(lstm1, "max", length=words_len)
    p2 = fluid.layers.sequence_pool(lstm2, "max", length=words_len)
    logits = fluid.layers.fc(input=fluid.layers.concat([p1, p2], axis=1),
                             size=2)
    sm = fluid.layers.softmax(logits)
    loss = fluid.layers.mean(fluid.layers.cross_entropy(sm, label))
    return [words, words_len], loss, sm


# ---------------------------------------------------------------------------
# rnn_encoder_decoder
# ---------------------------------------------------------------------------

RNN_DICT, RNN_EMB, RNN_HID, RNN_SRC, RNN_TRG, RNN_BATCH = 64, 24, 32, 8, 8, 64


def _reversal_pairs(paddle, seed=0, n=2048):
    """The reversal task: target = the source reversed."""
    rng = np.random.RandomState(seed)

    def gen():
        for _ in range(n):
            ln = rng.randint(3, RNN_SRC + 1)
            src = rng.randint(4, RNN_DICT, ln)
            yield src, src[::-1]

    return gen


def _make_rnn_feed(paddle):
    bos, eos = paddle.dataset.wmt16.BOS, paddle.dataset.wmt16.EOS

    def to_feed(batch):
        srcs, src_lens, trg_in, trg_out, masks = [], [], [], [], []
        for src, trg in batch:
            s = np.zeros(RNN_SRC, "int64")
            s[:len(src)] = src
            srcs.append(s)
            src_lens.append(len(src))
            ti = np.zeros(RNN_TRG, "int64")
            to = np.zeros(RNN_TRG, "int64")
            m = np.zeros(RNN_TRG, "float32")
            t = list(trg)[: RNN_TRG - 1]
            ti[0] = bos
            ti[1:1 + len(t)] = t
            to[:len(t)] = t
            to[len(t)] = eos
            m[:len(t) + 1] = 1.0
            trg_in.append(ti)
            trg_out.append(to)
            masks.append(m)
        return {"src": np.stack(srcs),
                "src_len": np.asarray(src_lens, "int32"),
                "trg_in": np.stack(trg_in), "trg_out": np.stack(trg_out),
                "trg_mask": np.stack(masks)}

    return to_feed


def _rnn_reader(paddle):
    to_feed = _make_rnn_feed(paddle)

    def gen():
        for b in paddle.batch(_reversal_pairs(paddle), RNN_BATCH,
                              drop_last=True)():
            yield to_feed(b)

    return gen


def _rnn_encoder_decoder(paddle):
    fluid = paddle.fluid
    src = fluid.layers.data(name="src", shape=[RNN_SRC], dtype="int64")
    src_len = fluid.layers.data(name="src_len", shape=[], dtype="int32")
    trg_in = fluid.layers.data(name="trg_in", shape=[RNN_TRG],
                               dtype="int64")
    trg_out = fluid.layers.data(name="trg_out", shape=[RNN_TRG],
                                dtype="int64")
    trg_mask = fluid.layers.data(name="trg_mask", shape=[RNN_TRG],
                                 dtype="float32")
    src_emb = fluid.layers.embedding(src, size=[RNN_DICT, RNN_EMB])
    enc = fluid.layers.dynamic_gru(
        fluid.layers.fc(src_emb, 3 * RNN_HID, num_flatten_dims=2), RNN_HID,
        length=src_len)
    thought = fluid.layers.sequence_last_step(enc, length=src_len)
    trg_emb = fluid.layers.embedding(trg_in, size=[RNN_DICT, RNN_EMB])
    ctx = fluid.layers.expand(
        fluid.layers.unsqueeze(thought, axes=[1]), [1, RNN_TRG, 1])
    dec_in = fluid.layers.concat([trg_emb, ctx], axis=2)
    dec = fluid.layers.dynamic_gru(
        fluid.layers.fc(dec_in, 3 * RNN_HID, num_flatten_dims=2), RNN_HID,
        h_0=thought)
    logits = fluid.layers.fc(dec, RNN_DICT, num_flatten_dims=2)
    ce = fluid.layers.softmax_with_cross_entropy(
        fluid.layers.reshape(logits, [-1, RNN_DICT]),
        fluid.layers.reshape(trg_out, [-1, 1]))
    m = fluid.layers.reshape(trg_mask, [-1, 1])
    loss = fluid.layers.reduce_sum(ce * m) / (
        fluid.layers.reduce_sum(m) + 1e-6)
    sm = fluid.layers.softmax(logits)
    return [src, src_len, trg_in], loss, sm


def _rnn_check(losses):
    assert _tail(losses, 4) < 2.2, _tail(losses, 4)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# recommender_system
# ---------------------------------------------------------------------------

REC_EMB, REC_CATS, REC_TITLE = 16, 4, 6


def _rec_feed(batch):
    f = {
        "uid": np.array([[s[0]] for s in batch], dtype="int64"),
        "gender": np.array([[s[1]] for s in batch], dtype="int64"),
        "age": np.array([[s[2]] for s in batch], dtype="int64"),
        "job": np.array([[s[3]] for s in batch], dtype="int64"),
        "mid": np.array([[s[4]] for s in batch], dtype="int64"),
        "score": np.array([[s[7]] for s in batch], dtype="float32"),
    }
    cats, clens, titles, tlens = [], [], [], []
    for s in batch:
        c, cl = pad_ids(s[5], REC_CATS)
        t, tl = pad_ids(s[6], REC_TITLE)
        cats.append(c)
        clens.append(cl)
        titles.append(t)
        tlens.append(tl)
    f["cats"] = np.stack(cats)
    f["cats_len"] = np.array(clens, dtype="int32")
    f["title"] = np.stack(titles)
    f["title_len"] = np.array(tlens, dtype="int32")
    return f


def _recommender(paddle):
    fluid = paddle.fluid
    ml = paddle.dataset.movielens
    emb = REC_EMB
    uid = fluid.layers.data(name="uid", shape=[1], dtype="int64")
    gender = fluid.layers.data(name="gender", shape=[1], dtype="int64")
    age = fluid.layers.data(name="age", shape=[1], dtype="int64")
    job = fluid.layers.data(name="job", shape=[1], dtype="int64")
    mid = fluid.layers.data(name="mid", shape=[1], dtype="int64")
    cats = fluid.layers.data(name="cats", shape=[REC_CATS], dtype="int64",
                             append_batch_size=True)
    cats_len = fluid.layers.data(name="cats_len", shape=[], dtype="int32",
                                 append_batch_size=True)
    title = fluid.layers.data(name="title", shape=[REC_TITLE],
                              dtype="int64")
    title_len = fluid.layers.data(name="title_len", shape=[],
                                  dtype="int32")
    score = fluid.layers.data(name="score", shape=[1], dtype="float32")

    usr_emb = fluid.layers.embedding(uid, size=[ml.max_user_id() + 1, emb])
    usr_g = fluid.layers.embedding(gender, size=[2, emb // 2])
    usr_a = fluid.layers.embedding(age, size=[8, emb // 2])
    usr_j = fluid.layers.embedding(job,
                                   size=[ml.max_job_id() + 1, emb // 2])
    usr_feat = fluid.layers.concat([usr_emb, usr_g, usr_a, usr_j], axis=1)
    usr = fluid.layers.fc(input=usr_feat, size=32, act="tanh")

    mov_emb = fluid.layers.embedding(mid,
                                     size=[ml.max_movie_id() + 1, emb])
    cat_emb = fluid.layers.embedding(
        cats, size=[len(ml.movie_categories()) + 1, emb // 2])
    cat_pool = fluid.layers.sequence_pool(cat_emb, "average",
                                          length=cats_len)
    ttl_emb = fluid.layers.embedding(
        title, size=[len(ml.get_movie_title_dict()) + 1, emb // 2])
    ttl_pool = fluid.layers.sequence_pool(ttl_emb, "average",
                                          length=title_len)
    mov_feat = fluid.layers.concat([mov_emb, cat_pool, ttl_pool], axis=1)
    mov = fluid.layers.fc(input=mov_feat, size=32, act="tanh")

    sim = fluid.layers.cos_sim(usr, mov)
    pred = fluid.layers.scale(sim, scale=5.0)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, score))
    return ([uid, gender, age, job, mid, cats, cats_len, title, title_len],
            loss, pred)


def _rec_check(losses):
    assert _tail(losses, 4) < float(np.mean(losses[:4])) * 0.7, (
        float(np.mean(losses[:4])), _tail(losses, 4))


# ---------------------------------------------------------------------------
# label_semantic_roles
# ---------------------------------------------------------------------------

SRL_EMB, SRL_HID, SRL_MAXLEN, SRL_BATCH = 16, 32, 12, 128
SRL_SLOTS = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "pred",
             "mark", "label"]
SRL_FEEDS = SRL_SLOTS[:-1]


def _srl_feed(batch):
    slots = {n: [] for n in SRL_SLOTS}
    lengths = []
    for s in batch:
        for i, n in enumerate(SRL_SLOTS):
            arr, ln = pad_ids(s[i], SRL_MAXLEN)
            slots[n].append(arr)
        lengths.append(ln)
    feed = {n: np.stack(v) for n, v in slots.items()}
    feed["length"] = np.asarray(lengths, dtype="int64")
    return feed


def _srl(paddle):
    """Embeddings → hidden → emissions; the CRF loss and the Viterbi
    decode share the transition parameter ``crfw``.  The decode's output
    is the program's op ``crf_decoding``'s ViterbiPath."""
    fluid = paddle.fluid
    word_dict, verb_dict, label_dict = paddle.dataset.conll05.get_dict()
    ins = [fluid.layers.data(name=n, shape=[SRL_MAXLEN], dtype="int64")
           for n in SRL_SLOTS[:6]]
    pred = fluid.layers.data(name="pred", shape=[SRL_MAXLEN], dtype="int64")
    mark = fluid.layers.data(name="mark", shape=[SRL_MAXLEN], dtype="int64")
    label = fluid.layers.data(name="label", shape=[SRL_MAXLEN],
                              dtype="int64")
    length = fluid.layers.data(name="length", shape=[], dtype="int64")
    embs = [fluid.layers.embedding(
        x, size=[len(word_dict), SRL_EMB],
        param_attr=fluid.ParamAttr(name="word_emb")) for x in ins]
    embs.append(fluid.layers.embedding(pred, size=[len(verb_dict), SRL_EMB]))
    embs.append(fluid.layers.embedding(mark, size=[2, SRL_EMB // 2]))
    feat = fluid.layers.concat(embs, axis=2)
    h = fluid.layers.fc(input=feat, size=SRL_HID, act="tanh",
                        num_flatten_dims=2)
    emission = fluid.layers.fc(input=h, size=len(label_dict),
                               num_flatten_dims=2)
    crf_cost = fluid.layers.linear_chain_crf(
        emission, label, param_attr=fluid.ParamAttr(name="crfw"),
        length=length)
    loss = fluid.layers.mean(crf_cost)
    fluid.layers.crf_decoding(emission, fluid.ParamAttr(name="crfw"),
                              length=length)
    return ins + [pred, mark], loss, emission


def decode_var(program):
    """The name of ``program``'s Viterbi path (the crf_decoding op's
    output)."""
    (op,) = [op for op in program.global_block().ops
             if op.type == "crf_decoding"]
    return op.output("ViterbiPath")[0]


def _srl_check(losses):
    # CRF NLL is per sequence: random ≈ mean_len * ln(N_LABELS) ≈ 8 * 2.3
    assert losses[0] > 10.0, losses[0]
    assert _tail(losses, 4) < 0.45 * losses[0], (losses[0], _tail(losses, 4))


# ---------------------------------------------------------------------------
# the attention-fusion Transformer book
# ---------------------------------------------------------------------------

TF_BATCH, TF_SRC, TF_TRG, TF_STEPS, TF_SEED = 8, 12, 10, 8, 4


def _transformer_module(paddle):
    return importlib.import_module(paddle.__name__ + ".models.transformer")


def transformer_build(paddle, dropout=0.0, optimizer=True):
    """The book's _build: TransformerConfig.tiny at ``dropout`` (the
    numpy seed 9 set first, as the book sets it), Adam(1e-3).  Returns
    (cfg, main, startup, cost)."""
    fluid = paddle.fluid
    tr = _transformer_module(paddle)
    cfg = tr.TransformerConfig.tiny(dropout=dropout)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        np.random.seed(9)
        feeds, cost, acc = tr.build_transformer_nmt(cfg)
        if optimizer:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return cfg, main, startup, cost


def _transformer(paddle):
    tr = _transformer_module(paddle)
    cfg = tr.TransformerConfig.tiny(dropout=0.0)
    np.random.seed(9)
    feeds, cost, acc = tr.build_transformer_nmt(cfg)
    return feeds, cost, acc


def transformer_feed(paddle):
    tr = _transformer_module(paddle)
    return tr.make_fake_batch(tr.TransformerConfig.tiny(dropout=0.0),
                              batch=TF_BATCH, src_len=TF_SRC,
                              trg_len=TF_TRG, seed=TF_SEED)


def _transformer_reader(paddle):
    feed = transformer_feed(paddle)
    return lambda: iter([feed])


# ---------------------------------------------------------------------------
# machine_translation: a GRU encoder and decoder on StaticRNN, a masked
# loss, and two beam decodes over the trained parameters (by name): the
# decode steps unrolled, and the same decode as a While over tensor arrays
# ---------------------------------------------------------------------------

MT_DICT, MT_EMB, MT_HID, MT_SRC, MT_TRG, MT_BATCH, MT_BEAM = \
    64, 32, 32, 9, 10, 64, 3


def _mt_gru_cell(fluid, x_t, h_prev, prefix):
    """One GRU step from fc layers."""
    hid = MT_HID
    gates = fluid.layers.fc(input=x_t, size=2 * hid,
                            param_attr=fluid.ParamAttr(name=f"{prefix}_xg"),
                            bias_attr=fluid.ParamAttr(name=f"{prefix}_bg"))
    gates = gates + fluid.layers.fc(
        input=h_prev, size=2 * hid, bias_attr=False,
        param_attr=fluid.ParamAttr(name=f"{prefix}_hg"))
    gates = fluid.layers.sigmoid(gates)
    u = fluid.layers.slice(gates, axes=[1], starts=[0], ends=[hid])
    r = fluid.layers.slice(gates, axes=[1], starts=[hid], ends=[2 * hid])
    cand = fluid.layers.fc(input=x_t, size=hid,
                           param_attr=fluid.ParamAttr(name=f"{prefix}_xc"),
                           bias_attr=fluid.ParamAttr(name=f"{prefix}_bc"))
    cand = cand + fluid.layers.fc(
        input=r * h_prev, size=hid, bias_attr=False,
        param_attr=fluid.ParamAttr(name=f"{prefix}_hc"))
    cand = fluid.layers.tanh(cand)
    one_minus_u = fluid.layers.scale(u, scale=-1.0, bias=1.0)
    return one_minus_u * h_prev + u * cand


def _mt_pad(ids, length, pad=1):  # pads with EOS
    out = np.full(length, pad, dtype="int64")
    n = min(len(ids), length)
    out[:n] = ids[:n]
    return out, n


def _mt_feed(batch):
    return {
        "src": np.stack([_mt_pad(s[0], MT_SRC)[0] for s in batch]),
        "trg": np.stack([_mt_pad(s[1], MT_TRG)[0] for s in batch]),
        "trg_next": np.stack([_mt_pad(s[2], MT_TRG)[0] for s in batch]),
        "mask": np.stack([
            (np.arange(MT_TRG) < _mt_pad(s[2], MT_TRG)[1]).astype("float32")
            for s in batch])}


def _mt_encoder(fluid, src):
    src_emb = fluid.layers.embedding(
        src, size=[MT_DICT, MT_EMB],
        param_attr=fluid.ParamAttr(name="src_emb_w"))
    src_tm = fluid.layers.transpose(src_emb, perm=[1, 0, 2])  # time-major
    h0 = fluid.layers.fill_constant_batch_size_like(
        input=src, shape=[-1, MT_HID], dtype="float32", value=0.0)
    enc = fluid.layers.StaticRNN()
    with enc.step():
        x_t = enc.step_input(src_tm)
        h_prev = enc.memory(init=h0)
        h = _mt_gru_cell(fluid, x_t, h_prev, "enc")
        enc.update_memory(h_prev, h)
        enc.step_output(h)
    enc_last = fluid.layers.slice(enc(), axes=[0], starts=[MT_SRC - 1],
                                  ends=[MT_SRC])
    return fluid.layers.reshape(enc_last, shape=[-1, MT_HID])


def _machine_translation(paddle):
    fluid = paddle.fluid
    L = fluid.layers
    src = L.data(name="src", shape=[MT_SRC], dtype="int64")
    trg = L.data(name="trg", shape=[MT_TRG], dtype="int64")
    trg_next = L.data(name="trg_next", shape=[MT_TRG], dtype="int64")
    mask = L.data(name="mask", shape=[MT_TRG], dtype="float32")
    enc_last = _mt_encoder(fluid, src)
    trg_emb = L.embedding(trg, size=[MT_DICT, MT_EMB],
                          param_attr=fluid.ParamAttr(name="trg_emb_w"))
    trg_tm = L.transpose(trg_emb, perm=[1, 0, 2])
    dec = L.StaticRNN()
    with dec.step():
        y_t = dec.step_input(trg_tm)
        h_prev = dec.memory(init=enc_last)
        h = _mt_gru_cell(fluid, y_t, h_prev, "dec")
        dec.update_memory(h_prev, h)
        dec.step_output(L.fc(input=h, size=MT_DICT,
                             param_attr=fluid.ParamAttr(name="out_w"),
                             bias_attr=fluid.ParamAttr(name="out_b")))
    logits_bm = L.transpose(dec(), perm=[1, 0, 2])  # [B, T, V]
    ce = L.softmax_with_cross_entropy(logits_bm,
                                      L.unsqueeze(trg_next, axes=[2]))
    masked = L.squeeze(ce, axes=[2]) * mask
    loss = L.reduce_sum(masked) / (L.reduce_sum(mask) + 1e-6)
    return [src, trg], loss, logits_bm


def _mt_beam_start(paddle, src):
    """pre_ids (BOS) and pre_scores (beam 0 alive, the rest -1e9)."""
    L = paddle.fluid.layers
    pre_ids = L.fill_constant_batch_size_like(
        src, shape=[-1, MT_BEAM], dtype="int64",
        value=paddle.dataset.wmt16.BOS)
    init_bias = np.zeros((1, MT_BEAM), "float32")
    init_bias[0, 1:] = -1e9
    pre_scores = L.fill_constant_batch_size_like(
        src, shape=[-1, MT_BEAM], dtype="float32", value=0.0) \
        + L.assign(init_bias)
    return pre_ids, pre_scores


def _mt_beam_step(paddle, pre_ids, pre_scores, h):
    """One decode step: the GRU on each beam, beam_search (EOS ends a
    beam), and the new states reordered by parent with a one-hot
    matmul."""
    fluid = paddle.fluid
    L = fluid.layers
    emb = L.embedding(pre_ids, size=[MT_DICT, MT_EMB],
                      param_attr=fluid.ParamAttr(name="trg_emb_w"))
    h_new = _mt_gru_cell(fluid, L.reshape(emb, shape=[-1, MT_EMB]),
                         L.reshape(h, shape=[-1, MT_HID]), "dec")
    logits = L.fc(input=h_new, size=MT_DICT,
                  param_attr=fluid.ParamAttr(name="out_w"),
                  bias_attr=fluid.ParamAttr(name="out_b"))
    logp3 = L.reshape(L.log_softmax(logits), shape=[-1, MT_BEAM, MT_DICT])
    ids, scores, parent = L.beam_search(pre_ids, pre_scores, logp3,
                                        beam_size=MT_BEAM,
                                        end_id=paddle.dataset.wmt16.EOS)
    h_sel = L.matmul(L.one_hot(parent, MT_BEAM),
                     L.reshape(h_new, shape=[-1, MT_BEAM, MT_HID]))
    return ids, scores, parent, h_sel


def mt_build_decode(paddle):
    """The book's unrolled beam decode (MT_TRG steps, then
    beam_search_decode).  Returns (src, sentences [B, K, T], scores)."""
    fluid = paddle.fluid
    L = fluid.layers
    src = L.data(name="src", shape=[MT_SRC], dtype="int64")
    h = L.stack([_mt_encoder(fluid, src)] * MT_BEAM, axis=1)
    pre_ids, pre_scores = _mt_beam_start(paddle, src)
    step_ids, step_parents = [], []
    for _ in range(MT_TRG):
        pre_ids, pre_scores, parent, h = _mt_beam_step(
            paddle, pre_ids, pre_scores, h)
        step_ids.append(L.unsqueeze(pre_ids, axes=[0]))
        step_parents.append(L.unsqueeze(L.cast(parent, "int32"), axes=[0]))
    sent = L.beam_search_decode(L.concat(step_ids, axis=0),
                                L.concat(step_parents, axis=0),
                                end_id=paddle.dataset.wmt16.EOS)
    return src, sent, pre_scores


def mt_build_decode_while(paddle):
    """The same decode as a While over tensor arrays (the reference
    book's construction): token-identical to mt_build_decode."""
    fluid = paddle.fluid
    L = fluid.layers
    src = L.data(name="src", shape=[MT_SRC], dtype="int64")
    h0 = L.stack([_mt_encoder(fluid, src)] * MT_BEAM, axis=1)
    pre_ids0, pre_scores0 = _mt_beam_start(paddle, src)
    counter = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=MT_TRG)
    cap = MT_TRG + 1
    ids_arr = L.create_array("int64", capacity=cap)
    sc_arr = L.create_array("float32", capacity=cap)
    par_arr = L.create_array("int32", capacity=cap)
    st_arr = L.create_array("float32", capacity=cap)
    L.array_write(pre_ids0, counter, array=ids_arr)
    L.array_write(pre_scores0, counter, array=sc_arr)
    L.array_write(L.fill_constant_batch_size_like(
        src, shape=[-1, MT_BEAM], dtype="int32", value=0), counter,
        array=par_arr)
    L.array_write(h0, counter, array=st_arr)
    cond = L.less_than(counter, limit)
    w = L.While(cond)
    with w.block():
        ids, scores, parent, h_sel = _mt_beam_step(
            paddle, L.array_read(ids_arr, counter),
            L.array_read(sc_arr, counter), L.array_read(st_arr, counter))
        L.increment(counter, value=1, in_place=True)
        L.array_write(ids, counter, array=ids_arr)
        L.array_write(scores, counter, array=sc_arr)
        L.array_write(L.cast(parent, "int32"), counter, array=par_arr)
        L.array_write(h_sel, counter, array=st_arr)
        L.less_than(counter, limit, cond=cond)
    ids_stacked, _ = L.tensor_array_to_tensor(ids_arr, axis=0,
                                              use_stack=True)
    par_stacked, _ = L.tensor_array_to_tensor(par_arr, axis=0,
                                              use_stack=True)
    sent = L.beam_search_decode(
        L.slice(ids_stacked, axes=[0], starts=[1], ends=[cap]),
        L.slice(par_stacked, axes=[0], starts=[1], ends=[cap]),
        end_id=paddle.dataset.wmt16.EOS)
    return src, sent, L.array_read(sc_arr, limit)


# ---------------------------------------------------------------------------

BOOKS = {b.name: b for b in (
    Book("fit_a_line", _fit_a_line,
         _batched(lambda p: p.dataset.uci_housing.train(), 101,
                  _fit_a_line_feed),
         30, lambda p: p.fluid.optimizer.SGD(learning_rate=0.05),
         _all(_below(0.05), _falls), batch=101),
    Book("recognize_digits_mlp", _digits_mlp,
         _batched(lambda p: p.dataset.mnist.train(), 128, _image_feed),
         3, _adam(1e-3), _below(0.25), batch=128),
    Book("recognize_digits_conv", _digits_conv,
         _batched(lambda p: p.dataset.mnist.train(), 128, _image_feed),
         6, _adam(3e-3), _below(1.0), batch=128),
    Book("image_classification_vgg", _image_vgg,
         _batched(lambda p: p.dataset.cifar.train10(), 128, _image_feed),
         4, _adam(2e-3), _below(1.0), batch=128),
    Book("image_classification_resnet", _image_resnet,
         _batched(lambda p: p.dataset.cifar.train10(), 128, _image_feed),
         7, _adam(3e-3), _below(2.0), batch=128),
    Book("word2vec", _word2vec, _batched(_imikolov, 256, _word2vec_feed),
         3, _adam(5e-3), _below(3.0),
         feed_names=[f"w{i}" for i in range(W2V_N - 1)], batch=256),
    Book("ctr", _ctr, _ctr_reader, 3, _adam(5e-3),
         _all(_below(0.45), _falls),
         feed_names=["user_id", "item_id", "dense"], batch=32),
    Book("understand_sentiment_conv", _sentiment_conv,
         _batched(lambda p: p.dataset.imdb.train(), SENT_BATCH,
                  _sentiment_feed),
         6, _adam(5e-3), _below(0.35, 4),
         feed_names=["words", "words_len"], batch=SENT_BATCH),
    Book("understand_sentiment_stacked_lstm", _sentiment_lstm,
         _batched(lambda p: p.dataset.imdb.train(), SENT_BATCH,
                  _sentiment_feed),
         4, _adam(5e-3), _below(0.4, 4),
         feed_names=["words", "words_len"], batch=SENT_BATCH),
    Book("rnn_encoder_decoder", _rnn_encoder_decoder, _rnn_reader, 10,
         _adam(8e-3), _rnn_check, feed_names=["src", "src_len", "trg_in"],
         batch=RNN_BATCH),
    Book("recommender_system", _recommender,
         _batched(lambda p: p.dataset.movielens.train(), 256, _rec_feed),
         8, _adam(5e-3), _rec_check,
         feed_names=["uid", "gender", "age", "job", "mid", "cats",
                     "cats_len", "title", "title_len"], batch=256),
    Book("label_semantic_roles", _srl,
         _batched(lambda p: p.dataset.conll05.train(), SRL_BATCH, _srl_feed),
         14, _adam(8e-3), _srl_check, feed_names=SRL_FEEDS,
         batch=SRL_BATCH),
    Book("transformer_fusion", _transformer, _transformer_reader, TF_STEPS,
         _adam(1e-3), _falls, batch=TF_BATCH, graph_passes="fuse_attention"),
    Book("machine_translation", _machine_translation,
         _batched(lambda p: p.dataset.wmt16.train(MT_DICT, MT_DICT),
                  MT_BATCH, _mt_feed),
         12, _adam(8e-3), _below(2.5, 4), feed_names=["src", "trg"],
         batch=MT_BATCH),
)}


def train_feeds(book, paddle):
    """Every feed of ``book``'s training run, in order (epochs x the
    reader's batches)."""
    return [f for _ in range(book.epochs) for f in book.reader(paddle)()]


def first_feed(book, paddle):
    """The reader's first batch (the book harness's inference feed)."""
    return next(iter(book.reader(paddle)()))
