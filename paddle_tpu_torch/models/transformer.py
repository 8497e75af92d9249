"""Transformer NMT (encoder-decoder), training and greedy decode
(counterpart of ``paddle_tpu/models/transformer.py``).

Padded dense batches with additive attention biases: a source pad
position carries -1e9 in the key bias of every attention that reads
the encoder output, the decoder's self-attention is causal through
``softmax_mask_fuse_upper_triangle``, and ``label_weight`` zeroes the
loss of the target's pads.  With attention dropout 0 the default graph
passes rewrite each self-attention (the encoder's with its pad bias,
the decoder's causal) to ``flash_attention``, which runs K1-K3 on the
card; a cross-attention stays composed, since its queries and keys
come from different sequences.  ``build_greedy_decode`` is a separate
program over the same parameters (by name): a fixed [B, max_out_len +
1] target buffer, the decoder run once per position;
``build_greedy_decode_scan`` is the same decode as one while loop.  Op
lists, parameter names and feed names are
the JAX package's, so weights carry across by name
(``convert.load_params``).
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid.initializer import Normal
from paddle_tpu_torch.fluid.param_attr import ParamAttr

__all__ = ["TransformerConfig", "build_transformer_nmt",
           "build_greedy_decode", "build_greedy_decode_scan",
           "make_fake_batch"]


class TransformerConfig:
    def __init__(self, src_vocab=1000, trg_vocab=1000, max_len=64,
                 hidden_size=64, num_heads=4, ffn_size=128,
                 num_encoder_layers=2, num_decoder_layers=2, dropout=0.1,
                 init_std=0.02, bos_id=0, eos_id=1):
        self.src_vocab = src_vocab
        self.trg_vocab = trg_vocab
        self.max_len = max_len
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.dropout = dropout
        self.init_std = init_std
        self.bos_id = bos_id
        self.eos_id = eos_id

    @classmethod
    def tiny(cls, **kw):
        return cls(**kw)

    @classmethod
    def base(cls, **kw):
        d = dict(src_vocab=30000, trg_vocab=30000, max_len=256,
                 hidden_size=512, num_heads=8, ffn_size=2048,
                 num_encoder_layers=6, num_decoder_layers=6)
        d.update(kw)
        return cls(**d)

    @classmethod
    def big(cls, **kw):
        """Transformer-big (Vaswani et al.): the BASELINE.md NMT
        dynamic-shape stress config."""
        d = dict(src_vocab=30000, trg_vocab=30000, max_len=256,
                 hidden_size=1024, num_heads=16, ffn_size=4096,
                 num_encoder_layers=6, num_decoder_layers=6)
        d.update(kw)
        return cls(**d)


def _fc(x, size, name, act=None, init_std=0.02):
    return layers.fc(
        x, size=size, num_flatten_dims=2, act=act,
        param_attr=ParamAttr(name=name + ".w_0",
                             initializer=Normal(0.0, init_std)),
        bias_attr=ParamAttr(name=name + ".b_0"))


def _attention(q_in, kv_in, bias, cfg, name, is_test, causal=False):
    """Multi-head attention; q_in [B,Tq,H], kv_in [B,Tk,H];
    bias [B,1,1,Tk] additive (or None); causal adds the upper-tri mask."""
    h, n = cfg.hidden_size, cfg.num_heads
    d = h // n
    q = _fc(q_in, h, name + "_q", init_std=cfg.init_std)
    k = _fc(kv_in, h, name + "_k", init_std=cfg.init_std)
    v = _fc(kv_in, h, name + "_v", init_std=cfg.init_std)

    def heads(t):
        return layers.transpose(layers.reshape(t, [0, 0, n, d]),
                                [0, 2, 1, 3])

    q, k, v = heads(q), heads(k), heads(v)
    scores = layers.matmul(q, k, transpose_y=True, alpha=float(d) ** -0.5)
    if bias is not None:
        scores = layers.elementwise_add(scores, bias)
    if causal:
        weights = layers.softmax_mask_fuse_upper_triangle(scores)
    else:
        weights = layers.softmax(scores)
    if cfg.dropout and not is_test:
        weights = layers.dropout(weights, cfg.dropout, is_test=is_test,
                                 dropout_implementation="upscale_in_train")
    ctx = layers.matmul(weights, v)
    ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
    return _fc(ctx, h, name + "_o", init_std=cfg.init_std)


def _add_norm(x, y, cfg, name, is_test):
    if cfg.dropout and not is_test:
        y = layers.dropout(y, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.layer_norm(
        layers.elementwise_add(x, y), begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_ln_scale"),
        bias_attr=ParamAttr(name=name + "_ln_bias"))


def _ffn(x, cfg, name):
    return _fc(_fc(x, cfg.ffn_size, name + "_fc0", act="relu",
                   init_std=cfg.init_std),
               cfg.hidden_size, name + "_fc1", init_std=cfg.init_std)


def _embed(ids, vocab, cfg, name):
    emb = layers.embedding(
        ids, size=[vocab, cfg.hidden_size],
        param_attr=ParamAttr(name=name,
                             initializer=Normal(0.0, cfg.init_std)))
    emb = layers.scale(emb, scale=float(cfg.hidden_size) ** 0.5)
    return layers.add_position_encoding(emb, alpha=1.0, beta=1.0)


def transformer_encoder(src_ids, src_bias, cfg, is_test=False):
    x = _embed(src_ids, cfg.src_vocab, cfg, "src_embedding")
    for i in range(cfg.num_encoder_layers):
        name = f"enc_{i}"
        attn = _attention(x, x, src_bias, cfg, name + "_selfattn", is_test)
        x = _add_norm(x, attn, cfg, name + "_att", is_test)
        x = _add_norm(x, _ffn(x, cfg, name + "_ffn"), cfg, name + "_ffn",
                      is_test)
    return x


def transformer_decoder(trg_ids, enc_out, src_bias, cfg, is_test=False):
    x = _embed(trg_ids, cfg.trg_vocab, cfg, "trg_embedding")
    for i in range(cfg.num_decoder_layers):
        name = f"dec_{i}"
        self_attn = _attention(x, x, None, cfg, name + "_selfattn", is_test,
                               causal=True)
        x = _add_norm(x, self_attn, cfg, name + "_satt", is_test)
        cross = _attention(x, enc_out, src_bias, cfg, name + "_crossattn",
                           is_test)
        x = _add_norm(x, cross, cfg, name + "_catt", is_test)
        x = _add_norm(x, _ffn(x, cfg, name + "_ffn"), cfg, name + "_ffn",
                      is_test)
    return _fc(x, cfg.trg_vocab, "trg_proj", init_std=cfg.init_std)


def _pad_bias(ids, pad_id=0):
    """[B,T] ids → [B,1,1,T] additive bias: -1e9 on pad positions."""
    is_pad = layers.cast(layers.equal(
        ids, layers.fill_constant_batch_size_like(ids, [-1, 1], "int64",
                                                  float(pad_id))), "float32")
    bias = layers.scale(is_pad, scale=-1e9)
    return layers.reshape(bias, [0, 1, 1, -1])


def build_transformer_nmt(cfg: TransformerConfig = None, is_test=False,
                          pad_id=0):
    """Teacher-forced training graph.  Feeds: src_ids [B,S], trg_ids [B,T]
    (decoder input), labels [B,T] (shifted targets), label_weight [B,T]
    (0 on padding).  Returns (feeds, avg_cost, token_acc)."""
    cfg = cfg or TransformerConfig.tiny()
    src = layers.data("src_ids", [-1, -1], False, dtype="int64")
    trg = layers.data("trg_ids", [-1, -1], False, dtype="int64")
    lbl = layers.data("labels", [-1, -1], False, dtype="int64")
    w = layers.data("label_weight", [-1, -1], False, dtype="float32")
    src_bias = _pad_bias(src, pad_id)
    enc = transformer_encoder(src, src_bias, cfg, is_test=is_test)
    logits = transformer_decoder(trg, enc, src_bias, cfg, is_test=is_test)
    flat_logits = layers.reshape(logits, [-1, cfg.trg_vocab])
    flat_lbl = layers.reshape(lbl, [-1, 1])
    ce = layers.softmax_with_cross_entropy(flat_logits, flat_lbl)
    flat_w = layers.reshape(w, [-1, 1])
    cost = layers.reduce_sum(layers.elementwise_mul(ce, flat_w)) / (
        layers.reduce_sum(flat_w) + 1e-6)
    pred = layers.argmax(flat_logits, axis=-1)
    correct = layers.cast(layers.equal(
        pred, layers.reshape(lbl, [-1])), "float32")
    acc = layers.reduce_sum(correct * layers.reshape(flat_w, [-1])) / (
        layers.reduce_sum(flat_w) + 1e-6)
    return [src, trg, lbl, w], cost, acc


def build_greedy_decode(cfg: TransformerConfig, max_out_len=16, pad_id=0):
    """Greedy autoregressive decode as a compiled program with a FIXED
    [B, max_out_len+1] target buffer: the causal mask makes positions > i
    invisible to position i, so the buffer's not-yet-written tail cannot
    leak into step i's logits — every decoder invocation has ONE static
    shape (one XLA compilation, not max_out_len of them).  Shares
    parameters with the training program by name.
    Returns (src var, out ids var [B, max_out_len+1] starting with bos)."""
    cap = max_out_len + 1
    src = layers.data("src_ids", [-1, -1], False, dtype="int64")
    src_bias = _pad_bias(src, pad_id)
    enc = transformer_encoder(src, src_bias, cfg, is_test=True)
    # fixed-capacity buffer, bos everywhere (tail is causally invisible)
    trg = layers.fill_constant_batch_size_like(src, [-1, cap], "int64",
                                               float(cfg.bos_id))
    for i in range(max_out_len):
        logits = transformer_decoder(trg, enc, src_bias, cfg, is_test=True)
        pos = layers.slice(logits, axes=[1],
                           starts=[i], ends=[i + 1])          # [B,1,V]
        nxt = layers.argmax(layers.reshape(pos, [0, -1]), axis=-1)
        nxt = layers.reshape(layers.cast(nxt, "int64"), [-1, 1])  # [B,1]
        # write position i+1 of the buffer: trg*(1-onehot) + nxt*onehot
        onehot = layers.assign(np.eye(1, cap, i + 1, dtype="int64"))
        inv = layers.assign(1 - np.eye(1, cap, i + 1, dtype="int64"))
        onehot_b = layers.expand_as(onehot, trg)              # [B, cap]
        keep = layers.elementwise_mul(trg, inv)
        write = layers.elementwise_mul(onehot_b, nxt)         # bcast [B,1]
        trg = layers.elementwise_add(keep, write)
    return src, trg


def build_greedy_decode_scan(cfg: TransformerConfig, max_out_len=16,
                             pad_id=0):
    """build_greedy_decode as ONE while loop: the unrolled variant puts
    max_out_len copies of the whole decoder in the program; here the body
    (one decoder pass and one buffer write) is built once and runs from
    the host each iteration.  The same fixed buffer, whose tail the
    causal mask hides, and the same ids.  Returns (src var, out ids
    [B, cap])."""
    L = layers
    cap = max_out_len + 1
    src = L.data("src_ids", [-1, -1], False, dtype="int64")
    src_bias = _pad_bias(src, pad_id)
    enc = L.assign(transformer_encoder(src, src_bias, cfg, is_test=True))
    src_bias_ro = L.assign(src_bias)

    trg = L.assign(L.fill_constant_batch_size_like(
        src, [-1, cap], "int64", float(cfg.bos_id)))
    i = L.fill_constant(shape=[1], value=0, dtype="int64")
    n_const = L.fill_constant(shape=[1], value=max_out_len, dtype="int64")
    cond = L.less_than(i, n_const)
    w = L.While(cond)
    with w.block():
        logits = transformer_decoder(trg, enc, src_bias_ro, cfg,
                                     is_test=True)            # [B,cap,V]
        # dynamic position pick: one-hot(i) over the time axis
        oh_i = L.reshape(L.one_hot(L.reshape(i, shape=[1, 1]), cap),
                         shape=[1, cap, 1])
        pos = L.reduce_sum(L.elementwise_mul(logits, oh_i), dim=1)  # [B,V]
        nxt = L.reshape(L.cast(L.argmax(pos, axis=-1), "int64"), [-1, 1])
        # write buffer position i+1
        ip1 = L.increment(i, in_place=False)
        oh_w = L.cast(L.reshape(
            L.one_hot(L.reshape(ip1, shape=[1, 1]), cap),
            shape=[1, cap]), "int64")
        one = L.fill_constant(shape=[1, cap], value=1, dtype="int64")
        keep = L.elementwise_mul(trg, L.elementwise_sub(one, oh_w))
        write = L.elementwise_mul(oh_w, nxt)
        L.assign(L.elementwise_add(keep, write), trg)
        L.increment(i, in_place=True)
        L.less_than(i, n_const, cond=cond)
    return src, trg


def make_fake_batch(cfg: TransformerConfig, batch=8, src_len=12, trg_len=10,
                    seed=0):
    """Copy-task synthetic data: target = source tokens (shifted)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, cfg.src_vocab, (batch, src_len)).astype("int64")
    trg_full = np.concatenate(
        [np.full((batch, 1), cfg.bos_id, "int64"), src[:, :trg_len]], axis=1)
    return {
        "src_ids": src,
        "trg_ids": trg_full[:, :-1],
        "labels": trg_full[:, 1:],
        "label_weight": np.ones((batch, trg_full.shape[1] - 1), "float32"),
    }
