"""The graph-pass layer of the PyTorch port against the JAX package's.

Each program is built by the same layer calls in both packages (the
same var names), run through each package's passes, and the rewritten
op lists compared op for op: types, slot names and attrs, ``causal``,
``sm_scale`` and ``fwd_op_idx`` included.  The veto cases of the JAX
package's own tests (tests/test_passes.py) must veto in the port too.
Numbers: BERT-tiny trained 20 fp32 Adam steps with the passes on and
off (1e-5), and against the JAX package's passes-on run (1e-5); the
fused softmax + cross-entropy head bit-equal to the composed one over
20 steps; a saved unfused BERT-tiny served by the port's predictor with
passes on and off and by the JAX package's predictor (1e-5).
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu import passes as jpasses
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch.fluid import executor as texe
from paddle_tpu_torch.models import bert as tbert

PKGS = {"jax": (jfluid, jpasses, jbert), "port": (tfluid, tpasses, tbert)}


def _ops(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def _types(program):
    return [op.type for op in program.global_block().ops]


def _run(pkg, program, names, keep_vars=(), selfcheck=True):
    _, passes, _ = PKGS[pkg]
    ctx = passes.PassContext(keep_vars=keep_vars)
    return passes.PassManager(names).run(program, ctx, selfcheck=selfcheck)


def _report(rep):
    """The report entries without the lane (the same in both)."""
    return [{k: v for k, v in e.items() if k != "lane"} for e in rep]


def _both(build, names, keep_vars=lambda p: ()):
    """Build in both packages, run ``names``; the two reports and
    programs, asserted equal op for op."""
    out = {}
    for pkg in PKGS:
        prog = build(pkg)
        rep = _run(pkg, prog, names, keep_vars(prog))
        out[pkg] = (rep, prog)
    assert _report(out["port"][0]) == _report(out["jax"][0])
    assert _ops(out["port"][1]) == _ops(out["jax"][1])
    return out["port"]


# ---------------------------------------------------------------------------
# programs, built by the same calls in both packages
# ---------------------------------------------------------------------------


def _bert(pkg, num_layers=2, attn_dropout=0.0, optimizer=True,
          for_test=False):
    fluid, _, bert = PKGS[pkg]
    cfg = bert.BertConfig.tiny(use_flash_attention=False,
                               num_layers=num_layers,
                               attn_dropout=attn_dropout, hidden_dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg, is_test=False)
        if optimizer:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    if for_test:
        return main.clone(for_test=True)
    return main


def _heads(layers, x, n, d):
    r = layers.reshape(x, shape=[0, 0, n, d])
    return layers.transpose(r, perm=[0, 2, 1, 3])


def _attention_chain(pkg, causal=False, bias_shape=None, kv_len=8,
                     dropout=None, train=True):
    """[2, 8, 16] through q/k/v projections into 2 heads of 8, then
    matmul -> [bias add] -> softmax (causal: the masked one) ->
    [dropout] -> matmul; k and v project a sequence of ``kv_len``."""
    fluid = PKGS[pkg][0]
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", [2, 8, 16], False, dtype="float32")
        x.stop_gradient = False
        src = x
        if kv_len != 8:
            src = fluid.data("mem", [2, kv_len, 16], False, dtype="float32")
        q = _heads(L, L.fc(x, 16, num_flatten_dims=2), 2, 8)
        k = _heads(L, L.fc(src, 16, num_flatten_dims=2), 2, 8)
        v = _heads(L, L.fc(src, 16, num_flatten_dims=2), 2, 8)
        s = L.matmul(q, k, transpose_y=True, alpha=8 ** -0.5)
        if bias_shape is not None:
            b = fluid.data("b", bias_shape, False, dtype="float32")
            s = L.elementwise_add(s, b)
        w = (L.softmax_mask_fuse_upper_triangle(s) if causal
             else L.softmax(s))
        if dropout is not None:
            w = L.dropout(w, dropout_prob=0.1, is_test=True,
                          dropout_implementation=dropout)
        out = L.matmul(w, v)
        loss = L.mean(out)
        if train:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, out, loss


def _sce(pkg, soft_label=False, optimizer=True, static=False):
    """The classifier head fc -> softmax -> cross_entropy -> mean."""
    fluid = PKGS[pkg][0]
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if static:
            x = fluid.data("x", [16, 8], False, dtype="float32")
            y = fluid.data("y", [16, 1], False, dtype="int64")
        else:
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = (fluid.layers.data(name="y", shape=[4], dtype="float32")
                 if soft_label else
                 fluid.layers.data(name="y", shape=[1], dtype="int64"))
        h = L.fc(x, size=16, act="relu")
        probs = L.softmax(L.fc(h, size=4))
        loss = L.mean(L.cross_entropy(probs, y, soft_label=soft_label))
        if optimizer:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    startup.random_seed = 5
    return main, startup, loss, probs


def _sce_data(soft_label=False, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    xb = rng.uniform(-1, 1, (batch, 8)).astype("float32")
    if soft_label:
        yl = rng.uniform(0, 1, (batch, 4)).astype("float32")
        yl /= yl.sum(axis=1, keepdims=True)
    else:
        yl = rng.randint(0, 4, (batch, 1)).astype("int64")
    return {"x": xb, "y": yl}


# ---------------------------------------------------------------------------
# selection, order, contracts
# ---------------------------------------------------------------------------


def test_default_passes_and_order_are_the_jax_packages():
    assert tpasses.DEFAULT_PASSES == jpasses.DEFAULT_PASSES
    assert tpasses.PASS_ORDER == jpasses.PASS_ORDER
    assert tpasses.list_program_passes() == sorted(jpasses.PASS_ORDER)
    for spec in ("none", "", "default", "auto", "fuse_attention",
                 "-fuse_attention", "default,-fuse_bias_act_dropout",
                 "fuse_attention,int8_weight_storage"):
        assert tpasses.resolve_passes(spec) == jpasses.resolve_passes(spec)
    for bad in ("no_such_pass", "-fuse_attenton"):
        with pytest.raises(KeyError):
            tpasses.resolve_passes(bad)
    with pytest.raises(ValueError):
        tpasses.PassManager(["fuse_bias_act_dropout", "fuse_attention"])
    with pytest.raises(ValueError):
        tpasses.resolve_passes("health_sentinel,fuse_attention")


def test_health_sentinel_raises_by_name():
    """The health_sentinel pass is ported (health/transpile.py): on a
    1-layer BERT it inserts the sentinel as the JAX package's adapter
    does, the same op list, idempotently.  What raises by name under the
    sentinel is the data-parallel runner
    (test_torch_port_data_parallel.py)."""
    types = {}
    for pkg in PKGS:
        main = _bert(pkg, num_layers=1)
        rep = _run(pkg, main, ["health_sentinel"])
        assert rep[-1]["changed"] and rep[-1]["sites"] == 1
        assert not _run(pkg, main, ["health_sentinel"])[-1]["changed"]
        types[pkg] = _types(main)
    assert types["port"] == types["jax"]
    assert types["port"].count("health_check") == 1


def test_data_parallel_transpile_adapter_needs_loss_name():
    main, _, _, loss = _attention_chain("port")
    mgr = tpasses.PassManager(["data_parallel_transpile"])
    with pytest.raises(ValueError, match="loss_name"):
        mgr.run(main, tpasses.PassContext())
    rep = mgr.run(main, tpasses.PassContext(loss_name=loss.name,
                                            num_devices=2))
    assert rep[-1]["changed"]
    assert any(t.startswith("c_allreduce") for t in _types(main))
    assert not mgr.run(main, tpasses.PassContext(
        loss_name=loss.name, num_devices=2))[-1]["changed"]


def test_selfcheck_catches_non_idempotent_pass():
    from paddle_tpu_torch.passes.framework import _PASS_REGISTRY

    @tpasses.register_program_pass
    class _BadPass(tpasses.ProgramPass):
        name = "_test_bad_pass"

        def apply(self, program, ctx):
            return {"changed": True, "sites": 1}

    try:
        main = _bert("port", num_layers=1)
        with pytest.raises(AssertionError, match="idempotence"):
            tpasses.PassManager(["_test_bad_pass"]).run(
                main, tpasses.PassContext(), selfcheck=True)
    finally:
        _PASS_REGISTRY.pop("_test_bad_pass", None)


# ---------------------------------------------------------------------------
# rewrite parity: the same op lists as the JAX package
# ---------------------------------------------------------------------------


def test_bert_train_rewrite_matches_jax_and_is_idempotent():
    rep, main = _both(lambda pkg: _bert(pkg), jpasses.DEFAULT_PASSES)
    fa = rep[0]
    assert fa["pass"] == "fuse_attention"
    assert (fa["sites"], fa["bias_sites"], fa["causal_sites"]) == (2, 2, 0)
    assert rep[1]["sites"] == 3 and rep[2]["sites"] == 0
    t = _types(main)
    assert t.count("flash_attention") == 2
    assert t.count("flash_attention_grad") == 2
    for op in main.global_block().ops:
        if op.type == "flash_attention_grad":
            fwd = main.global_block().ops[op.attrs["fwd_op_idx"]]
            assert fwd.type == "flash_attention"
            assert fwd.inputs["Q"] == op.inputs["Q"]
    again = tpasses.PassManager(tpasses.DEFAULT_PASSES).run(main)
    assert not any(e["changed"] for e in again[-3:])


def test_bert_inference_clone_absorbs_is_test_dropout():
    rep, main = _both(lambda pkg: _bert(pkg, num_layers=1, attn_dropout=0.1,
                                        optimizer=False, for_test=True),
                      ["fuse_attention"])
    assert rep[-1]["sites"] == 1
    assert "flash_attention_grad" not in _types(main)
    assert not any(op.type == "dropout"
                   and op.inputs["X"][0].startswith("softmax")
                   for op in main.global_block().ops)


def test_causal_chain_maps_to_causal_flash():
    rep, main = _both(lambda pkg: _attention_chain(pkg, causal=True)[0],
                      ["fuse_attention"])
    assert rep[-1]["sites"] == 1 and rep[-1]["causal_sites"] == 1
    (fused,) = [op for op in main.global_block().ops
                if op.type == "flash_attention"]
    assert fused.attrs["causal"] is True
    assert fused.attrs["sm_scale"] == pytest.approx(8 ** -0.5)
    assert "softmax_mask_fuse_upper_triangle" not in _types(main)


def test_softmax_cross_entropy_head_rewrite_matches_jax():
    rep, main = _both(lambda pkg: _sce(pkg)[0],
                      ["fuse_softmax_cross_entropy"])
    assert rep[-1]["sites"] == 1 and rep[-1]["modeled_bytes_saved"] == 0
    t = _types(main)
    assert "fused_softmax_cross_entropy_grad" in t
    assert "cross_entropy" not in t and "softmax_grad" not in t
    assert t.count("softmax") == 1  # kept, now without a reader
    rep, _ = _both(lambda pkg: _sce(pkg, static=True, optimizer=False)[0],
                   ["fuse_softmax_cross_entropy"])
    assert rep[-1]["modeled_bytes_saved"] == 8 * 16 * 4


# ---------------------------------------------------------------------------
# vetoes: the port declines where the JAX package declines
# ---------------------------------------------------------------------------


def _vetoed(build, names, keep_vars=lambda p: ()):
    rep, main = _both(build, names, keep_vars)
    assert rep[-1]["changed"] is False
    return main


def _softmax_out(program):
    return [op.output("Out")[0] for op in program.global_block().ops
            if op.type == "softmax"][0]


def _dropout_masks(program):
    return [op.outputs["Mask"][0] for op in program.global_block().ops
            if op.type == "dropout"]


@pytest.mark.parametrize("case", [
    "training_attention_dropout", "mismatched_qk", "full_rank_bias",
    "fetch_pinned", "mask_fetch_pinned", "downgrade_dropout"])
def test_fuse_attention_vetoes_match_jax(case):
    names = ["fuse_attention"]
    if case == "training_attention_dropout":
        main = _vetoed(lambda pkg: _bert(pkg, num_layers=1,
                                         attn_dropout=0.1), names)
        assert "flash_attention" not in _types(main)
    elif case == "mismatched_qk":
        _vetoed(lambda pkg: _attention_chain(pkg, kv_len=16)[0], names)
    elif case == "full_rank_bias":
        _vetoed(lambda pkg: _attention_chain(pkg, bias_shape=[2, 2, 8, 8])[0],
                names)
    elif case == "fetch_pinned":
        _vetoed(lambda pkg: _bert(pkg, num_layers=1), names,
                keep_vars=lambda p: [_softmax_out(p)])
    elif case == "mask_fetch_pinned":
        _vetoed(lambda pkg: _bert(pkg, num_layers=1, attn_dropout=0.1,
                                  optimizer=False, for_test=True), names,
                keep_vars=_dropout_masks)
    else:
        _vetoed(lambda pkg: _attention_chain(
            pkg, dropout="downgrade_in_infer", train=False)[0], names)


def test_key_bias_and_is_test_upscale_dropout_do_match():
    """The counterparts of the veto cases that must fuse: a [B,1,1,S]
    bias and an is_test upscale dropout."""
    rep, _ = _both(lambda pkg: _attention_chain(
        pkg, bias_shape=[2, 1, 1, 8], dropout="upscale_in_train",
        train=False)[0], ["fuse_attention"])
    assert rep[-1]["sites"] == 1 and rep[-1]["bias_sites"] == 1


def _with_sub_block_reader(pkg, program, name):
    """A second block of ``program`` that reads ``name`` (a while or
    cond body would)."""
    if pkg == "jax":
        sub = program._create_block()
        program._rollback()
    else:
        from paddle_tpu_torch.fluid.framework import Block

        sub = Block(program, len(program.blocks), 0)
        program.blocks.append(sub)
    out = sub.create_var(name="sub_out", shape=[-1], dtype="float32")
    sub.append_op("scale", inputs={"X": [name]}, outputs={"Out": [out]},
                  attrs={"scale": 2.0})
    return program


def test_sub_block_reader_vetoes_attention_fusion():
    def build(pkg):
        main = _bert(pkg, num_layers=1, optimizer=False, for_test=True)
        return _with_sub_block_reader(pkg, main, _softmax_out(main))

    _vetoed(build, ["fuse_attention"])


def test_sub_block_consumer_ends_the_bias_act_chain():
    def build(pkg):
        fluid = PKGS[pkg][0]
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            h = fluid.layers.fc(x, size=8, act="gelu")
        return _with_sub_block_reader(pkg, main, h.name)

    rep, main = _both(build, ["fuse_bias_act_dropout"])
    assert rep[-1]["sites"] == 1 and rep[-1]["dropout_sites"] == 0
    assert [op.type for op in main.blocks[1].ops] == ["scale"]


def _second_probs_reader_veto():
    """A second reader of the softmax output (a reduce_mean) vetoes the
    fusion in both packages.  The reader is built under its own
    unique_name guard: its output name then comes from a fresh counter
    in each package, not from the process-wide ones, which drift apart
    with whatever the process built before."""
    def build(pkg):
        fluid = PKGS[pkg][0]
        main, _, _, probs = _sce(pkg, optimizer=False)
        with fluid.program_guard(main), fluid.unique_name.guard():
            fluid.layers.reduce_mean(probs)
        return main

    main = _vetoed(build, ["fuse_softmax_cross_entropy"])
    assert "cross_entropy" in _types(main)


def test_second_probs_reader_vetoes_softmax_xent():
    _second_probs_reader_veto()


def test_second_probs_reader_veto_after_jax_layers_built():
    """The veto check after the JAX package has built a reduce_mean of
    its own outside the check's guards (as an earlier test in the same
    worker may): its name counter is then one ahead of the port's, and
    the two op lists must still agree name for name.  Both packages'
    counters start fresh here and are given back on exit, so the drift
    is the same whatever the worker ran before and does not outlive the
    test."""
    with jfluid.unique_name.guard(), tfluid.unique_name.guard():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            x = jfluid.layers.data(name="x", shape=[4], dtype="float32")
            jfluid.layers.reduce_mean(x)
        _second_probs_reader_veto()


def test_downgrade_dropout_rejected_by_fused_bias_act():
    from paddle_tpu_torch.fluid import registry

    info = registry.get_op("fused_bias_act_dropout")
    ctx = registry.LowerContext("cpu")
    with pytest.raises(NotImplementedError, match="upscale_in_train"):
        info.lower(ctx, torch.zeros(2, 8), torch.zeros(8),
                   attrs={"dropout_prob": 0.3,
                          "dropout_implementation": "downgrade_in_infer"})


# ---------------------------------------------------------------------------
# numbers
# ---------------------------------------------------------------------------


def _with_flag(fluid, spec, fn):
    old = fluid.get_flags("FLAGS_graph_passes")
    fluid.set_flags({"FLAGS_graph_passes": spec})
    try:
        return fn()
    finally:
        fluid.set_flags(old)


def _bert_tiny_train(fluid, bert):
    cfg = bert.BertConfig.tiny(use_flash_attention=False, num_layers=2,
                               attn_dropout=0.0, hidden_dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return cfg, main, startup, loss


def test_bert_tiny_20_steps_passes_on_off_and_against_jax():
    """20 fp32 Adam steps of the unfused BERT-tiny from the JAX
    package's initial state: the JAX package with the passes on, the
    port with them on and off."""
    from paddle_tpu_torch import convert

    cfg, jmain, jstartup, jloss = _bert_tiny_train(jfluid, jbert)
    feed = jbert.make_fake_batch(cfg, 4, 32, seed=7)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        init = {n: np.array(jscope.get(n)) for n in list(jscope.keys())
                if jscope.get(n) is not None}
        want = _with_flag(jfluid, "default", lambda: [
            float(np.asarray(jexe.run(jmain, feed=feed,
                                      fetch_list=[jloss.name])[0]))
            for _ in range(20)])
    assert "flash_attention" in _types(jmain)

    def port(spec):
        _, main, startup, loss = _bert_tiny_train(tfluid, tbert)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        convert.load_params(scope, {n: a for n, a in init.items()
                                    if scope.get(n) is not None},
                            tfluid.CPUPlace(), program=main)
        losses = _with_flag(tfluid, spec, lambda: [
            float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(20)])
        return losses, main

    on, onmain = port("default")
    off, offmain = port("none")
    assert _types(onmain).count("flash_attention") == 2
    assert "flash_attention" not in _types(offmain)
    np.testing.assert_allclose(on, off, rtol=0, atol=1e-5)
    np.testing.assert_allclose(on, want, rtol=0, atol=1e-5)
    assert on[-1] < on[0]


@pytest.mark.parametrize("soft_label", [False, True])
def test_fused_softmax_cross_entropy_bit_equal_20_steps(soft_label):
    def run(spec):
        def go():
            main, startup, loss, _ = _sce("port", soft_label=soft_label)
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            feed = _sce_data(soft_label)
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]) for _ in range(20)]
            return losses, main
        return _with_flag(tfluid, spec, go)

    off, offmain = run("none")
    on, onmain = run("fuse_softmax_cross_entropy")
    assert "fused_softmax_cross_entropy" in _types(onmain)
    assert "cross_entropy" in _types(offmain)
    np.testing.assert_array_equal(np.asarray(on), np.asarray(off))
    assert on[-1] < on[0]


def test_probs_fetch_survives_and_plans_prune_the_kept_softmax():
    def go():
        main, startup, loss, probs = _sce("port")
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = _sce_data()
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert "fused_softmax_cross_entropy" in _types(main)
        def plan_types(fetch):
            plan = texe._Plan(main, feed.keys(), [fetch.name])
            return [s[0].type for s in plan.steps]

        assert "softmax" not in plan_types(loss)
        assert plan_types(probs).count("softmax") == 1
        (pv,) = exe.run(main, feed=feed, fetch_list=[probs], scope=scope)
        assert pv.shape == (16, 4)
        np.testing.assert_allclose(pv.sum(axis=1), 1.0, rtol=1e-5)
        infer = main.clone(for_test=True)
        (pv2,) = exe.run(infer, feed={"x": feed["x"]}, fetch_list=[probs],
                         scope=scope)
        assert pv2.shape == (16, 4)

    _with_flag(tfluid, "fuse_softmax_cross_entropy", go)


def test_causal_chain_fused_equals_composed():
    """The causal chain's forward output and one SGD step, the passes on
    (the flash plain version, causal) against off, on the same start."""
    feed = {"x": np.random.RandomState(3).randn(2, 8, 16).astype("float32")}

    def run(spec):
        def go():
            main, startup, out, loss = _attention_chain("port", causal=True)
            startup.random_seed = 11
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            got = [exe.run(main, feed=feed, fetch_list=[out],
                           scope=scope)[0] for _ in range(2)]
            return got, main
        return _with_flag(tfluid, spec, go)

    on, onmain = run("fuse_attention")
    off, _ = run("none")
    assert "flash_attention" in _types(onmain)
    for a, b in zip(on, off):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_off_configuration_is_bit_identical_and_flag_flip_warns():
    def go():
        main = _bert("port", num_layers=1)
        before = [(op.type, dict(op.attrs)) for op in main.global_block().ops]
        assert tpasses.apply_graph_passes(main) is None
        assert main._graph_passes_done == ()
        tfluid.set_flags({"FLAGS_graph_passes": "default"})
        with pytest.warns(UserWarning, match="FLAGS_graph_passes"):
            tpasses.apply_graph_passes(main)
        assert [(op.type, dict(op.attrs))
                for op in main.global_block().ops] == before
        assert getattr(main, "_pass_report", None) is None

    _with_flag(tfluid, "none", go)


def _save_encoder(dirname, seed=3):
    """An unfused BERT-tiny encoder (is_test), saved by the port with
    seeded weights."""
    cfg = tbert.BertConfig.tiny(use_flash_attention=False, num_layers=2)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        feeds = [tfluid.data(n, [-1, -1], False, dtype=dt)
                 for n, dt in (("src_ids", "int64"), ("pos_ids", "int64"),
                               ("sent_ids", "int64"),
                               ("input_mask", "float32"))]
        enc = tbert.bert_encoder(*feeds, cfg, is_test=True)
    startup.random_seed = seed
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(
            dirname, [f.name for f in feeds], [enc], exe, main_program=main)
    return cfg


def test_predictor_over_unfused_bert_passes_on_off_and_jax(tmp_path):
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference as tinf

    d = str(tmp_path)
    cfg = _save_encoder(d)
    data = tbert.make_fake_batch(cfg, 2, 32, seed=9)
    names = ("src_ids", "pos_ids", "sent_ids", "input_mask")

    def load(inf, fluid, spec):
        def go():
            config = inf.AnalysisConfig(d)
            config.disable_gpu()
            p = inf.create_paddle_predictor(config)
            (out,) = p.run([inf.PaddleTensor(data[n], name=n)
                            for n in names])
            return p, out.as_ndarray()
        return _with_flag(fluid, spec, go)

    p_on, on = load(tinf, tfluid, "default")
    _, off = load(tinf, tfluid, "none")
    _, jax_on = load(jinf, jfluid, "default")
    t = _types(p_on._program)
    assert t.count("flash_attention") == 2
    assert "fused_bias_act_dropout" in t and "softmax" not in t
    np.testing.assert_allclose(on, off, rtol=0, atol=1e-5)
    np.testing.assert_allclose(on, jax_on, rtol=0, atol=1e-5)


def test_dp_runner_passes_loss_name_and_applies_passes():
    def go():
        main, startup, _, loss = _attention_chain("port")
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
        cp = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[tfluid.CPUPlace()] * 2)
        exe = tfluid.Executor(tfluid.CPUPlace())
        feed = {"x": np.random.RandomState(0).randn(4, 8, 16)
                .astype("float32")}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        t = _types(main)
        assert "flash_attention" in t and "flash_attention_grad" in t
        assert any(x.startswith("c_allreduce") for x in t)

    _with_flag(tfluid, "default", go)


# ---------------------------------------------------------------------------
# the ops the passes match or emit, against the JAX registry
# ---------------------------------------------------------------------------

_r = np.random.RandomState(11)
_probs = np.asarray(_r.dirichlet(np.ones(6), size=5), np.float32)
_probs[1, 2] = 0.0  # the eps clamp
_hard = np.array([[2], [2], [-100], [5], [0]], np.int64)
_soft = np.asarray(_r.dirichlet(np.ones(6), size=5), np.float32)
_logits = np.asarray(_r.randn(5, 6) * 3, np.float32)
_scores = np.asarray(_r.randn(2, 3, 7, 7) * 2, np.float32)

# name: (op type, inputs, attrs)
OP_CASES = {
    "cross_entropy_hard": ("cross_entropy", [_probs, _hard],
                           {"soft_label": False, "ignore_index": -100}),
    "cross_entropy_soft": ("cross_entropy", [_probs, _soft],
                           {"soft_label": True}),
    "fused_softmax_ce_hard": ("fused_softmax_cross_entropy",
                              [_logits, _hard],
                              {"axis": -1, "soft_label": False,
                               "ignore_index": -100}),
    "fused_softmax_ce_soft": ("fused_softmax_cross_entropy",
                              [_logits, _soft],
                              {"axis": -1, "soft_label": True,
                               "ignore_index": -100}),
    "causal_softmax": ("softmax_mask_fuse_upper_triangle", [_scores], {}),
    "relu": ("relu", [_logits], {}),
}


def _lower_both(op_type, inputs, attrs):
    from paddle_tpu.fluid import registry as jreg
    from paddle_tpu_torch.fluid import registry as treg

    import jax.numpy as jnp

    jctx = jreg.LowerContext(step=0)
    jctx.op_index = 0
    want = jreg.get_op(op_type).lower(
        jctx, *[None if a is None else jnp.asarray(a) for a in inputs],
        attrs=dict(attrs))
    got = treg.get_op(op_type).lower(
        treg.LowerContext("cpu"),
        *[None if a is None else torch.from_numpy(np.array(a))
          for a in inputs], attrs=dict(attrs))
    wrap = (lambda o: o if isinstance(o, tuple) else (o,))
    return wrap(got), wrap(want)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_pass_ops_and_grads_match_jax(case):
    op_type, inputs, attrs = OP_CASES[case]
    got, want = _lower_both(op_type, inputs, attrs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=case)
    dout = np.asarray(_r.randn(*got[0].shape), np.float32)
    got, want = _lower_both(op_type + "_grad", inputs + [dout], attrs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5, err_msg=case)
    assert all(g is None for g in got[1:])


def test_pass_after_a_plan_keys_a_new_signature():
    """A rewrite applied after the program has run bumps its version: the
    next run builds a new plan over the rewritten op list instead of
    running the old one."""
    feed = {"x": np.random.RandomState(1).randn(2, 8, 16).astype("float32")}

    def go():
        main, startup, out, _ = _attention_chain("port", train=False)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        (before,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        tpasses.PassManager(["fuse_attention"]).run(main)
        (after,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        plans = [[s[0].type for s in e.plan.steps]
                 for e in exe.compiled_for(main)]
        assert len(plans) == 2
        assert ["flash_attention" in p for p in plans] == [False, True]
        np.testing.assert_allclose(after, before, rtol=0, atol=1e-5)

    _with_flag(tfluid, "none", go)


def test_predictor_keeps_a_fetched_attention_output(tmp_path):
    """A saved model that fetches the attention probabilities too: the
    predictor's keep_vars pin them, so the chain stays composed and both
    fetches match the passes-off predictor."""
    from paddle_tpu_torch import inference as tinf

    main, startup, out, _ = _attention_chain("port", train=False)
    probs = _softmax_out(main)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), ["x"], [out, probs], exe,
                                   main_program=main, scope=scope)
    x = np.random.RandomState(2).randn(2, 8, 16).astype("float32")

    def load(spec):
        def go():
            config = tinf.AnalysisConfig(str(tmp_path))
            config.disable_gpu()
            p = tinf.create_paddle_predictor(config)
            got = [t.as_ndarray() for t in p.run([tinf.PaddleTensor(
                x, name="x")])]
            return p, got
        return _with_flag(tfluid, spec, go)

    p_on, on = load("default")
    _, off = load("none")
    assert "flash_attention" not in _types(p_on._program)
    assert "softmax" in _types(p_on._program)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
