"""Fluid's protobuf model format in the PyTorch port, against the JAX
package's codec (``paddle_tpu_torch/fluid/proto_compat.py``,
``fluid/io.py``'s ``model_format="protobuf"`` and
``reference_format=True``, the predictor over a binary ``__model__``).

- A 2-layer BERT encoder at hidden 64 and a MobileNet (one CNN of
  tests/test_proto_models.py), saved in the protobuf format with a
  combined parameter file by one package, served by the other's
  ``AnalysisPredictor`` on the CPU: predictions within 1e-5 of the
  saving package's own predictor, in both directions.
- The two codecs' bytes for the same program: equal but for the vars
  the JAX package types int32 where the port types int64 (its shape
  inference runs with x64 off), and each parses the other's.  What the
  format changes is named: a float attribute comes back rounded to
  float32.
- The four reference-signature control-flow tests of
  tests/test_tensor_array.py (:251, :371, :425, :468), each built in
  both packages and run through the port from the JAX package's bytes
  and its own, held to the JAX package's run.
- Variables as LoDTensor streams (``save_persistables(...,
  reference_format=True)``) cross between the packages bit for bit; a
  bfloat16 tensor keeps its bits under enum 22.
- A seeded mutation fuzz in the manner of tests/test_proto_fuzz.py:
  each malformed ProgramDesc or LoDTensor stream raises the port's
  ``ProgramParseError`` (and the JAX codec decides every input as the
  port does), within a time limit.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import io
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu import inference as jinf
from paddle_tpu.fluid import proto_compat as jproto
from paddle_tpu.fluid.framework import Operator as JOperator
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import mobilenet as jmobilenet

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import proto as tproto_pkg
from paddle_tpu_torch.fluid import proto_compat as tproto
from paddle_tpu_torch.fluid.framework import Operator as TOperator
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import mobilenet as tmobilenet

PKGS = {"jax": (jfluid, jinf, jproto, JOperator, jbert, jmobilenet),
        "port": (tfluid, tinf, tproto, TOperator, tbert, tmobilenet)}
ENC_FEEDS = (("src_ids", "int64"), ("pos_ids", "int64"),
             ("sent_ids", "int64"), ("input_mask", "float32"))


def _exe(pkg):
    fluid = PKGS[pkg][0]
    return fluid.Executor(fluid.CPUPlace())


def _bert_encoder(pkg):
    fluid, bert = PKGS[pkg][0], PKGS[pkg][4]
    cfg = bert.BertConfig.tiny(use_flash_attention=False, num_layers=2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = [fluid.data(n, [-1, -1], False, dtype=dt)
                 for n, dt in ENC_FEEDS]
        enc = bert.bert_encoder(*feeds, cfg, is_test=True)
    startup.random_seed = 7
    feed = tbert.make_fake_batch(cfg, 2, 16, seed=4)
    return main, startup, [n for n, _ in ENC_FEEDS], enc, \
        {n: feed[n] for n, _ in ENC_FEEDS}


def _mobilenet(pkg):
    fluid, mobilenet = PKGS[pkg][0], PKGS[pkg][5]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, pred, _, _ = mobilenet.build_mobilenet(
            class_dim=3, image_shape=(3, 16, 16), is_test=True,
            cfg=((8, 1), (16, 2)))
    startup.random_seed = 7
    xb = np.random.RandomState(0).rand(4, 3, 16, 16).astype("float32")
    return main.clone(for_test=True), startup, ["img"], pred, {"img": xb}


def _save(pkg, build, d):
    """Build in ``pkg``, initialize from its seeded startup, save in the
    protobuf format with one combined parameter file."""
    fluid = PKGS[pkg][0]
    main, startup, feed_names, target, feed = build(pkg)
    scope = fluid.Scope()
    exe = _exe(pkg)
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, feed_names, [target], exe,
                                      main_program=main,
                                      params_filename="__params__",
                                      model_format="protobuf")
    return feed


def _predict(pkg, d, feed):
    inf = PKGS[pkg][1]
    config = inf.AnalysisConfig(
        prog_file=os.path.join(d, "__model__"),
        params_file=os.path.join(d, "__params__"))
    config.disable_gpu()
    p = inf.create_paddle_predictor(config)
    out = p.run([inf.PaddleTensor(feed[n], name=n)
                 for n in p.get_input_names()])
    return [np.asarray(t.as_ndarray(), np.float32) for t in out], p


@pytest.mark.parametrize("model", ["bert_encoder", "mobilenet"])
@pytest.mark.parametrize("saver,loader", [("jax", "port"), ("port", "jax")])
def test_protobuf_model_crosses_packages(tmp_path, model, saver, loader):
    build = {"bert_encoder": _bert_encoder, "mobilenet": _mobilenet}[model]
    d = str(tmp_path)
    feed = _save(saver, build, d)
    with open(os.path.join(d, "__model__"), "rb") as f:
        raw = f.read()
    assert tproto.is_program_proto(raw) and jproto.is_program_proto(raw)
    want, _ = _predict(saver, d, feed)
    got, pred = _predict(loader, d, feed)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    if loader == "port":
        # the predictor's load ran the graph passes and fc_fuse_pass
        types = [op.type for op in pred.program().global_block().ops]
        assert ("flash_attention" in types) == (model == "bert_encoder")
        assert "feed" in types and "fetch" in types


def _raw_op(pkg, blk, type_, inputs, outputs, attrs):
    """An op in the reference signature, not validated (as Fluid
    exports it)."""
    if pkg == "jax":
        return JOperator(blk, type_, inputs=inputs, outputs=outputs,
                         attrs=attrs, skip_validate=True)
    op = TOperator(blk, None, attrs=attrs)
    op.type = type_
    op.inputs = {k: [v.name for v in vs] for k, vs in inputs.items()}
    op.outputs = {k: [v.name for v in vs] for k, vs in outputs.items()}
    return op


def _ref_while(pkg):
    fluid = PKGS[pkg][0]
    layers = fluid.layers
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = layers.data(name="x", shape=[3], dtype="float32")
    blk = main.global_block()
    i = blk.create_var(name="w_i", shape=(1,), dtype="int64")
    n = blk.create_var(name="w_n", shape=(1,), dtype="int64")
    acc = blk.create_var(name="w_acc", shape=(-1, 3), dtype="float32")
    cond = blk.create_var(name="w_cond", shape=(1,), dtype="bool")
    blk.append_op("fill_constant", outputs={"Out": [i]},
                  attrs={"shape": [1], "dtype": "int64", "value": 0.0})
    blk.append_op("fill_constant", outputs={"Out": [n]},
                  attrs={"shape": [1], "dtype": "int64", "value": 4.0})
    blk.append_op("fill_zeros_like", inputs={"X": [x]},
                  outputs={"Out": [acc]})
    blk.append_op("less_than", inputs={"X": [i], "Y": [n]},
                  outputs={"Out": [cond]}, attrs={})
    sub = main._create_block()
    main._rollback()
    sub.append_op("elementwise_add", inputs={"X": [acc], "Y": [x]},
                  outputs={"Out": [acc]}, attrs={})
    sub.append_op("increment", inputs={"X": [i]}, outputs={"Out": [i]},
                  attrs={"step": 1.0})
    sub.append_op("less_than", inputs={"X": [i], "Y": [n]},
                  outputs={"Out": [cond]}, attrs={})
    scopes = blk.create_var(name="w_scopes", shape=None, dtype=None)
    blk.ops.append(_raw_op(pkg, blk, "while",
                           {"X": [x, acc, i, n], "Condition": [cond]},
                           {"Out": [acc, i, cond], "StepScopes": [scopes]},
                           {"sub_block": sub.idx, "is_test": False}))
    xv = np.ones((2, 3), "float32") * 2.0
    return main, [({"x": xv}, ["w_acc"])], "while", "w_cond"


def _ref_conditional_block(pkg):
    fluid = PKGS[pkg][0]
    layers = fluid.layers
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = layers.data(name="x", shape=[3], dtype="float32")
        flag = layers.data(name="flag", shape=[1], dtype="bool")
    blk = main.global_block()
    out = blk.create_var(name="cb_out", shape=(-1, 3), dtype="float32")
    blk.append_op("fill_zeros_like", inputs={"X": [x]},
                  outputs={"Out": [out]})
    sub = main._create_block()
    main._rollback()
    sub.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                  attrs={"scale": 3.0})
    scope_var = blk.create_var(name="cb_scope", shape=None, dtype=None)
    blk.ops.append(_raw_op(pkg, blk, "conditional_block",
                           {"Input": [x], "Cond": [flag]},
                           {"Out": [out], "Scope": [scope_var]},
                           {"sub_block": sub.idx,
                            "is_scalar_condition": True}))
    xv = np.ones((2, 3), "float32")
    return main, [({"x": xv, "flag": np.array([[f]])}, ["cb_out"])
                  for f in (True, False)], "conditional_block", "cb_out"


def _ref_write_to_array(pkg):
    fluid = PKGS[pkg][0]
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data(name="x", shape=[2], dtype="float32")
        arr = layers.create_array("float32", capacity=4)
        i0 = layers.fill_constant(shape=[1], dtype="int64", value=0)
        layers.array_write(x, i0, array=arr)
        i1 = layers.fill_constant(shape=[1], dtype="int64", value=1)
        layers.array_write(layers.scale(x, scale=3.0), i1, array=arr)
        ln = layers.array_length(arr)
        second = layers.array_read(arr, i1)
    # strip the Array input, as Fluid exports write_to_array
    for op in main.global_block().ops:
        if op.type == "write_to_array":
            op.inputs.pop("Array", None)
    xv = np.array([[1, 2]], "float32")
    return main, [({"x": xv}, [ln.name, second.name])], "write_to_array", \
        None


def _same_bytes_but_x64(tbytes, jbytes):
    """The two codecs' bytes are equal, or differ only where the JAX
    package typed an int64 var int32 when it built the program (its
    shape inference runs with x64 off: fill_constant's int64 outputs);
    the ops are the same either way."""
    if tbytes == jbytes:
        return
    tprog = tproto.parse_program_bytes(tbytes)
    jprog = tproto.parse_program_bytes(jbytes)
    for tb, jb in zip(tprog.blocks, jprog.blocks):
        assert [(o.type, o.inputs, o.outputs, o.attrs) for o in tb.ops] \
            == [(o.type, o.inputs, o.outputs, o.attrs) for o in jb.ops]
        assert list(tb.vars) == list(jb.vars)
        for n, tv in tb.vars.items():
            jv = jb.vars[n]
            assert (tv.shape, tv.persistable) == (jv.shape, jv.persistable)
            assert tv.dtype == jv.dtype or (tv.dtype, jv.dtype) == (
                "int64", "int32"), n


def _run_program(pkg, program, feed, fetch):
    fluid = PKGS[pkg][0]
    exe = _exe(pkg)
    with fluid.scope_guard(fluid.Scope()):
        return [np.asarray(v) for v in exe.run(program, feed=feed,
                                               fetch_list=fetch)]


@pytest.mark.parametrize("build", [_ref_while, _ref_conditional_block,
                                   _ref_write_to_array],
                         ids=["while", "conditional_block",
                              "write_to_array"])
def test_reference_signature_control_flow_imports_and_runs(build):
    """Counterparts of tests/test_tensor_array.py:251 (the write_to_array
    import fixup), :371 (while) and :425 (conditional_block): the port
    normalizes the reference signature at import, from the JAX
    package's bytes and from its own, and runs it to the JAX package's
    values."""
    jmain, runs, op_type, carry = build("jax")
    tmain, _, _, _ = build("port")
    jbytes = jproto.serialize_program(jmain)
    _same_bytes_but_x64(tproto.serialize_program(tmain), jbytes)
    jprog = jproto.parse_program_bytes(jbytes)
    for tprog in (tproto.parse_program_bytes(jbytes),
                  tproto.parse_program_bytes(
                      tproto.serialize_program(tmain))):
        for top, jop in zip(tprog.global_block().ops,
                            jprog.global_block().ops):
            assert (top.type, top.inputs, top.outputs) == \
                (jop.type, jop.inputs, jop.outputs)
            assert top.attrs == jop.attrs
        ops = [o for o in tprog.global_block().ops if o.type == op_type]
        assert ops
        for op in ops:
            if carry is not None:
                assert carry in op.attrs["carry_names"]
            else:
                assert op.inputs["Array"] == op.outputs["Out"]
        for feed, fetch in runs:
            want = _run_program("jax", jprog, feed, fetch)
            got = _run_program("port", tprog, feed, fetch)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=0)


def test_write_to_array_import_after_jax_layers_built():
    """The write_to_array case after the JAX package has built a
    fill_constant of its own outside any guard (as an earlier test in
    the same worker may): its name counter is then one ahead of the
    port's, and the two programs must still agree name for name.  Both
    packages' counters start fresh here and are given back on exit, so
    the drift is the same whatever the worker ran before and does not
    outlive the test."""
    with jfluid.unique_name.guard(), tfluid.unique_name.guard():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup):
            jfluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        test_reference_signature_control_flow_imports_and_runs(
            _ref_write_to_array)


def test_imported_while_without_cond_update_fails_loudly():
    """Counterpart of tests/test_tensor_array.py:468."""
    for pkg in PKGS:
        fluid = PKGS[pkg][0]
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
        blk = main.global_block()
        cond = blk.create_var(name="c2", shape=(1,), dtype="bool")
        acc = blk.create_var(name="acc2", shape=(-1, 2), dtype="float32")
        blk.append_op("fill_constant", outputs={"Out": [cond]},
                      attrs={"shape": [1], "dtype": "bool", "value": 1.0})
        blk.append_op("fill_zeros_like", inputs={"X": [x]},
                      outputs={"Out": [acc]})
        sub = main._create_block()
        main._rollback()
        sub.append_op("elementwise_add", inputs={"X": [acc], "Y": [x]},
                      outputs={"Out": [acc]}, attrs={})  # cond never set
        sc = blk.create_var(name="sc2", shape=None, dtype=None)
        blk.ops.append(_raw_op(pkg, blk, "while",
                               {"X": [x, acc], "Condition": [cond]},
                               {"Out": [acc], "StepScopes": [sc]},
                               {"sub_block": sub.idx}))
        data = PKGS[pkg][2].serialize_program(main)
        with pytest.raises(ValueError, match="never written in the "
                                             "sub-block"):
            tproto.parse_program_bytes(data)


def test_conditional_block_infer_is_the_conditional_block_lowering():
    from paddle_tpu_torch.fluid import registry

    a = registry.get_op("conditional_block_infer")
    b = registry.get_op("conditional_block")
    assert a.lower is b.lower and a.input_slots == b.input_slots
    assert tproto_pkg.framework is tproto


@pytest.mark.parametrize("build", [_bert_encoder, _mobilenet],
                         ids=["bert_encoder", "mobilenet"])
def test_codecs_write_the_same_bytes(build):
    """The same program built in both packages: the codecs' bytes are
    equal, each parses the other's into the same op list; the one
    thing the format changes is named — a float attr comes back as
    float32."""
    progs = {pkg: build(pkg)[0] for pkg in PKGS}
    data = {pkg: PKGS[pkg][2].serialize_program(p)
            for pkg, p in progs.items()}
    _same_bytes_but_x64(data["port"], data["jax"])
    back = tproto.parse_program_bytes(data["jax"])
    ops = back.global_block().ops
    assert [o.type for o in ops] == [
        o.type for o in progs["port"].global_block().ops]
    floats = [(k, v, op.attrs[k])
              for op, src in zip(ops, progs["port"].global_block().ops)
              for k, v in src.attrs.items() if isinstance(v, float)]
    assert floats
    for name, before, after in floats:
        assert after == float(np.float32(before)), name


def test_persistables_cross_as_lod_tensor_streams(tmp_path):
    """save_persistables(reference_format=True) of one package loads
    bit for bit in the other, a file a var and combined; a bfloat16
    tensor keeps its bits."""
    progs = {}
    for pkg in PKGS:
        fluid = PKGS[pkg][0]
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.data("x", [-1, 4], False, dtype="float32")
            y = fluid.layers.fc(fluid.layers.fc(x, size=5), size=2)
            loss = fluid.layers.mean(y)
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        startup.random_seed = 3
        progs[pkg] = (main, startup)
    for saver, loader in (("jax", "port"), ("port", "jax")):
        for filename in (None, "combined"):
            d = str(tmp_path / f"{saver}_{filename}")
            sf, lf = PKGS[saver][0], PKGS[loader][0]
            s_scope, l_scope = sf.Scope(), lf.Scope()
            _exe(saver).run(progs[saver][1], scope=s_scope)
            _exe(loader).run(progs[loader][1], scope=l_scope)
            sf.io.save_persistables(_exe(saver), d, progs[saver][0],
                                    filename=filename, scope=s_scope,
                                    reference_format=True)
            names = lf.io.load_persistables(
                _exe(loader), d, progs[loader][0], filename=filename,
                scope=l_scope, reference_format=True)
            assert len(names) >= 6
            for n in names:
                a, b = s_scope.get(n), l_scope.get(n)
                a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
                    else np.asarray(a)
                b = b.cpu().numpy() if isinstance(b, torch.Tensor) \
                    else np.asarray(b)
                np.testing.assert_array_equal(a, b)
    t = torch.randn(3, 5).to(torch.bfloat16)
    buf = io.BytesIO()
    tproto.serialize_lod_tensor(buf, t)
    buf.seek(0)
    back, lod = tproto.deserialize_lod_tensor(buf)
    assert back.dtype == torch.bfloat16 and lod == []
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    buf.seek(0)
    jback, _ = jproto.deserialize_lod_tensor(buf)
    assert str(jback.dtype) == "bfloat16"
    np.testing.assert_array_equal(jback.view(np.int16),
                                  t.view(torch.int16).numpy())


# ---------------------------------------------------------------------------
# the trust boundary: malformed input raises ProgramParseError, as the
# JAX codec decides it, and never hangs
# ---------------------------------------------------------------------------

FUZZ_SECONDS = 20.0


def _valid_program_bytes():
    main, _, _, _, _ = _bert_encoder("port")
    return tproto.serialize_program(main)


def _decide(codec, data):
    """'ok' or the error class name of parsing ``data``."""
    try:
        codec.parse_program_bytes(bytes(data))
        return "ok"
    except codec.ProgramParseError:
        return "ProgramParseError"
    except ValueError as e:  # the named ValueError of an imported while
        return f"ValueError: {e}"


@pytest.mark.parametrize("mutation", ["truncate", "flip", "garbage"])
def test_mutated_program_bytes_raise_by_name(mutation):
    data = _valid_program_bytes()
    rng = np.random.RandomState(20)
    if mutation == "truncate":
        cases = [data[:n] for n in sorted(set(
            rng.randint(0, len(data), 150).tolist()))]
    elif mutation == "flip":
        cases = []
        for _ in range(120):
            b = bytearray(data)
            for pos in rng.randint(0, len(b), rng.randint(1, 4)):
                b[pos] = rng.randint(0, 256)
            cases.append(bytes(b))
    else:
        cases = [bytes(rng.randint(0, 256, n).astype(np.uint8))
                 for n in rng.randint(1, 200, 200)]
        cases += [b"\x0a" + b"\xff" * 20, b"\x0a\x80\x80\x80",
                  b"\x0a" * 64, b"\x0a\x05\x08"]
    t0 = time.monotonic()
    named = 0
    for c in cases:
        got = _decide(tproto, c)
        assert got == _decide(jproto, c), c[:40]
        named += got != "ok"
    assert named > 0
    assert time.monotonic() - t0 < FUZZ_SECONDS


def test_negative_and_out_of_range_block_indices_fail_by_name():
    main, _, _, _ = _ref_conditional_block("port")
    for bad in (-1, 99):
        for op in main.global_block().ops:
            if op.type == "conditional_block":
                op.attrs["sub_block"] = bad
        with pytest.raises(tproto.ProgramParseError,
                           match="out of range"):
            tproto.parse_program_bytes(tproto.serialize_program(main))


def test_corrupt_lod_tensor_stream_is_named_error():
    buf = io.BytesIO()
    tproto.serialize_lod_tensor(buf, np.arange(12, dtype=np.float32)
                                .reshape(3, 4), lod=[[0, 1, 3]])
    good = buf.getvalue()
    rng = np.random.RandomState(21)
    cases = [good[:n] for n in range(len(good))]
    for _ in range(200):
        b = bytearray(good)
        b[rng.randint(0, 60)] = rng.randint(0, 256)
        cases.append(bytes(b))
    t0 = time.monotonic()
    for c in cases:
        results = []
        for codec in (tproto, jproto):
            try:
                arr, _ = codec.deserialize_lod_tensor(io.BytesIO(c))
                results.append(("ok", np.asarray(arr).tobytes()))
            except codec.ProgramParseError:
                results.append(("named", None))
        assert results[0] == results[1]
    assert time.monotonic() - t0 < FUZZ_SECONDS
