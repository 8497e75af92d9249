"""The ragged serving.Engine lane of the PyTorch port against the JAX
package's, on the CPU.

- K6's plain version, ``ragged_attention_reference``, against the JAX
  reference and the JAX Pallas kernel in interpret mode: causal on and
  off, S = 200, a row of length 0, both input forms, at 2e-5 (fp32: the
  kernel sums keys tile by tile).
- The ops the lane adds (``fc``, ``reduce_mean``, ``ragged_attention``)
  against the JAX registry.
- ``fluid.io`` + ``inference``: a model the JAX package saved loads in
  the port and scores within 1e-5 of the JAX predictor (fp32 matmuls in
  another order); a model the port saved loads in the JAX package; both
  programs list the same ops after ``fc_fuse_pass``.
- The Engine's ragged contract, mirroring tests/test_ragged_serving.py on
  the port's Engine with CPUPlace(): one shape per batch bucket, zero
  padding rows and zero cold runs on mixed waves, padding rows on the
  bucketed lane, typed rejection of an over-length request, ragged
  without sequence buckets raising, and the FLAGS_ragged_attention
  default.

The CUDA kernel itself runs only on a GPU: tests/test_torch_port_cuda.py
and ``python3 chip_smoke.py`` hold it against the plain version there.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import layers as JL
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.executor import scope_guard as jscope_guard
from paddle_tpu.kernels.primitives import ragged as jragged

from paddle_tpu_torch import fluid, inference, serving
from paddle_tpu_torch.fluid import layers as L
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.kernels.primitives import ragged as tragged
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import FeedValidationError

K6_TOL = 2e-5
SCORE_TOL = 1e-5
VOCAB, HIDDEN, HEADS = 64, 32, 2
SEQ_BUCKETS = [4, 8, 16]


# ---------------------------------------------------------------------------
# K6 plain version vs the JAX reference and Pallas interpret
# ---------------------------------------------------------------------------


def _ragged_case(shape, lengths, seed=0):
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    return qkv + [np.asarray(lengths, np.int32)]


RAGGED_CASES = {
    # [BH, S, D]: a full row, a ragged one, a short one, a length-0 row
    "3d_s200_d64": ((4, 200, 64), [200, 137, 5, 0]),
    # [B, H, S, D] with lengths [B]: the serving shape, padding row 0
    "4d_s32_d32": ((3, 2, 32, 32), [20, 32, 0]),
}


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_plain_matches_jax(case, causal, oracle):
    q, k, v, lengths = _ragged_case(*RAGGED_CASES[case])
    got = tragged.ragged_attention(*map(torch.from_numpy, (q, k, v, lengths)),
                                   causal=causal)
    if oracle == "reference" and q.ndim == 3:
        want = jragged.ragged_attention_reference(q, k, v, lengths,
                                                  causal=causal)
    else:
        want = jragged.ragged_attention(
            q, k, v, lengths, causal=causal,
            force="pallas" if oracle == "pallas" else "reference")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K6_TOL,
                               rtol=K6_TOL)
    if case.startswith("3d"):
        assert not got.numpy()[3].any()  # length 0: zeros


# the redesigned kernel's contract: D 96 and 128, and bf16 (computed in
# fp32, returned in q's dtype).  bf16: both round one fp32 result to
# bf16, so one bf16 step (2^-8 relative) apart at most
K6_BF16_TOL = 1e-2
CONTRACT_CASES = {
    "3d_s40_d96": ((3, 40, 96), [40, 17, 0], np.float32),
    "4d_s24_d128": ((2, 2, 24, 128), [24, 9], np.float32),
    "4d_s32_d32_bf16": ((3, 2, 32, 32), [20, 32, 0], "bfloat16"),
    "3d_s40_d64_bf16": ((3, 40, 64), [40, 5, 0], "bfloat16"),
}


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_ragged_plain_contract_matches_jax(case, causal, oracle):
    """The port's plain K6 at the head dims and dtype the redesigned
    kernel takes, against the JAX reference and the Pallas kernel in
    interpret mode on the same inputs (bf16 made from the same fp32)."""
    shape, lengths, dtype = CONTRACT_CASES[case]
    q, k, v, lens = _ragged_case(shape, lengths)
    if dtype == "bfloat16":
        tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tol = K6_BF16_TOL
    else:
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        jq, jk, jv = q, k, v
        tol = K6_TOL
    got = tragged.ragged_attention(tq, tk, tv, torch.from_numpy(lens),
                                   causal=causal)
    want = jragged.ragged_attention(jq, jk, jv, lens, causal=causal,
                                    force=oracle)
    assert got.dtype == tq.dtype and str(want.dtype) == str(jq.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=tol, rtol=tol)


class _FakeK6:
    def __init__(self):
        self.calls = []

    def pt_ragged_attention_f32(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_ragged_wrapper_hands_kernel_its_arguments(monkeypatch, dtype,
                                                   code):
    """The kernel branch with the build stubbed: the dtype code, q/k/v as
    [B, H, S, D] views read in place (a [BH, S, D] input as H = 1), the
    lengths, an output in q's layout and dtype, B, H, S, D, the twelve
    (b, h, s) strides, the scale and the causal flag; one launch
    counted.  D 128 is taken, D 160 and mixed dtypes are refused by
    name before the build is asked for."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _FakeK6()
    monkeypatch.setattr(tragged, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_of",
                        lambda dev: ctypes.c_void_p(1234))
    q, k, v = (torch.zeros(2, 24, 3, 128, dtype=dtype).transpose(1, 2)
               for _ in range(3))
    lens = torch.tensor([24, 7], dtype=torch.int32)
    before = tragged.ragged_attention.launches
    out = tragged.ragged_attention(q, k, v, lens, causal=True)
    args = lib.calls[-1]
    assert args[0] == code
    assert args[1] is q and args[2] is k and args[3] is v
    assert args[4] is lens and args[5] is out
    assert out.dtype == dtype and out.stride() == q.stride()
    assert args[6:10] == (2, 3, 24, 128)
    assert args[10:22] == tuple(q.stride()[:3]) * 4
    assert args[22] == pytest.approx(128 ** -0.5) and args[23] == 1
    q3 = torch.zeros(5, 7, 20, dtype=dtype)
    out3 = tragged.ragged_attention(q3, q3, q3, torch.ones(5, dtype=torch.int32),
                                    sm_scale=0.5)
    args = lib.calls[-1]
    assert args[6:10] == (5, 1, 7, 20) and args[5].shape == (5, 1, 7, 20)
    assert args[10:13] == (140, 140, 20) and args[22:24] == (0.5, 0)
    assert out3.shape == q3.shape
    assert tragged.ragged_attention.launches == before + 2
    calls = len(lib.calls)
    wide = torch.zeros(1, 2, 16, 160, dtype=dtype)
    with pytest.raises(ValueError, match="head dim 160 > 128"):
        tragged.ragged_attention(wide, wide, wide, lens[:1])
    with pytest.raises(TypeError, match="one dtype"):
        tragged.ragged_attention(q, k.half(), v, lens)
    with pytest.raises(ValueError, match="int32"):
        tragged.ragged_attention(q, k, v, lens.long())
    assert len(lib.calls) == calls
    assert tragged.ragged_attention.launches == before + 2


def test_ragged_plain_reads_transposed_views():
    """The op's q/k/v are transpose2 views of [B, S, H, D]: the plain
    version takes them as they are."""
    q, k, v, lengths = _ragged_case((2, 24, 3, 16), [24, 9])
    views = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    got = tragged.ragged_attention(*views, torch.from_numpy(lengths),
                                   causal=True)
    want = tragged.ragged_attention(*(t.contiguous() for t in views),
                                    torch.from_numpy(lengths), causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ragged_wrapper_checks():
    q, k, v, lengths = map(torch.from_numpy,
                           _ragged_case((2, 2, 8, 4), [8, 3]))
    with pytest.raises(ValueError, match="one length per row"):
        tragged.ragged_attention(q, k, v, lengths[:1])
    with pytest.raises(ValueError, match="shape"):
        tragged.ragged_attention(q, k[:1], v, lengths)
    with pytest.raises(ValueError, match="force"):
        tragged.ragged_attention(q, k, v, lengths, force="pallas")
    launches = tragged.ragged_attention.launches
    out = tragged.ragged_attention(q, k, v, lengths, force="reference")
    assert tragged.ragged_attention.launches == launches  # no kernel on CPU
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# the lane's ops against the JAX registry
# ---------------------------------------------------------------------------


def _both(op, inputs, attrs):
    jctx = jreg.LowerContext(step=0)
    jctx.op_index = 0
    want = jreg.get_op(op).lower(
        jctx, *[None if a is None else jnp.asarray(a) for a in inputs],
        attrs=dict(attrs))
    got = treg.get_op(op).lower(
        treg.LowerContext("cpu"),
        *[None if a is None else torch.from_numpy(np.array(a))
          for a in inputs], attrs=dict(attrs))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("act,bias", [("", True), ("relu", True),
                                      ("", False)])
def test_fc_op_matches_jax(act, bias):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 8).astype(np.float32)
    w = rng.randn(8, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if bias else None
    got, want = _both("fc", [x, w, b], {"in_num_col_dims": 2,
                                        "activation_type": act})
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("attrs", [
    {"dim": [1, 2], "keep_dim": False, "reduce_all": False},
    {"dim": [-1], "keep_dim": True, "reduce_all": False},
    {"dim": [0], "keep_dim": False, "reduce_all": True}])
def test_reduce_mean_op_matches_jax(attrs):
    x = np.random.RandomState(4).randn(3, 4, 5).astype(np.float32)
    got, want = _both("reduce_mean", [x], attrs)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_ragged_attention_op_matches_jax():
    q, k, v, lengths = _ragged_case((2, 2, 16, 8), [16, 6])
    got, want = _both("ragged_attention", [q, k, v, lengths],
                      {"causal": True})
    np.testing.assert_allclose(got, want, atol=K6_TOL, rtol=K6_TOL)


# ---------------------------------------------------------------------------
# saved models across the two packages
# ---------------------------------------------------------------------------


def _build_ragged(fl, layers):
    """The one-layer ragged scorer of tests/test_ragged_serving.py, with
    either package's front end: ids [-1, -1] int64 + lens [-1] int32."""
    head_dim = HIDDEN // HEADS
    ids = fl.data("ids", [-1, -1], False, dtype="int64")
    lens = fl.data("lens", [-1], False, dtype="int32")
    x = layers.embedding(ids, size=[VOCAB, HIDDEN])
    qkv = [layers.reshape(layers.fc(x, size=HIDDEN, num_flatten_dims=2),
                          shape=[0, 0, HEADS, head_dim]) for _ in range(3)]
    q, k, v = [layers.transpose(t, perm=[0, 2, 1, 3]) for t in qkv]
    ctx = layers.ragged_attention(q, k, v, lens, causal=True)
    ctx = layers.reshape(layers.transpose(ctx, perm=[0, 2, 1, 3]),
                         shape=[0, 0, HIDDEN])
    x = layers.elementwise_add(x, layers.fc(ctx, size=HIDDEN,
                                            num_flatten_dims=2))
    return layers.reshape(layers.reduce_mean(x, dim=[1, 2]), shape=[-1, 1])


def _save_jax_model(d):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        score = _build_ragged(jfluid, JL)
    scope = JScope()
    with jscope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["ids", "lens"], [score], exe,
                                       main_program=main)
    return d


def _save_port_model(d):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        score = _build_ragged(fluid, L)
    startup.random_seed = 7
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(d, ["ids", "lens"], [score], exe,
                                  main_program=main, scope=scope)
    return d


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    return _save_jax_model(str(tmp_path_factory.mktemp("jax_ragged")))


@pytest.fixture(scope="module")
def ragged_model(tmp_path_factory):
    return _save_port_model(str(tmp_path_factory.mktemp("port_ragged")))


def _score_feed():
    rng = np.random.RandomState(9)
    return {"ids": rng.randint(1, VOCAB, (4, 16)).astype(np.int64),
            "lens": np.asarray([16, 7, 3, 0], np.int32)}


def _jax_predictor(d):
    cfg = jinference.AnalysisConfig(d)
    cfg.disable_gpu()
    return jinference.create_paddle_predictor(cfg)


def _port_predictor(d):
    cfg = inference.AnalysisConfig(d)
    cfg.disable_gpu()
    return inference.create_paddle_predictor(cfg)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_saved_model_scores_match_across_packages(saved_by, jax_model,
                                                  ragged_model):
    d = jax_model if saved_by == "jax" else ragged_model
    feed = _score_feed()
    jp, tp = _jax_predictor(d), _port_predictor(d)
    assert tp.get_input_names() == jp.get_input_names() == ["ids", "lens"]
    assert tp.get_output_names() == jp.get_output_names()
    (name,) = tp.get_output_names()
    got = tp.run_feed_dict(feed)[name]
    want = np.asarray(jp.run_feed_dict(feed)[name])
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=SCORE_TOL)


def test_fc_fuse_op_lists_match_jax(jax_model, ragged_model):
    """The JAX-built and the port-built programs, each loaded by its own
    package's predictor (graph passes + fc_fuse_pass), list the same ops;
    the saved JSON holds the same ops before the pass."""
    ops = {}
    for key, d, pred in (("jax", jax_model, _jax_predictor),
                         ("port", ragged_model, _port_predictor)):
        ops[key] = [op.type for op in pred(d).program().global_block().ops]
        with open(os.path.join(d, "__model__")) as f:
            ops[key + "_saved"] = [op["type"] for op in
                                   json.load(f)["blocks"][0]["ops"]]
    assert ops["port"] == ops["jax"]
    assert ops["port_saved"] == ops["jax_saved"]
    assert ops["port"].count("fc") == 4 and "mul" not in ops["port"]
    assert ops["port_saved"].count("mul") == 4


def test_predictor_apis(ragged_model):
    pred = _port_predictor(ragged_model)
    feed = _score_feed()
    (name,) = pred.get_output_names()
    want = pred.run_feed_dict(feed)[name]
    outs = pred.run([inference.PaddleTensor(feed["ids"]),
                     inference.PaddleTensor(feed["lens"])])
    np.testing.assert_array_equal(outs[0].as_ndarray(), want)
    for n in pred.get_input_names():
        pred.get_input_tensor(n).copy_from_cpu(feed[n])
    assert pred.zero_copy_run()
    np.testing.assert_array_equal(
        pred.get_output_tensor(name).copy_to_cpu(), want)
    with pytest.raises(ValueError, match="kind"):
        pred.get_input_tensor("ids").copy_from_cpu(feed["ids"] * 0.5)
    with pytest.raises(ValueError, match="missing"):
        pred.run_feed_dict({"ids": feed["ids"]})
    with pytest.raises(NotImplementedError, match="quantization"):
        inference.AnalysisConfig(ragged_model).enable_quantizer()


def test_predictor_and_engine_run_on_the_card_unless_told():
    """No place and no GPU: the entry points raise instead of falling
    back to the CPU; disable_gpu() and CPUPlace() ask for it."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults would run on it")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        serving.Engine(batch_buckets=[2], auto_start=False)
    cfg = inference.AnalysisConfig("/nonexistent")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        inference.AnalysisPredictor(cfg)
    cfg.disable_gpu()
    assert cfg._place == fluid.CPUPlace()
    eng = serving.Engine(batch_buckets=[2], auto_start=False,
                         place=fluid.CPUPlace())
    assert eng.place == fluid.CPUPlace()
    eng.close()


def test_io_round_trip(tmp_path):
    """program_to_dict / from_dict keep every var and op; save_vars and
    load_vars move values through .npy or one .npz, and through Fluid's
    LoDTensor streams (reference_format); a model format that is neither
    JSON nor protobuf raises."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _build_ragged(fluid, L)
    back = fluid.io.program_from_dict(fluid.io.program_to_dict(main))
    assert [op.type for op in back.global_block().ops] == \
        [op.type for op in main.global_block().ops]
    assert {v.name: (v.shape, v.dtype) for v in back.list_vars()} == \
        {v.name: (v.shape, v.dtype) for v in main.list_vars()}
    assert sorted(p.name for p in back.all_parameters()) == \
        sorted(p.name for p in main.all_parameters())
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for reference_format in (False, True):
        for filename in (None, "all.npz"):
            d = str(tmp_path / f"{filename}_{reference_format}")
            names = fluid.io.save_params(exe, d, main, filename=filename,
                                         scope=scope,
                                         reference_format=reference_format)
            other = fluid.Scope()
            assert fluid.io.load_params(
                exe, d, main, filename=filename, scope=other,
                reference_format=reference_format) == names
            for n in names:
                assert torch.equal(other.get(n), scope.get(n))
    with pytest.raises(ValueError, match="model_format"):
        fluid.io.save_inference_model(str(tmp_path / "pb"), ["ids"], [],
                                      exe, main_program=main,
                                      model_format="onnx")


def test_clone_for_test_drops_backward_and_flips_is_test():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", [-1, 4], False)
        y = L.dropout(L.fc(x, size=3), 0.5)
        loss = L.mean(y)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    test = main.clone(for_test=True)
    roles = {op.attrs.get("op_role", "forward")
             for op in test.global_block().ops}
    assert roles <= {"forward", "loss"}
    assert [op.attrs["is_test"] for op in test.global_block().ops
            if op.type == "dropout"] == [True]
    assert len(main.global_block().ops) > len(test.global_block().ops)


# ---------------------------------------------------------------------------
# the Engine's ragged contract (tests/test_ragged_serving.py, on the port)
# ---------------------------------------------------------------------------


def _engine(**kw):
    return serving.Engine(auto_start=False, place=fluid.CPUPlace(), **kw)


def _feed(rng, ln):
    return {"ids": rng.randint(1, VOCAB, (1, ln)).astype(np.int64),
            "lens": np.full((1,), ln, np.int32)}


def _rows(model, kind):
    fam = metrics.REGISTRY.get("pt_serve_rows_total")
    samples = fam._snapshot()["samples"] if fam else {}
    return samples.get((model, kind), 0.0)


def test_warmup_one_executable_per_batch_bucket(ragged_model):
    eng = _engine(batch_buckets=[2, 4], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=5, name="rg_warm")
    try:
        eng.load_model("bucketed", ragged_model, ragged=False)
        eng.load_model("ragged", ragged_model, ragged=True)
        warmed = eng.warmup()
    finally:
        eng.close()
    assert warmed["bucketed"] == 2 * len(SEQ_BUCKETS)
    assert warmed["ragged"] == 2


def test_mixed_length_wave_zero_padding_zero_cold(ragged_model):
    rng = np.random.RandomState(0)
    eng = _engine(batch_buckets=[4], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=20, name="rg_wave")
    try:
        eng.load_model("m", ragged_model, ragged=True)
        eng.warmup()
        eng.start()
        lane = eng._lanes["m"]
        cold0 = lane._cache_counts["cold"]
        pad0, real0 = _rows("m", "padding"), _rows("m", "real")
        for _ in range(3):  # three full mixed-length waves
            futs = [eng.submit("m", _feed(rng, ln)) for ln in (3, 5, 7, 2)]
            for f in futs:
                assert next(iter(f.result(timeout=120).values())) \
                    .shape[0] == 1
        assert lane._cache_counts["cold"] - cold0 == 0
        assert _rows("m", "real") - real0 == 12
        assert _rows("m", "padding") - pad0 == 0
        assert eng.stats()["models"]["m"]["warmup_batches"] == 1
    finally:
        eng.close()


def test_bucketed_lane_pays_padding_on_same_traffic(ragged_model):
    rng = np.random.RandomState(0)
    eng = _engine(batch_buckets=[4], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=5, name="rg_pad")
    try:
        eng.load_model("mb", ragged_model, ragged=False)
        eng.warmup()
        eng.start()
        pad0 = _rows("mb", "padding")
        futs = [eng.submit("mb", _feed(rng, ln)) for ln in (3, 5, 7, 2)]
        for f in futs:
            f.result(timeout=120)
        assert _rows("mb", "padding") - pad0 > 0
    finally:
        eng.close()


def test_over_length_rejected_typed(ragged_model):
    rng = np.random.RandomState(1)
    eng = _engine(batch_buckets=[4], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=5, name="rg_over")
    try:
        eng.load_model("mo", ragged_model, ragged=True)
        with pytest.raises(FeedValidationError,
                           match="above the ragged lane's single padded "
                                 "length 16"):
            eng.submit("mo", _feed(rng, 20))
    finally:
        eng.close()


def test_ragged_requires_seq_buckets(ragged_model):
    eng = _engine(batch_buckets=[4], max_wait_ms=5, name="rg_nosb")
    try:
        assert not eng.policy.seq_buckets
        with pytest.raises(ValueError, match="needs sequence buckets"):
            eng.load_model("mn", ragged_model, ragged=True)
    finally:
        eng.close()


def test_load_model_ragged_defaults_to_flag(ragged_model):
    eng = _engine(batch_buckets=[2], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=5, name="rg_flag")
    try:
        eng.load_model("off", ragged_model)
        assert eng._lanes["off"]._ragged is False
        fluid.set_flags({"FLAGS_ragged_attention": True})
        try:
            eng.load_model("on", ragged_model)
            assert eng._lanes["on"]._ragged is True
            assert eng._lanes["on"]._ragged_len == max(SEQ_BUCKETS)
        finally:
            fluid.set_flags({"FLAGS_ragged_attention": False})
    finally:
        eng.close()


def test_served_scores_equal_the_predictor(ragged_model):
    """A request's served row is the predictor's row for that request
    padded as the lane pads it (ragged: to the largest bucket)."""
    rng = np.random.RandomState(2)
    feeds = [_feed(rng, ln) for ln in (3, 16, 9)]
    eng = _engine(batch_buckets=[4], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=5, name="rg_scores")
    try:
        eng.load_model("s", ragged_model, ragged=True)
        eng.start()
        served = [eng.infer("s", f, timeout=120) for f in feeds]
    finally:
        eng.close()
    pred = _port_predictor(ragged_model)
    (name,) = pred.get_output_names()
    for f, out in zip(feeds, served):
        ids = np.zeros((1, 16), np.int64)
        ids[:, :f["ids"].shape[1]] = f["ids"]
        want = pred.run_feed_dict({"ids": ids, "lens": f["lens"]})[name]
        np.testing.assert_allclose(out[name], want, atol=1e-6, rtol=1e-6)


def test_admission_and_lifecycle_typed(ragged_model):
    """Queue limit, unknown model, bad feeds and a closed engine reject
    typed; queued futures of a closed engine fail typed."""
    rng = np.random.RandomState(3)
    eng = _engine(batch_buckets=[2], seq_buckets=SEQ_BUCKETS,
                  max_wait_ms=5, max_queue=1, name="rg_admit")
    eng.load_model("a", ragged_model, ragged=True)
    fut = eng.submit("a", _feed(rng, 4))
    with pytest.raises(serving.ServingOverloadError) as e:
        eng.submit("a", _feed(rng, 4))
    assert e.value.reason == "overload"
    with pytest.raises(serving.ModelNotLoadedError):
        eng.submit("nope", _feed(rng, 4))
    with pytest.raises(FeedValidationError, match="missing"):
        eng.submit("a", {"ids": _feed(rng, 4)["ids"]})
    eng.close()
    with pytest.raises(serving.ServingOverloadError):
        fut.result(timeout=10)
    with pytest.raises(serving.ServingOverloadError) as e:
        eng.submit("a", _feed(rng, 4))
    assert e.value.reason == "closed"
