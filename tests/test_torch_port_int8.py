"""The int8-KV decode lane of the PyTorch port against the JAX package's.

Kernel and op level, in this process, on the same seeded numpy inputs:

- the dual-int8 codec: ``quantize_lastdim`` codes (hi, lo) and scales
  bit-equal to the JAX function's, and the dequantised pool equal;
- the quant write ops (``kv_cache_write_quant``,
  ``kv_cache_write_pages_quant``) against the JAX registry, exactly;
- K7's plain version, ``paged_attention_quant_reference``, against the
  JAX reference and the JAX Pallas kernel in interpret mode, at 2e-5
  (fp32: the oracles sum keys in another order).
- K7's split plan at the int8 lane's shapes, and what its wrapper hands
  the kernel (build stubbed): the plan's workspace and the shared,
  zeroed arrival counters.

Lane level, against a child process (tests/torch_port_serving_oracle.py)
that runs the JAX ``DecodeEngine(pool_dtype="int8")`` on the tiny GPT of
tests/decode_e2e_checks.py trained 30 steps: the port's int8 engine on
CPUPlace is token-exact with it, its logprobs over the int8 pool are
within 1e-4 (fp32 matmuls summed in another order), and its int8
programs list the same ops after the graph passes.

The CUDA kernel itself runs only on a GPU: tests/test_torch_port_cuda.py
and ``python3 chip_smoke.py`` hold it against the plain version there.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.kernels.primitives import int8 as jint8
from paddle_tpu.kernels.primitives import paged as jpaged
from paddle_tpu.serving.kv_pool import KVPool as JKVPool

from paddle_tpu_torch import convert, fluid
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.kernels.primitives import int8 as tint8
from paddle_tpu_torch.kernels.primitives import paged as tpaged
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving.kv_pool import KVPool

K7_TOL = 2e-5
LOGP_ATOL = 1e-4
ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_serving_oracle.py")


# ---------------------------------------------------------------------------
# the dual-int8 codec
# ---------------------------------------------------------------------------


def _codec_inputs(name):
    rng = np.random.RandomState(len(name))
    if name == "random":
        return rng.randn(5, 3, 4, 64).astype(np.float32)
    if name == "wide_range":
        x = rng.randn(7, 32).astype(np.float32)
        return x * np.logspace(-6, 6, 7, dtype=np.float32)[:, None]
    if name == "zero_vectors":
        x = rng.randn(4, 16).astype(np.float32)
        x[1] = 0.0
        return x
    # halves: amax 127 gives scale 1, so x / scale lands on .5 exactly
    # and round-half-to-even decides the code
    return np.asarray([[127.0, 63.5, -62.5, 0.5, -1.5, 2.5, 0.0, -127.0]],
                      np.float32)


@pytest.mark.parametrize("name", ["random", "wide_range", "zero_vectors",
                                  "ties"])
def test_quantize_lastdim_bit_equal_to_jax(name):
    x = _codec_inputs(name)
    got = tint8.quantize_lastdim(torch.from_numpy(x))
    want = jint8.quantize_lastdim(x)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        tint8.dequantize_lastdim(*got).numpy(),
        np.asarray(jint8.dequantize_lastdim(*want)))


def test_codec_round_trip_and_bytes():
    x = torch.from_numpy(_codec_inputs("random"))
    back = tint8.dequantize_lastdim(*tint8.quantize_lastdim(x))
    # hi + lo / 254 resolves the vector to scale / 508 = amax / 64516
    amax = x.abs().amax(dim=-1, keepdim=True)
    assert bool(((back - x).abs() <= amax / 64516 + 1e-7).all())
    flat = x.reshape(-1, 64)
    hi, lo, sc = tint8.quantize_block_scaled(flat.reshape(-1), 64)
    # the flat form spells the inverse hi·s + lo·(s/254): other rounding
    np.testing.assert_allclose(
        tint8.dequantize_block_scaled(hi, lo, sc, 64).numpy(),
        back.reshape(-1).numpy(), rtol=1e-6, atol=1e-7)
    for n, blk in ((1000, 64), (64, 64), (5, 32)):
        assert tint8.dual_int8_bytes(n, blk) == jint8.dual_int8_bytes(n, blk)
        assert tint8.bytes_saved(n, blk) == jint8.bytes_saved(n, blk)


# ---------------------------------------------------------------------------
# the quant write ops, against the JAX registry
# ---------------------------------------------------------------------------


def _pool(rng, p=6, page=4, n=2, d=16):
    hi = rng.randint(-127, 128, (p, page, n, d)).astype(np.int8)
    lo = rng.randint(-127, 128, (p, page, n, d)).astype(np.int8)
    sc = rng.rand(p, page, n, 1).astype(np.float32)
    return hi, lo, sc


def _jax_op(op, inputs):
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    out = jreg.get_op(op).lower(ctx, *map(jnp.asarray, inputs), attrs={})
    return [np.asarray(o) for o in out]


def _port_op(op, inputs):
    ctx = treg.LowerContext("cpu")
    ts = [torch.from_numpy(np.array(a)) for a in inputs]
    out = treg.get_op(op).lower(ctx, *ts, attrs={})
    for o, t in zip(out, ts[:3]):
        assert o is t  # the pool is updated in place
    return [o.numpy() for o in out]


def test_kv_cache_write_quant_matches_jax():
    rng = np.random.RandomState(0)
    new = rng.randn(3, 2, 16).astype(np.float32) * 4
    # slot 2 writes the trash page, as an inactive decode slot does
    inputs = (*_pool(rng), new, np.asarray([3, 1, 0], np.int32),
              np.asarray([2, 0, 0], np.int32))
    for g, w in zip(_port_op("kv_cache_write_quant", inputs),
                    _jax_op("kv_cache_write_quant", inputs)):
        np.testing.assert_array_equal(g, w)


def test_kv_cache_write_pages_quant_matches_jax():
    rng = np.random.RandomState(1)
    new = rng.randn(8, 2, 16).astype(np.float32)
    inputs = (*_pool(rng), new, np.asarray([5, 0], np.int32))
    for g, w in zip(_port_op("kv_cache_write_pages_quant", inputs),
                    _jax_op("kv_cache_write_pages_quant", inputs)):
        np.testing.assert_array_equal(g, w)


def test_quant_write_ops_refuse_bad_pools():
    rng = np.random.RandomState(2)
    hi, lo, sc = _pool(rng)
    with pytest.raises(ValueError, match="whole pages"):
        _port_op("kv_cache_write_pages_quant",
                 (hi, lo, sc, rng.randn(6, 2, 16).astype(np.float32),
                  np.asarray([1, 2], np.int32)))
    with pytest.raises(ValueError, match="int8"):
        _port_op("kv_cache_write_quant",
                 (hi.astype(np.float32), lo, sc,
                  rng.randn(1, 2, 16).astype(np.float32),
                  np.asarray([1], np.int32), np.asarray([0], np.int32)))


# ---------------------------------------------------------------------------
# K7's plain version, against the JAX reference and Pallas interpret
# ---------------------------------------------------------------------------

PGS, MAXP, NPAGES, N, D = 4, 4, 13, 2, 16
Q_STARTS = {"zero": 0, "page_boundary": PGS, "mid_page": PGS + 2,
            "full_length": None}


def _quant_case(t, start, seed=0):
    rng = np.random.RandomState(seed)
    b = 3
    if start is None:
        start = MAXP * PGS - t
    q = rng.randn(b, N, t, D).astype(np.float32)
    pool = []
    for _ in range(2):
        pool += [np.array(a) for a in jint8.quantize_lastdim(
            rng.randn(NPAGES, PGS, N, D).astype(np.float32))]
    pages = rng.permutation(np.arange(1, NPAGES))
    table = np.zeros((b, MAXP), np.int32)
    q_start = np.array([start, max(start - 1, 0),
                        min(start + 1, MAXP * PGS - t)], np.int32)
    for r in range(b):
        live = (q_start[r] + t - 1) // PGS + 1
        table[r, :live] = pages[r * MAXP:r * MAXP + live]
    return (q, *pool, table, q_start)


def _port_quant(case, **kw):
    out = tpaged.paged_attention_quant(*map(torch.from_numpy, case),
                                       sm_scale=D ** -0.5, **kw)
    return out.numpy()


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("start", sorted(Q_STARTS))
@pytest.mark.parametrize("t", [1, 4])
def test_paged_quant_plain_matches_jax(t, start, oracle):
    case = _quant_case(t, Q_STARTS[start])
    if oracle == "reference":
        want = jpaged.paged_attention_quant_reference(*case,
                                                      sm_scale=D ** -0.5)
    else:
        want = jpaged.paged_attention_quant(*case, sm_scale=D ** -0.5,
                                            force="pallas")
    np.testing.assert_allclose(_port_quant(case), np.asarray(want),
                               atol=K7_TOL, rtol=K7_TOL)


def test_paged_quant_never_attends_trash_page():
    case = list(_quant_case(4, PGS + 2))
    clean = _port_quant(case)
    for i in (3, 6):  # the K and V scales of page 0
        case[i] = case[i].copy()
        case[i][0] = 1e4
    np.testing.assert_array_equal(_port_quant(case), clean)


def test_paged_quant_wrapper_checks():
    case = [torch.from_numpy(a) for a in _quant_case(1, 0)]
    bad = list(case)
    bad[1] = bad[1].float()
    with pytest.raises(ValueError, match="int8"):
        tpaged.paged_attention_quant(*bad)
    bad = list(case)
    bad[3] = bad[3][..., :1, :]
    with pytest.raises(ValueError, match="scale"):
        tpaged.paged_attention_quant(*bad)
    with pytest.raises(ValueError, match="force"):
        tpaged.paged_attention_quant(*case, force="pallas")
    launches = tpaged.paged_attention_quant.launches
    out = tpaged.paged_attention_quant(*case, force="reference")
    assert tpaged.paged_attention_quant.launches == launches  # no kernel
    assert out.shape == case[0].shape


@pytest.mark.parametrize("case,b,t", [("decode", 8, 1), ("prefill", 1, 32)])
def test_paged_quant_split_plan_at_lane_shapes(case, b, t):
    """K7 plans as K5 does: at the int8 lane's shapes (12 heads, d 64,
    pages of 16, 64 logical pages) eight splits of eight pages, one page
    a warp of the library's eight, with the partials and counters of
    every (row, head, query)."""
    plan = tpaged.split_plan(b, 12, t, 64, 64, 16, 8)
    assert (plan.pages_per_split, plan.splits) == (8, 8)
    assert plan.workspace == (b, 12, t, 8, 66)
    assert plan.arrivals == b * 12 * t


class _FakeQuantLib:
    """Stands in for the built library: a CTA of ``warps`` warps, and
    each K7 launch's arguments recorded."""

    def __init__(self, warps):
        self.warps = warps
        self.calls = []

    def pt_paged_warps(self):
        return self.warps

    def pt_paged_attention_quant_f32(self, *args):
        self.calls.append(args)
        return 0


def test_paged_quant_wrapper_passes_the_shape_plan(monkeypatch):
    """K7's kernel branch, driven on CPU tensors with the build stubbed
    (each pointer argument handed over as its tensor): the plan from
    shapes and the library's warps, a workspace of the plan's shape,
    zeroed arrival counters shared with the next launch in the stream
    (and with K5's), the same plan for other q_start and page-table
    values, and null workspace and counters for one split."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _FakeQuantLib(warps=4)
    monkeypatch.setattr(tpaged, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_of",
                        lambda dev: ctypes.c_void_p(1234))
    monkeypatch.setattr(tpaged, "_arrivals", {})
    rng = np.random.RandomState(0)
    b, n, t, d, pgs, maxp = 2, 3, 1, 16, 16, 64
    q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32))
    codes = torch.zeros(2 * maxp + 1, pgs, n, d, dtype=torch.int8)
    scale = torch.ones(2 * maxp + 1, pgs, n, 1)
    plan = tpaged.split_plan(b, n, t, d, maxp, pgs, 4)
    assert (plan.pages_per_split, plan.splits) == (4, 16)
    before = tpaged.paged_attention_quant.launches
    for starts in ([0, 5], [1023, 700]):
        table = torch.from_numpy(rng.randint(1, 2 * maxp + 1, (b, maxp))
                                 .astype(np.int32))
        tpaged.paged_attention_quant(
            q, codes, codes, scale, codes, codes, scale, table,
            torch.tensor(starts, dtype=torch.int32))
    assert tpaged.paged_attention_quant.launches == before + 2
    for part, arrivals, *ints in (c[10:21] for c in lib.calls):
        assert part.shape == plan.workspace and part.dtype == torch.float32
        assert arrivals.dtype == torch.int32
        assert arrivals.numel() >= plan.arrivals and not arrivals.any()
        assert tuple(ints) == (b, n, t, d, pgs, maxp, 2 * maxp + 1,
                               plan.pages_per_split, plan.splits)
    assert lib.calls[0][11] is lib.calls[1][11]  # one set for the stream
    lib.calls.clear()
    few = torch.zeros(5, pgs, n, d, dtype=torch.int8)
    one = tpaged.split_plan(b, n, t, d, 2, pgs, 4)
    tpaged.paged_attention_quant(
        q, few, few, torch.ones(5, pgs, n, 1), few, few,
        torch.ones(5, pgs, n, 1), torch.ones(b, 2, dtype=torch.int32),
        torch.zeros(b, dtype=torch.int32))
    assert one.splits == 1 and one.workspace is None
    assert lib.calls[0][10:12] == (None, None)
    assert lib.calls[0][19:21] == (one.pages_per_split, 1)


# ---------------------------------------------------------------------------
# the pool and the engine's bookkeeping
# ---------------------------------------------------------------------------


def test_kv_pool_int8_install_and_modeled_bytes():
    cfg = (2, 4, 16, 9, 4, 8)
    pool = KVPool(*cfg, dtype="int8")
    jpool = JKVPool(*cfg, dtype="int8")
    assert pool.quant_var_names == [tuple(map(tuple, layer))
                                    for layer in jpool.quant_var_names]
    assert pool.modeled_bytes() == jpool.modeled_bytes()
    assert pool.modeled_bytes_fp32() == jpool.modeled_bytes_fp32()
    scope = fluid.Scope()
    pool.install(scope, "cpu")
    (hi, lo, sc), _ = pool.quant_var_names[0]
    assert scope.get(hi).dtype == torch.int8
    assert tuple(scope.get(sc).shape) == (9, 4, 4, 1)
    # an fp32 pool over the same scope replaces nothing of the int8 one
    KVPool(*cfg).install(scope, "cpu")
    assert scope.get(hi).dtype == torch.int8


def _random_engine(**kw):
    cfg = gpt.GPTConfig.tiny(num_layers=1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return DecodeEngine(cfg, scope=scope, place=fluid.CPUPlace(),
                        pool_slots=2, page_size=4, prefill_chunk=4,
                        max_len=16, auto_start=False, **kw)


def _saved_kv():
    fam = metrics.REGISTRY.get("pt_int8_bytes_saved_total")
    return fam.labels(kind="kv_cache").value if fam else 0.0


def test_engine_books_saving_and_flag_default():
    before = _saved_kv()
    eng = _random_engine(pool_dtype="int8")
    eng.close()
    assert eng.pool.dtype == "int8"
    assert _saved_kv() - before == (eng.pool.modeled_bytes_fp32()
                                    - eng.pool.modeled_bytes()) > 0
    fluid.set_flags({"FLAGS_int8_kv_cache": True})
    try:
        eng = _random_engine()
        eng.close()
        assert eng.pool.dtype == "int8"
    finally:
        fluid.set_flags({"FLAGS_int8_kv_cache": False})
    eng = _random_engine()
    eng.close()
    assert eng.pool.dtype == "float32"


# ---------------------------------------------------------------------------
# the lane, against the JAX int8 engine (child-process oracle)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle8") / "oracle.npz"
    r = subprocess.run([sys.executable, ORACLE, str(out)],
                       capture_output=True, text=True, timeout=900,
                       cwd=os.path.dirname(os.path.dirname(ORACLE)))
    assert r.returncode == 0 and "TORCH_PORT_SERVING_ORACLE_OK" in r.stdout, (
        f"JAX oracle child failed rc={r.returncode}\n{r.stderr[-3000:]}")
    z = np.load(out)
    return {k: z[k] for k in z.files}


def _cfg():
    return gpt.GPTConfig.tiny(num_layers=2, hidden_dropout=0.0,
                              use_flash_attention=False)


def _params_scope(oracle):
    cfg = _cfg()
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
    scope = fluid.Scope()
    convert.load_params(scope, {k[len("param:"):]: v
                                for k, v in oracle.items()
                                if k.startswith("param:")},
                        fluid.CPUPlace(), program=main)
    return cfg, scope


def _generate(oracle, prompts):
    cfg, scope = _params_scope(oracle)
    slots, page, chunk, max_len = (int(v) for v in oracle["engine"])
    eng = DecodeEngine(cfg, scope=scope, place=fluid.CPUPlace(),
                       pool_slots=slots, page_size=page,
                       prefill_chunk=chunk, max_len=max_len,
                       pool_dtype="int8", auto_start=False)
    try:
        eng.warmup()
        eng.start()
        return eng.generate([list(p) for p in prompts], max_new_tokens=6,
                            timeout=300)
    finally:
        eng.close()


def test_int8_greedy_ids_token_exact(oracle):
    ids = _generate(oracle, oracle["prompts_base"])
    np.testing.assert_array_equal(np.asarray(ids), oracle["ids_base"])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_int8_chunked_prefill_token_exact(oracle, i):
    ids = _generate(oracle, [oracle[f"prompt_long{i}"]])
    np.testing.assert_array_equal(np.asarray(ids[0]), oracle[f"ids_long{i}"])


def _lane(oracle):
    cfg, scope = _params_scope(oracle)
    lane = dict(zip(("page_size", "max_pages", "num_pages", "chunk",
                     "slots"), (int(v) for v in oracle["lane"])))
    n, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    KVPool(cfg.num_layers, n, d, lane["num_pages"], lane["page_size"],
           lane["max_pages"], dtype="int8").install(scope, "cpu")
    progs = {}
    for name, build in (
            ("prefill", lambda: gpt.build_gpt_prefill_chunk(
                cfg, lane["chunk"], lane["num_pages"], lane["page_size"],
                lane["max_pages"], pool_dtype="int8")),
            ("decode", lambda: gpt.build_gpt_decode_step(
                cfg, lane["slots"], lane["num_pages"], lane["page_size"],
                lane["max_pages"], pool_dtype="int8"))):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, logp = build()
        progs[name] = (main, logp.name)
    return scope, progs


def _feed(oracle, prefix):
    return {k[len(prefix):]: v for k, v in oracle.items()
            if k.startswith(prefix)}


def test_int8_logprobs_match_jax(oracle):
    scope, progs = _lane(oracle)
    exe = fluid.Executor(fluid.CPUPlace())
    for i in range(2):
        (lp,) = exe.run(progs["prefill"][0], feed=_feed(oracle, f"pf{i}:"),
                        fetch_list=[progs["prefill"][1]], scope=scope)
        np.testing.assert_allclose(lp, oracle[f"pf{i}_logp"],
                                   atol=LOGP_ATOL, rtol=0)
    (lp,) = exe.run(progs["decode"][0], feed=_feed(oracle, "dec:"),
                    fetch_list=[progs["decode"][1]], scope=scope)
    np.testing.assert_allclose(lp, oracle["dec_logp"], atol=LOGP_ATOL,
                               rtol=0)


@pytest.mark.parametrize("program", ["decode", "prefill"])
def test_int8_post_pass_op_lists_match_jax(oracle, program):
    scope, progs = _lane(oracle)
    main, fetch = progs[program]
    feed = _feed(oracle, "dec:" if program == "decode" else "pf0:")
    exe = fluid.Executor(fluid.CPUPlace())
    (want,) = exe.run(main, feed=feed, fetch_list=[fetch],
                      scope=scope)  # the passes run
    ops = [op.type for op in main.global_block().ops]
    assert ops == [str(t) for t in oracle[f"ops_{program}"]]
    assert ops.count("paged_attention_quant") == 2  # one per layer
    assert "paged_attention" not in ops
    # then fc_fuse_pass, as the predictor runs it: the same fused op list,
    # and the same logprobs from the fused program (its writes rewrite the
    # slots the first run wrote, with the same values)
    fluid.ir.apply_pass(main, "fc_fuse_pass", keep_vars=[fetch])
    ops = [op.type for op in main.global_block().ops]
    assert ops == [str(t) for t in oracle[f"ops_fc_{program}"]]
    assert "fc" in ops
    (lp,) = exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
    np.testing.assert_allclose(lp, want, atol=LOGP_ATOL, rtol=0)
