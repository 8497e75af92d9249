"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test is marked ``cuda`` and skips without a GPU.  The
file imports no jax, so it runs on a GPU machine without it:

    PADDLE_TPU_TEST_REAL=1 python -m pytest tests/test_torch_port_cuda.py -q

(``PADDLE_TPU_TEST_REAL=1`` keeps tests/cpu_mesh.py from importing jax.)

Tolerances: K5 and K7 atol 2e-5 / rtol 1e-4 (online softmax over pages
merged across warps vs one softmax: same fp32 terms, other order); K6
2e-5 (fp32 sums over 64-key tiles vs one matmul); K4 1e-6 in
fp32 (the same elementwise formula; erfcf/tanhf may differ by an ulp)
and one bf16 rounding step (8e-3 relative) in bf16; K1-K3 2e-5 in fp32
(fp32 sums over 64-key tiles vs one matmul) and 2e-2 in bf16 (both
round an fp32 result to bf16, so they may differ by an ulp of it); the
decode lane's greedy ids exactly, over the fp32 and the int8 pool (the
tiny model's top-two gaps are far wider than the fp32 differences
between cuBLAS and the CPU); the ragged Engine's scores within 1e-5 of a
CPU engine's; the BERT step's losses on the card within 1e-4 of the
CPU's; K8 within 1e-6 of each tensor's largest element with equal
requant codes, the quantized all-reduce forms within 1e-6 of each
block's max of CPU replicas, and a dp 2 BERT-tiny run's losses within
1e-4 of CPU replicas'.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_bias_act as fba
from paddle_tpu_torch.kernels.primitives import flash, int8, paged, ragged

pytestmark = pytest.mark.cuda

K5_TOL = dict(atol=2e-5, rtol=1e-4)
K4_TOL = dict(atol=1e-6, rtol=1e-6)
K4_BF16_TOL = dict(atol=8e-3, rtol=8e-3)
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels have no "
                    "CPU form)")
    return torch.device("cuda", 0)


def _paged_case(dev, b, n, t, d, page_size, max_pages, q_start, seed=0):
    rng = np.random.RandomState(seed)
    num_pages = b * max_pages + 1
    q = rng.randn(b, n, t, d).astype(np.float32)
    kp = rng.randn(num_pages, page_size, n, d).astype(np.float32)
    vp = rng.randn(num_pages, page_size, n, d).astype(np.float32)
    kp[0] = vp[0] = 1e4  # the trash page: attending it would show
    pages = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        live = (q_start[r] + t - 1) // page_size + 1
        table[r, :live] = pages[r * max_pages:r * max_pages + live]
    return [torch.from_numpy(a).to(dev) for a in
            (q, kp, vp, table, np.asarray(q_start, np.int32))]


@pytest.mark.parametrize("name,b,n,t,d,page_size,max_pages,q_start", [
    # decode and prefill-chunk shapes of the lane (page of 16 x d 64: the
    # one-chunk, prefetching staging path)
    ("decode", 4, 3, 1, 64, 16, 8, [0, 15, 16, 127]),
    ("prefill", 1, 3, 32, 64, 16, 8, [64]),
    ("ragged_tile", 2, 2, 7, 64, 16, 4, [0, 40]),
    # page of 32 x 64 floats: more than one staging chunk
    ("big_page", 2, 2, 4, 64, 32, 4, [5, 100]),
    # d = 6: no float4 staging (scalar path); d = 128: four columns a lane
    ("d6", 2, 2, 3, 6, 4, 6, [0, 20]),
    ("d128", 2, 2, 1, 128, 8, 4, [3, 31]),
])
def test_paged_kernel_matches_plain(dev, name, b, n, t, d, page_size,
                                    max_pages, q_start):
    args = _paged_case(dev, b, n, t, d, page_size, max_pages, q_start)
    before = paged.paged_attention.launches
    got = paged.paged_attention(*args)
    assert paged.paged_attention.launches == before + 1
    want = paged.paged_attention(*args, force="reference")
    assert paged.paged_attention.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **K5_TOL)


def test_paged_kernel_unaligned_pool_uses_scalar_staging(dev):
    """A pool view 4 bytes off 16-byte alignment takes the scalar path
    and still agrees."""
    q, kp, vp, table, qs = _paged_case(dev, 2, 2, 1, 8, 4, 4, [3, 9])
    flat_k = torch.empty(kp.numel() + 1, device=dev)
    flat_v = torch.empty(vp.numel() + 1, device=dev)
    k_off = flat_k[1:].view(kp.shape).copy_(kp)
    v_off = flat_v[1:].view(vp.shape).copy_(vp)
    assert k_off.data_ptr() % 16 != 0
    got = paged.paged_attention(q, k_off, v_off, table, qs)
    want = paged.paged_attention(q, kp, vp, table, qs, force="reference")
    torch.testing.assert_close(got, want, **K5_TOL)


def test_paged_kernel_raises_not_falls_back(dev):
    """A CUDA tensor the kernel does not take raises; it never reaches the
    plain version silently."""
    q, kp, vp, table, qs = _paged_case(dev, 2, 2, 4, 8, 4, 4, [3, 9])
    with pytest.raises(ValueError, match="contiguous"):
        paged.paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                              kp, vp, table, qs)
    with pytest.raises(ValueError, match="int32"):
        paged.paged_attention(q, kp, vp, table.long(), qs)


@pytest.mark.parametrize("rows,h", [(8, 3072), (37, 3072), (5, 37)])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bias_gelu_kernel_matches_plain(dev, rows, h, approximate,
                                        with_mask):
    rng = np.random.RandomState(rows + h)
    x = torch.from_numpy(rng.randn(rows, h).astype(np.float32) * 3).to(dev)
    bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(dev)
    mask = (torch.from_numpy((rng.rand(rows, h) > .1).astype(np.uint8))
            .to(dev) if with_mask else None)
    kw = dict(mask=mask, scale=1 / 0.9 if with_mask else 1.0,
              approximate=approximate)
    before = fba.fused_bias_gelu.launches
    got = fba.fused_bias_gelu(x, bias, **kw)
    assert fba.fused_bias_gelu.launches == before + 1
    want = fba.fused_bias_gelu_reference(x, bias, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **K4_TOL)


def test_decode_lane_on_cuda_matches_cpu(dev):
    """A tiny GPT served on the card gives the CPU plain path's greedy
    ids, and every program run launched each kernel once a layer."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.kernels import kernel_wrappers
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = gpt.GPTConfig.tiny(num_layers=2, initializer_range=0.2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 4, 33, 4, 8)
    startup.random_seed = 11
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    gpu = fluid.Scope()
    convert.load_params(gpu, {p.name: cpu.get(p.name).numpy()
                              for p in main.all_parameters()},
                        fluid.CUDAPlace(0), program=main)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 20))]
    outs = {}
    for key, scope, place in (("cpu", cpu, fluid.CPUPlace()),
                              ("gpu", gpu, fluid.CUDAPlace(0))):
        eng = DecodeEngine(cfg, scope=scope, place=place, pool_slots=4,
                           page_size=4, prefill_chunk=8, max_len=32)
        counters = {k: w for k, w in kernel_wrappers().items()
                    if k in ("fused_bias_act", "paged_attention")}
        before = {k: w.launches for k, w in counters.items()}
        try:
            outs[key] = eng.generate(prompts, max_new_tokens=8, timeout=120)
        finally:
            eng.close()
        runs = eng.stats()["prefill_chunks"] + eng.stats()["steps"]
        for k, w in counters.items():
            expect = cfg.num_layers * runs if key == "gpu" else 0
            assert w.launches - before[k] == expect, k
    assert outs["gpu"] == outs["cpu"]


@pytest.mark.parametrize("rows,h", [(64, 3072), (37, 768), (5, 37)])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_bias_gelu_kernel_bf16_matches_plain(dev, rows, h, bias_dtype):
    """bf16 x (the bf16 policy's activations): computed in fp32, returned
    in bf16."""
    rng = np.random.RandomState(rows + h)
    x = torch.from_numpy(rng.randn(rows, h).astype(np.float32) * 3).to(
        dev, torch.bfloat16)
    bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(
        dev, bias_dtype)
    mask = torch.from_numpy((rng.rand(rows, h) > .1).astype(np.uint8)).to(
        dev)
    for kw in (dict(), dict(mask=mask, scale=1 / 0.9)):
        got = fba.fused_bias_gelu(x, bias, **kw)
        want = fba.fused_bias_gelu_reference(x, bias, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, **K4_BF16_TOL)


def _flash_case(dev, b, h, s, d, dtype, strided, seed=0):
    """q, k, v, dO as [B, H, S, D]: contiguous, or the transposed views
    of [B, S, H, D] tensors the BERT program hands the op; a key bias
    with -1e4 pads on some rows."""
    rng = np.random.RandomState(seed)

    def t():
        a = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        a = a.to(dev, dtype).transpose(1, 2)
        return a if strided else a.contiguous()

    q, k, v, do = t(), t(), t(), t()
    bias = np.zeros((b, s), np.float32)
    bias[0, s - s // 4:] = -1e4
    if b > 1:
        bias[1, 3:7] = -1e4
    rows = torch.from_numpy(np.repeat(bias, h, axis=0)).to(dev)
    return q, k, v, do, rows


@pytest.mark.parametrize("dtype,s,d,causal,strided", [
    (torch.bfloat16, 128, 64, False, True),   # the BERT path's case
    (torch.float32, 200, 64, False, True),    # a ragged last tile
    (torch.float32, 200, 64, True, False),
    (torch.float32, 64, 32, True, True),
    (torch.bfloat16, 77, 16, True, False),
])
def test_flash_kernels_match_plain(dev, dtype, s, d, causal, strided):
    b, h = 2, 3
    q, k, v, do, bias = _flash_case(dev, b, h, s, d, dtype, strided)
    scale = d ** -0.5
    counts = [f.launches for f in (flash.flash_fwd, flash.flash_bwd_dq,
                                   flash.flash_bwd_dkv)]
    o, lse = flash.flash_fwd(q, k, v, bias, causal, scale)
    o_ref, lse_ref = flash.flash_fwd(q, k, v, bias, causal, scale,
                                     force="reference")
    assert o.stride() == q.stride() and o.dtype == dtype
    lse_rows = lse_ref.reshape(b * h, s)
    delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
    args = (q, k, v, bias, do, lse_rows, delta, causal, scale)
    dq = flash.flash_bwd_dq(*args)
    dk, dv, db = flash.flash_bwd_dkv(*args)
    dq_ref = flash.flash_bwd_dq(*args, force="reference")
    dk_ref, dv_ref, db_ref = flash.flash_bwd_dkv(*args, force="reference")
    torch.cuda.synchronize()
    assert [f.launches for f in (flash.flash_fwd, flash.flash_bwd_dq,
                                 flash.flash_bwd_dkv)] == [c + 1
                                                           for c in counts]
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o, o_ref, **tol)
    torch.testing.assert_close(lse, lse_ref, **FLASH_TOL[torch.float32])
    torch.testing.assert_close(dq, dq_ref, **tol)
    torch.testing.assert_close(dk, dk_ref, **tol)
    torch.testing.assert_close(dv, dv_ref, **tol)
    torch.testing.assert_close(db, db_ref, atol=1e-4, rtol=1e-4)


def test_flash_attention_autograd_matches_plain(dev):
    """The differentiable op: K1 forward, K2/K3 backward (under
    autograd, as the registry's grad op runs it), against the plain
    versions; the [B, 1, 1, S] bias gets its grad summed over heads."""
    q, k, v, do, _ = _flash_case(dev, 2, 4, 96, 64, torch.float32, True)
    bias = torch.zeros(2, 1, 1, 96, device=dev)
    bias[1, ..., 90:] = -1e4
    grads = {}
    for force in (None, "reference"):
        args = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = flash.flash_attention(*args, sm_scale=0.125, force=force)
        grads[force] = (out.detach(),) + torch.autograd.grad(out, args, do)
    torch.cuda.synchronize()
    for got, want in zip(grads[None], grads["reference"]):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


def test_flash_kernels_raise_not_fall_back(dev):
    q, k, v, do, bias = _flash_case(dev, 1, 2, 16, 96, torch.float32, False)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_fwd(q, k, v, bias[:, :16], False, 0.1)
    q, k, v, do, bias = _flash_case(dev, 1, 2, 16, 8, torch.float16, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash.flash_fwd(q, k, v, bias, False, 0.1)


def test_bert_train_steps_on_cuda_match_cpu(dev):
    """Three Adam steps of a 2-layer BERT (fp32, dropout 0) on the card
    and on the CPU from the same parameters; every flash and K4 launch
    happens on the card."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(num_layers=2, use_flash_attention=True,
                               attn_dropout=0.0, hidden_dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    startup.random_seed = 5
    feed = bert.make_fake_batch(cfg, 4, 48, seed=1)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    gpu = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=gpu)
    convert.load_params(gpu, {p.name: cpu.get(p.name).numpy()
                              for p in main.all_parameters()},
                        fluid.CUDAPlace(0), program=main)
    losses = {}
    before = flash.flash_fwd.launches, fba.fused_bias_gelu.launches
    for key, scope, place in (("gpu", gpu, fluid.CUDAPlace(0)),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        losses[key] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
    assert (flash.flash_fwd.launches - before[0],
            fba.fused_bias_gelu.launches - before[1]) == (
        3 * 2 * cfg.num_layers, 3 * (cfg.num_layers + 1))
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# K7: paged attention over the dual-int8 pool
# ---------------------------------------------------------------------------


def _quant_case(dev, b, n, t, d, page_size, max_pages, q_start, seed=0):
    """A K5 case whose pool is quantized to the dual-int8 format; the
    trash page's scales poisoned."""
    q, kp, vp, table, qs = _paged_case(dev, b, n, t, d, page_size,
                                       max_pages, q_start, seed)
    pool = []
    for p in (kp, vp):
        hi, lo, sc = int8.quantize_lastdim(p)
        sc[0] = 1e4
        pool += [hi, lo, sc]
    return [q, *pool, table, qs]


@pytest.mark.parametrize("name,b,n,t,d,page_size,max_pages,q_start", [
    # the int8 lane's decode step and prefill chunk (one-chunk prefetch)
    ("decode", 4, 3, 1, 64, 16, 8, [0, 15, 16, 127]),
    ("prefill", 1, 3, 32, 64, 16, 8, [64]),
    ("ragged_tile", 2, 2, 7, 64, 16, 4, [0, 40]),
    # page of 32 x 64 codes: more than one staging chunk
    ("big_page", 2, 2, 4, 64, 32, 4, [5, 100]),
    # d = 24: no 16-byte staging (scalar path); d = 128: four columns
    ("d24", 2, 2, 3, 24, 4, 6, [0, 20]),
    ("d128", 2, 2, 1, 128, 8, 4, [3, 31]),
])
def test_paged_quant_kernel_matches_plain(dev, name, b, n, t, d, page_size,
                                          max_pages, q_start):
    args = _quant_case(dev, b, n, t, d, page_size, max_pages, q_start)
    before = paged.paged_attention_quant.launches
    got = paged.paged_attention_quant(*args)
    want = paged.paged_attention_quant(*args, force="reference")
    assert paged.paged_attention_quant.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **K5_TOL)


def test_paged_quant_kernel_unaligned_pool_uses_scalar_staging(dev):
    """hi/lo views one byte off 16-byte alignment take the scalar path
    and still agree."""
    args = _quant_case(dev, 2, 2, 1, 32, 4, 4, [3, 9])
    off = list(args)
    for i in (1, 2, 4, 5):
        flat = torch.empty(args[i].numel() + 1, dtype=torch.int8, device=dev)
        off[i] = flat[1:].view(args[i].shape).copy_(args[i])
        assert off[i].data_ptr() % 16 != 0
    torch.testing.assert_close(paged.paged_attention_quant(*off),
                               paged.paged_attention_quant(
                                   *args, force="reference"), **K5_TOL)


def test_paged_quant_kernel_raises_not_falls_back(dev):
    args = _quant_case(dev, 2, 2, 4, 16, 4, 4, [3, 9])
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        paged.paged_attention_quant(*bad)
    bad = list(args)
    bad[7] = args[7].long()
    with pytest.raises(ValueError, match="int32"):
        paged.paged_attention_quant(*bad)
    bad = list(args)
    bad[1] = args[1].float()
    with pytest.raises(ValueError, match="int8"):
        paged.paged_attention_quant(*bad)


# ---------------------------------------------------------------------------
# K6: ragged attention
# ---------------------------------------------------------------------------


def _ragged_case(dev, shape, lengths, strided, seed=0):
    rng = np.random.RandomState(seed)

    def t():
        if len(shape) == 3:
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    ).to(dev)
        b, h, s, d = shape
        a = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)).to(
            dev).transpose(1, 2)
        return a if strided else a.contiguous()

    return t(), t(), t(), torch.tensor(lengths, dtype=torch.int32,
                                       device=dev)


@pytest.mark.parametrize("shape,lengths,causal,strided", [
    # the serving path: transposed views, the wave's lengths, a 0 row
    ((8, 8, 128, 32), [20, 20, 50, 90, 126, 128, 0, 3], True, True),
    ((8, 8, 32, 32), [20, 20, 0, 0, 0, 0, 0, 0], True, True),
    # S = 200 (a ragged last tile), D = 64, causal on and off
    ((2, 3, 200, 64), [200, 77], True, False),
    ((2, 3, 200, 64), [150, 0], False, True),
    # [BH, S, D] with per-row lengths; an odd D; a length past S
    ((5, 70, 20), [70, 64, 65, 1, 300], False, False),
])
def test_ragged_kernel_matches_plain(dev, shape, lengths, causal, strided):
    q, k, v, lens = _ragged_case(dev, shape, lengths, strided)
    before = ragged.ragged_attention.launches
    got = ragged.ragged_attention(q, k, v, lens, causal)
    want = ragged.ragged_attention(q, k, v, lens, causal, force="reference")
    assert ragged.ragged_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.stride() == q.stride()  # the output keeps q's layout
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


def test_ragged_kernel_raises_not_falls_back(dev):
    q, k, v, lens = _ragged_case(dev, (1, 2, 16, 96), [16], False)
    with pytest.raises(ValueError, match="head dim"):
        ragged.ragged_attention(q, k, v, lens)
    q, k, v, lens = _ragged_case(dev, (1, 2, 16, 32), [16], False)
    with pytest.raises(TypeError, match="float32"):
        ragged.ragged_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                lens)
    with pytest.raises(ValueError, match="int32"):
        ragged.ragged_attention(q, k, v, lens.long())


# ---------------------------------------------------------------------------
# the two serving lanes, card against CPU
# ---------------------------------------------------------------------------


def test_int8_decode_lane_on_cuda_matches_cpu(dev):
    """The tiny GPT over the int8 pool: the card's greedy ids equal the
    CPU's; each program run launched K4 and K7 once a layer, K5 never."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.kernels import kernel_wrappers
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = gpt.GPTConfig.tiny(num_layers=2, initializer_range=0.2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 4, 33, 4, 8)
    startup.random_seed = 11
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    gpu = fluid.Scope()
    convert.load_params(gpu, {p.name: cpu.get(p.name).numpy()
                              for p in main.all_parameters()},
                        fluid.CUDAPlace(0), program=main)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 20))]
    per_run = {"fused_bias_act": 1, "paged_attention_quant": 1,
               "paged_attention": 0}
    wrappers = kernel_wrappers()
    outs = {}
    for key, scope, place in (("cpu", cpu, fluid.CPUPlace()),
                              ("gpu", gpu, fluid.CUDAPlace(0))):
        eng = DecodeEngine(cfg, scope=scope, place=place, pool_slots=4,
                           page_size=4, prefill_chunk=8, max_len=32,
                           pool_dtype="int8")
        before = {k: wrappers[k].launches for k in per_run}
        try:
            outs[key] = eng.generate(prompts, max_new_tokens=8, timeout=120)
        finally:
            eng.close()
        runs = eng.stats()["prefill_chunks"] + eng.stats()["steps"]
        for k, n in per_run.items():
            expect = n * cfg.num_layers * runs if key == "gpu" else 0
            assert wrappers[k].launches - before[k] == expect, k
    assert outs["gpu"] == outs["cpu"]


def test_ragged_engine_on_cuda_matches_cpu(dev, tmp_path):
    """A one-layer ragged scorer saved by the port, served by a ragged
    Engine on the card and on the CPU: equal scores, and K6 launched once
    a batch (warmup included)."""
    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.fluid import layers as L

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [-1, -1], False, dtype="int64")
        lens = fluid.data("lens", [-1], False, dtype="int32")
        x = L.embedding(ids, size=[64, 32])
        q, k, v = [L.transpose(L.reshape(L.fc(x, size=32, num_flatten_dims=2),
                                         shape=[0, 0, 2, 16]),
                               perm=[0, 2, 1, 3]) for _ in range(3)]
        ctx = L.reshape(L.transpose(L.ragged_attention(q, k, v, lens,
                                                       causal=True),
                                    perm=[0, 2, 1, 3]), shape=[0, 0, 32])
        x = L.elementwise_add(x, L.fc(ctx, size=32, num_flatten_dims=2))
        score = L.reshape(L.reduce_mean(x, dim=[1, 2]), shape=[-1, 1])
    startup.random_seed = 3
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(tmp_path), ["ids", "lens"], [score],
                                  exe, main_program=main, scope=scope)
    rng = np.random.RandomState(0)
    feeds = [{"ids": rng.randint(1, 64, (1, n)).astype(np.int64),
              "lens": np.full((1,), n, np.int32)} for n in (3, 5, 16, 9)]
    scores = {}
    for key, place in (("cpu", fluid.CPUPlace()), ("gpu", fluid.CUDAPlace(0))):
        before = ragged.ragged_attention.launches
        eng = serving.Engine(batch_buckets=[4], seq_buckets=[8, 16],
                             max_wait_ms=20, auto_start=False, place=place)
        try:
            eng.load_model("m", str(tmp_path), ragged=True)
            eng.warmup()
            eng.start()
            futs = [eng.submit("m", f) for f in feeds]
            scores[key] = np.concatenate(
                [f.result(timeout=120)[score.name] for f in futs])
            st = eng.stats()["models"]["m"]
        finally:
            eng.close()
        launched = ragged.ragged_attention.launches - before
        assert launched == (st["batches"] + st["warmup_batches"]
                            if key == "gpu" else 0)
    np.testing.assert_allclose(scores["gpu"], scores["cpu"], atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# K8: the fused dequant -> update -> requant step, and the quantized
# collectives of the data-parallel lane on replicas on the card
# ---------------------------------------------------------------------------

K8_KINDS = [("adam", False), ("adamw", False), ("momentum", False),
            ("momentum", True), ("sgd", False)]


def _k8_state(dev, numel, bs, offset=2, seed=0):
    from paddle_tpu_torch.kernels import quantized_collectives as qc

    rng = np.random.RandomState(seed)
    nb = -(-numel // bs)
    bucket = rng.randn((offset + nb + 1) * bs).astype(np.float32)
    bucket[offset * bs + numel:(offset + nb) * bs] = 0  # member padding
    hi, lo, sc = qc.quantize_block_scaled(torch.from_numpy(bucket).to(dev),
                                          bs)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    state = dict(p=f(rng.randn(numel) * 0.1), m1=f(rng.randn(numel) * 0.01),
                 m2=f(np.abs(rng.randn(numel)) * 0.01), lr=f([1e-3]),
                 b1p=f([0.9 ** 2]), b2p=f([0.999 ** 2]))
    return state, (hi, lo, sc, offset, numel)


def _k8_run(kind, nesterov, s, grad, bs, requant, force=None):
    from paddle_tpu_torch.kernels import fused_update as fu

    kw = dict(block_size=bs, requant_pad=bs if requant else None,
              force=force)
    if kind in ("adam", "adamw"):
        fn = fu.fused_adam_update if kind == "adam" else fu.fused_adamw_update
        out = fn(s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"], s["b2p"],
                 **kw)
    elif kind == "momentum":
        out = fu.fused_momentum_update(s["p"], grad, s["m1"], s["lr"],
                                       use_nesterov=nesterov, **kw)
    else:
        out = fu.fused_sgd_update(s["p"], grad, s["lr"], **kw)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("kind,nesterov", K8_KINDS)
@pytest.mark.parametrize("numel,bs", [(1000, 256), (4096, 256), (77, 16),
                                      (3000, 1024)])
def test_fused_update_kernel_matches_plain(dev, kind, nesterov, requant,
                                           numel, bs):
    """K8 against its plain version: the same terms in the same order
    with round-to-nearest intrinsics, so equal up to 1e-6 of each
    tensor's largest element and equal codes."""
    from paddle_tpu_torch.kernels import fused_update as fu

    state, grad = _k8_state(dev, numel, bs)
    ref = {k: v.clone() for k, v in state.items()}
    before = fu.fused_update_kernel.launches
    got = _k8_run(kind, nesterov, state, grad, bs, requant)
    want = _k8_run(kind, nesterov, ref, grad, bs, requant, force="reference")
    torch.cuda.synchronize()
    assert fu.fused_update_kernel.launches == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        if requant and i == 0:
            continue  # p: the payload's image on the kernel's path
        if g.dtype == torch.int8:
            assert torch.equal(g, w), i
        else:
            torch.testing.assert_close(g, w, rtol=1e-6,
                                       atol=1e-6 * w.abs().max().item())


def test_fused_update_kernel_raises_not_falls_back(dev):
    from paddle_tpu_torch.kernels import fused_update as fu

    state, grad = _k8_state(dev, 1000, 256)
    with pytest.raises(ValueError, match="block_size"):
        fu.fused_sgd_update(state["p"], grad, state["lr"], block_size=2048)
    with pytest.raises(ValueError, match="contiguous"):
        fu.fused_sgd_update(state["p"][::2], (grad[0], grad[1], grad[2], 2,
                                              500), state["lr"])


@pytest.mark.parametrize("n,algo,size", [(2, "oneshot", 5000),
                                         (4, "oneshot", 4096),
                                         (4, "ring", 5003),
                                         (4, "ring_bidir", 9000),
                                         (4, "ring_bidir", 8192)])
def test_quantized_all_reduce_on_card_matches_cpu_replicas(dev, n, algo,
                                                           size):
    """Each quantized all-reduce form over n replicas on the card
    against the same inputs on n CPU replicas: the dequantized results
    within 1e-6 of each block's max (cuBLAS-free elementwise math, but
    the card and the CPU may round a division or a sum otherwise)."""
    from paddle_tpu_torch.kernels import ring_collectives as rc

    xs = np.random.RandomState(size).randn(n, size).astype(np.float32)
    gpu = rc.adaptive_quantized_all_reduce(
        [torch.from_numpy(x).to(dev) for x in xs], block_size=256, algo=algo)
    cpu = rc.adaptive_quantized_all_reduce(
        [torch.from_numpy(x) for x in xs], block_size=256, algo=algo)
    bmax = np.abs(xs).sum(0)
    pad = (-size) % 256
    bmax = np.pad(bmax, (0, pad)).reshape(-1, 256).max(1).repeat(256)[:size]
    for g, c in zip(gpu, cpu):
        assert g.device.type == "cuda"
        assert (np.abs(g.cpu().numpy() - c.numpy()) <= 1e-6 * bmax).all()


def test_dp2_bert_tiny_on_card_matches_cpu_replicas(dev):
    """Two steps of BERT-tiny at dp 2 through CompiledProgram on two
    replicas of the card and on two CPUPlace replicas, from the same
    parameters: every fused update on the card launches K8."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    shards = [bert.make_fake_batch(cfg, 2, 32, seed=r) for r in range(2)]
    feed = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    losses, init = {}, None
    for key, place in (("gpu", fluid.CUDAPlace(0)), ("cpu", fluid.CPUPlace())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, loss, _, _ = bert.build_bert_pretrain(cfg)
            fluid.optimizer.Adam(1e-3).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        if init is None:
            init = {p.name: scope.get(p.name).cpu().numpy().copy()
                    for p in main.all_parameters()}
        else:
            convert.load_params(scope, init, place, program=main)
        bs = fluid.BuildStrategy()
        bs.quant_allreduce = True
        cp = fluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
            loss_name=loss.name, places=[place] * 2)
        before = fu.fused_update_kernel.launches
        losses[key] = [exe.run(cp, feed=feed, fetch_list=[loss],
                               scope=scope)[0] for _ in range(2)]
        launched = fu.fused_update_kernel.launches - before
        n_fused = sum(op.type == "fused_adam_quant_grad"
                      for op in cp._dp_runner.program.global_block().ops)
        assert launched == (2 * 2 * n_fused if key == "gpu" else 0)
    np.testing.assert_allclose(np.asarray(losses["gpu"]),
                               np.asarray(losses["cpu"]), rtol=1e-4)
