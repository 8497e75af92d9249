"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test is marked ``cuda`` and skips without a GPU.  The
file imports no jax, so it runs on a GPU machine without it:

    PADDLE_TPU_TEST_REAL=1 python -m pytest tests/test_torch_port_cuda.py -q

(``PADDLE_TPU_TEST_REAL=1`` keeps tests/cpu_mesh.py from importing jax.)

Tolerances: K5 and K7 atol 2e-5 / rtol 1e-4 (online softmax over pages
merged across warps, and K5's across splits, vs one softmax: same fp32
terms, other order); K6
2e-5 in fp32 (sums over 32-key tiles vs one matmul) and 2e-2 in bf16
(both round one fp32 result to bf16); K4 1e-6 in
fp32 (the same elementwise formula; erfcf/tanhf may differ by an ulp)
and one bf16 rounding step (8e-3 relative) in bf16; K1-K3 2e-5 in fp32
(fp32 sums over 64-key tiles vs one matmul) and 2e-2 in bf16 (both
round an fp32 result to bf16, so they may differ by an ulp of it; the
bf16 K1 and K3 also round P and dS to bf16 before their second
products, 2^-9 relative a term); the decode lane's greedy ids exactly,
over the fp32 and the int8 pool (the tiny model's top-two gaps are far
wider than the fp32 differences between cuBLAS and the CPU); the ragged
Engine's scores within 1e-5 of a CPU engine's; the BERT step's losses
on the card within 1e-4 of the CPU's in fp32 and within 2e-3 under the
bf16 policy; K8 (its per-parameter and its group form) within 1e-6 of
each tensor's largest element with equal requant codes, the quantized
all-reduce forms within 1e-6 of each block's max of CPU replicas, and a
dp 2 BERT-tiny run's losses within 1e-4 of CPU replicas'.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_bias_act as fba
from paddle_tpu_torch.kernels.primitives import flash, int8, paged, ragged

pytestmark = pytest.mark.cuda

K5_TOL = dict(atol=2e-5, rtol=1e-4)
K4_TOL = dict(atol=1e-6, rtol=1e-6)
K4_BF16_TOL = dict(atol=8e-3, rtol=8e-3)
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _on_card():
    """{wrapper name: launches of its kernel the card ran}: the kernels'
    own counters, which count graph replays too (the wrappers' Python
    counters see an eager launch or a capture, never a replay)."""
    from paddle_tpu_torch import kernels

    return kernels.device_launch_counts()


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
    # the split form (64 pages of 16: eight splits of eight pages): a row
    # through every split beside rows whose later splits are empty
    ("split_full", 4, 3, 1, 64, 16, 64, [1023, 5, 300, 640]),
    # the query on a split's first and last key
    ("split_edges", 4, 2, 1, 64, 16, 64, [127, 128, 255, 256]),
    # a prefill chunk whose 4-query tile 3 straddles keys 127 | 128
    ("split_prefill", 1, 3, 32, 64, 16, 64, [114]),
    # q_start 0 beside a full row
    ("split_zero_and_full", 2, 2, 1, 64, 16, 64, [0, 1023]),
    # a prefill chunk from q_start 0: only the first split live, written
    # directly by its CTA
    ("split_prefill_first", 1, 3, 32, 64, 16, 64, [0]),
    # pages of 4 keys (32 a split) and the scalar staging path
    ("split_d6", 2, 2, 3, 6, 4, 40, [0, 150]),
])
def test_paged_kernel_matches_plain(dev, name, b, n, t, d, page_size,
                                    max_pages, q_start):
    warps = _build.load("paged_attention", paged._SIGNATURES).pt_paged_warps()
    plan = paged.split_plan(b, n, t, d, max_pages, page_size, warps)
    assert (plan.splits > 1) == name.startswith("split")
    args = _paged_case(dev, b, n, t, d, page_size, max_pages, q_start)
    before = paged.paged_attention.launches
    got = paged.paged_attention(*args)
    assert paged.paged_attention.launches == before + 1
    # a second launch on the stream reuses the arrival counters, which
    # the first must have left at 0
    again = paged.paged_attention(*args)
    assert paged.paged_attention.launches == before + 2
    want = paged.paged_attention(*args, force="reference")
    assert paged.paged_attention.launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **K5_TOL)
    torch.testing.assert_close(again, want, **K5_TOL)
    assert not any(c.any() for c in paged._arrivals.values())


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
    ids, and every program run launched each kernel once a layer on the
    card (replays included); the CPU run launched none."""
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
        card = _on_card()
        try:
            outs[key] = eng.generate(prompts, max_new_tokens=8, timeout=120)
        finally:
            eng.close()
        runs = eng.stats()["prefill_chunks"] + eng.stats()["steps"]
        after = _on_card()
        for k, w in counters.items():
            if key == "gpu":
                assert after[k] - card[k] == cfg.num_layers * runs, k
            else:
                assert (w.launches - before[k], after[k] - card[k]) == (
                    0, 0), k
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


@pytest.mark.parametrize("dtype,b,h,s,d,causal,strided", [
    (torch.bfloat16, 2, 3, 128, 64, False, True),   # the BERT path's case
    (torch.bfloat16, 32, 12, 128, 64, False, True),  # a dp replica's shard
    (torch.bfloat16, 2, 3, 200, 64, False, False),  # a ragged last tile
    (torch.bfloat16, 2, 3, 200, 64, True, True),
    (torch.bfloat16, 2, 3, 256, 64, True, True),    # 4 key tiles (K2)
    (torch.bfloat16, 8, 12, 1024, 64, True, True),  # GPT-2 small's causal
    (torch.bfloat16, 2, 3, 96, 32, False, True),    # D < 64, zero-padded
    (torch.bfloat16, 2, 3, 77, 16, True, False),
    (torch.bfloat16, 2, 3, 77, 12, True, True),     # 24-byte rows: scalar
    (torch.bfloat16, 2, 3, 50, 12, False, False),   # staging and stores
    (torch.bfloat16, 2, 3, 1, 64, False, True),     # one query, one key
    (torch.float32, 2, 3, 200, 64, False, True),
    (torch.float32, 2, 3, 200, 64, True, False),
    (torch.float32, 2, 3, 64, 32, True, True),
])
def test_flash_kernels_match_plain(dev, dtype, b, h, s, d, causal, strided):
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_fully_masked_rows_match_plain(dev, dtype):
    """Every key of batch 1's heads carries the -1e30 bias: as in the JAX
    kernel, such a row's logits all equal -1e30, so the kernels and the
    plain versions give it uniform weights (O = the mean of V), and
    nothing turns to NaN."""
    b, h, s, d = 2, 3, 130, 64
    q, k, v, do, bias = _flash_case(dev, b, h, s, d, dtype, True)
    bias[h:] = -1e30
    scale = d ** -0.5
    o, lse = flash.flash_fwd(q, k, v, bias, False, scale)
    o_ref, lse_ref = flash.flash_fwd(q, k, v, bias, False, scale,
                                     force="reference")
    delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
    args = (q, k, v, bias, do, lse_ref.reshape(b * h, s), delta, False,
            scale)
    dq = flash.flash_bwd_dq(*args)
    dq_ref = flash.flash_bwd_dq(*args, force="reference")
    dk, dv, db = flash.flash_bwd_dkv(*args)
    dk_ref, dv_ref, db_ref = flash.flash_bwd_dkv(*args, force="reference")
    torch.cuda.synchronize()
    for t in (o, lse, dq, dk, dv, db):
        assert torch.isfinite(t).all()
    tol = FLASH_TOL[dtype]
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(h, s, d)
    torch.testing.assert_close(o[1].float(), mean_v, **tol)
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
    before = _on_card()
    for key, scope, place in (("gpu", gpu, fluid.CUDAPlace(0)),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        losses[key] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
    after = _on_card()
    assert (after["flash_fwd"] - before["flash_fwd"],
            after["fused_bias_act"] - before["fused_bias_act"]) == (
        3 * 2 * cfg.num_layers, 3 * (cfg.num_layers + 1))
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)


def test_bert_bf16_train_steps_on_cuda_match_cpu(dev):
    """Three Adam steps of a 2-layer BERT-tiny under the bf16 policy
    (dropout 0) on the card, through the bf16 tensor-core K1 and K3, and
    on the CPU through the plain versions, from the same parameters.
    Losses within 2e-3 relative, half a bf16 ulp: the card rounds P and
    dS to bf16 before their second products (on the CPU, emulating that
    rounding moves these losses by 5e-5), and cuBLAS and the CPU's bf16
    GEMMs round fp32 sums taken in other orders, which can move an
    activation by one bf16 ulp."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(num_layers=2, use_flash_attention=True,
                               attn_dropout=0.0, hidden_dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    enable_bf16_policy(main)
    startup.random_seed = 5
    feed = bert.make_fake_batch(cfg, 4, 48, seed=1)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    gpu = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=gpu)
    convert.load_params(gpu, {p.name: cpu.get(p.name).numpy()
                              for p in main.all_parameters()},
                        fluid.CUDAPlace(0), program=main)
    kernels = ("flash_fwd", "flash_bwd_dkv")
    before = _on_card()
    losses = {}
    for key, scope, place in (("gpu", gpu, fluid.CUDAPlace(0)),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        losses[key] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
    after = _on_card()
    assert [after[k] - before[k] for k in kernels] == [
        3 * 2 * cfg.num_layers, 3 * cfg.num_layers]
    assert np.isfinite(losses["gpu"]).all()
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=2e-3)


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


@pytest.mark.parametrize("name,b,t,q_start", [
    # decode rows with 1 live chunk (q_start 0, 32), 2 (200), 5 (600) and
    # all 8 (992, 1023) of 8 pages
    ("decode", 6, 1, [0, 32, 200, 600, 992, 1023]),
    # prefill chunks: only the first chunk live, two tiles across chunks,
    # every chunk live
    ("prefill@0", 1, 32, [0]),
    ("prefill@32", 1, 32, [32]),
    ("prefill@300", 1, 32, [300]),
    ("prefill@992", 1, 32, [992]),
])
def test_paged_quant_split_kernel_matches_plain(dev, name, b, t, q_start):
    """K7's split form (64 pages of 16 keys: eight chunks of eight pages)
    against its plain version, launched twice on each of two streams:
    the arrival counters, one set a stream, are all 0 after each call."""
    n, d, page_size, max_pages = 3, 64, 16, 64
    warps = _build.load("paged_attention", paged._SIGNATURES).pt_paged_warps()
    assert paged.split_plan(b, n, t, d, max_pages, page_size,
                            warps).splits == 8
    args = _quant_case(dev, b, n, t, d, page_size, max_pages, q_start)
    want = paged.paged_attention_quant(*args, force="reference")
    side = torch.cuda.Stream(dev)
    before = paged.paged_attention_quant.launches
    outs = []
    for stream in (torch.cuda.current_stream(dev), side):
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(2):
                outs.append(paged.paged_attention_quant(*args))
                stream.synchronize()
                assert not any(c.any() for c in paged._arrivals.values())
    torch.cuda.synchronize()
    assert paged.paged_attention_quant.launches == before + 4
    assert sum(k[0] == dev for k in paged._arrivals) >= 2
    for got in outs:
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

@pytest.mark.parametrize("rows,h,dtype,offset", [
    # the train step's FFN, a dp shard's and the MLM head's, in bf16
    (16384, 3072, torch.bfloat16, 0),
    (4096, 3072, torch.bfloat16, 0),
    (2048, 768, torch.bfloat16, 0),
    # H not a multiple of the vector width (the one-column form)
    (37, 3070, torch.bfloat16, 0),
    (37, 3070, torch.float32, 0),
    # x at an 8-byte, not 16-byte, offset: the one-column form
    (37, 3072, torch.bfloat16, 4),
    (37, 3072, torch.float32, 2),
    # rows below one group of four, and a ragged last group
    (3, 3072, torch.bfloat16, 0),
    (1, 768, torch.float32, 0),
    (4099, 768, torch.bfloat16, 0),
])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bias_gelu_kernel_shapes_and_views(dev, rows, h, dtype, offset,
                                           approximate, with_mask):
    """Each vector and one-column form of the redesigned K4, with and
    without the mask, exact and tanh: one launch, x's dtype and shape,
    within the gate of its dtype."""
    rng = np.random.RandomState(rows + h + offset)
    n = rows * h
    buf = torch.from_numpy(rng.randn(n + offset).astype(np.float32) * 3).to(
        dev, dtype)
    x = buf[offset:].view(rows, h)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(offset)
    bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(dev, dtype)
    mask = (torch.from_numpy((rng.rand(rows, h) > .1).astype(np.uint8))
            .to(dev) if with_mask else None)
    kw = dict(mask=mask, scale=1 / 0.9 if with_mask else 1.0,
              approximate=approximate)
    before = fba.fused_bias_gelu.launches
    got = fba.fused_bias_gelu(x, bias, **kw)
    assert fba.fused_bias_gelu.launches == before + 1
    want = fba.fused_bias_gelu_reference(x, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    tol = K4_TOL if dtype == torch.float32 else K4_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


# ---------------------------------------------------------------------------
# K6: ragged attention
# ---------------------------------------------------------------------------


def _ragged_case(dev, shape, lengths, strided, seed=0,
                 dtype=torch.float32):
    rng = np.random.RandomState(seed)

    def t():
        if len(shape) == 3:
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    ).to(dev, dtype)
        b, h, s, d = shape
        a = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)).to(
            dev, dtype).transpose(1, 2)
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


@pytest.mark.parametrize("shape,lengths,causal,strided,dtype", [
    # D 96 and 128 (the 128-column form), fp32
    ((2, 3, 150, 96), [150, 0], True, True, torch.float32),
    ((2, 3, 150, 96), [97, 300], False, False, torch.float32),
    ((2, 3, 150, 128), [150, 0], True, False, torch.float32),
    ((2, 3, 150, 128), [97, 300], False, True, torch.float32),
    # bf16 at D 32 and 64, causal and not, lengths 0 and past S
    ((8, 8, 128, 32), [20, 20, 50, 50, 90, 90, 126, 0], True, True,
     torch.bfloat16),
    ((2, 3, 77, 32), [0, 500], False, False, torch.bfloat16),
    ((2, 3, 200, 64), [200, 77], True, True, torch.bfloat16),
    ((2, 3, 200, 64), [150, 0], False, True, torch.bfloat16),
    # bf16 at D 96 and an odd D (element-by-element staging)
    ((2, 2, 40, 96), [40, 13], True, True, torch.bfloat16),
    ((5, 70, 20), [70, 64, 65, 1, 300], True, False, torch.bfloat16),
    # S 1
    ((3, 2, 1, 32), [1, 0, 5], True, True, torch.float32),
    ((3, 2, 1, 64), [1, 0, 5], False, False, torch.bfloat16),
    # S 1024, a row of length 1000: 32 live key tiles
    ((1, 2, 1024, 64), [1000], True, True, torch.float32),
    ((1, 2, 1024, 32), [1000], False, False, torch.float32),
])
def test_ragged_kernel_contract(dev, shape, lengths, causal, strided,
                                dtype):
    """The redesigned K6 takes any D up to 128 and bf16 inputs (fp32
    arithmetic, q's dtype out), within the gate of the dtype."""
    q, k, v, lens = _ragged_case(dev, shape, lengths, strided, dtype=dtype)
    before = ragged.ragged_attention.launches
    got = ragged.ragged_attention(q, k, v, lens, causal)
    want = ragged.ragged_attention(q, k, v, lens, causal, force="reference")
    assert ragged.ragged_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    zero = [i for i, n in enumerate(lengths) if n == 0]
    if zero and len(shape) == 4:
        assert not got[zero].any()  # length 0: zeros


def test_ragged_kernel_raises_not_falls_back(dev):
    q, k, v, lens = _ragged_case(dev, (1, 2, 16, 160), [16], False)
    with pytest.raises(ValueError, match="head dim"):
        ragged.ragged_attention(q, k, v, lens)
    q, k, v, lens = _ragged_case(dev, (1, 2, 16, 32), [16], False)
    out = ragged.ragged_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  lens)  # bf16 is taken since the redesign
    assert out.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="one dtype"):
        ragged.ragged_attention(q, k.bfloat16(), v, lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ragged.ragged_attention(q.half(), k.half(), v.half(), lens)
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
        card = _on_card()
        try:
            outs[key] = eng.generate(prompts, max_new_tokens=8, timeout=120)
        finally:
            eng.close()
        runs = eng.stats()["prefill_chunks"] + eng.stats()["steps"]
        after = _on_card()
        for k, n in per_run.items():
            if key == "gpu":
                assert after[k] - card[k] == n * cfg.num_layers * runs, k
            else:
                assert (wrappers[k].launches - before[k],
                        after[k] - card[k]) == (0, 0), k
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
        card = _on_card()["ragged_attention"]
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
        launched = (ragged.ragged_attention.launches - before,
                    _on_card()["ragged_attention"] - card)
        if key == "gpu":
            assert launched[1] == st["batches"] + st["warmup_batches"]
        else:
            assert launched == (0, 0)
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


@pytest.mark.parametrize("kind,nesterov", K8_KINDS)
@pytest.mark.parametrize("dual", [True, False])
def test_fused_update_group_matches_plain(dev, kind, nesterov, dual):
    """The group kernel over odd segments (one element, ragged numels,
    block offsets that are not multiples of 4 elements at block size 6,
    members of two buckets) against the plain version member by member,
    within the per-parameter form's gate (1e-6 of each tensor's largest
    element); one launch a table-full of members, none of the
    per-parameter form."""
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.kernels import quantized_collectives as qc

    bs, numels = 6, (1, 7, 13, 40, 25, 6, 1000, 3)
    rng = np.random.RandomState(len(numels) + dual)
    members = []
    for bucket_numels in (numels[:5], numels[5:]):
        offsets, off = [], 1
        for n in bucket_numels:
            offsets.append(off)
            off += -(-n // bs)
        flat = np.zeros((off + 1) * bs, np.float32)
        for o, n in zip(offsets, bucket_numels):
            flat[o * bs:o * bs + n] = rng.randn(n)
        hi, lo, sc = qc.quantize_block_scaled(
            torch.from_numpy(flat).to(dev), bs, dual_int8=dual)
        lr = torch.tensor([1e-2], device=dev)
        for o, n in zip(offsets, bucket_numels):
            f = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a, np.float32)).to(dev)
            adam = kind in ("adam", "adamw")
            members.append(fu.GroupMember(
                f(rng.randn(n) * 0.1), (hi, lo if dual else None, sc, o, n),
                lr, f(rng.randn(n) * 0.01) if kind != "sgd" else None,
                f(np.abs(rng.randn(n)) * 0.01) if adam else None,
                f([0.9 ** 2]) if adam else None,
                f([0.999 ** 2]) if adam else None))
    hyper = {"sgd": {}, "momentum": dict(mu=0.9, use_nesterov=nesterov),
             "adam": dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
             "adamw": dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
                           coeff=0.01)}[kind]
    ref = [fu.GroupMember(*(t.clone() if isinstance(t, torch.Tensor)
                            else t for t in m)) for m in members]
    lib = _build.load("fused_update", fu._SIGNATURES)
    cap = lib.pt_fused_update_group_capacity()
    before = (fu.fused_update_group.launches, fu.fused_update_kernel.launches)
    fu.fused_update_group(kind, members, hyper, bs)
    fu.fused_update_group(kind, ref, hyper, bs, force="reference")
    torch.cuda.synchronize()
    assert (fu.fused_update_group.launches,
            fu.fused_update_kernel.launches) == (
        before[0] + -(-len(members) // cap), before[1])
    for m, r in zip(members, ref):
        for g, w in zip(m, r):
            if isinstance(g, torch.Tensor) and g.dtype == torch.float32:
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
    parameters: the fused updates on the card launch K8's group form
    once a table-full of the plan's group of both replicas' members,
    and never its per-parameter form (counted by the kernels on the
    card)."""
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
        before = (fu.fused_update_group.launches,
                  fu.fused_update_kernel.launches)
        card = _on_card()
        losses[key] = [exe.run(cp, feed=feed, fetch_list=[loss],
                               scope=scope)[0] for _ in range(2)]
        after = _on_card()
        launched = ((after["fused_update"] - card["fused_update"],
                     after["fused_update_kernel"]
                     - card["fused_update_kernel"]) if key == "gpu" else
                    (fu.fused_update_group.launches - before[0],
                     fu.fused_update_kernel.launches - before[1]))
        plan = next(iter(cp._dp_runner._plans.values()))
        cap = _build.load("fused_update",
                          fu._SIGNATURES).pt_fused_update_group_capacity()
        group = sum(-(-n * 2 // cap) for _, n in plan.group_sizes)
        assert plan.group_sizes
        assert launched == ((2 * group, 0) if key == "gpu" else (0, 0))
    np.testing.assert_allclose(np.asarray(losses["gpu"]),
                               np.asarray(losses["cpu"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# the captured executor: every fixed-shape program as a CUDA graph
# ---------------------------------------------------------------------------


def _bert_tiny_train(bf16=False, hidden_dropout=0.1):
    """BERT-tiny pretraining with hidden dropout, Adam, started on the
    card by its own executor (the run executors then start at step 0)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=hidden_dropout)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    main.random_seed = startup.random_seed = 5
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    return cfg, main, loss, scope


def _clone_scope(scope):
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        out.set(n, scope.get(n).clone())
    return out


def _executor(capture=True):
    """An executor on the card that captures, or runs the eager loop
    (FLAGS_cuda_graph_capture as it is made)."""
    from paddle_tpu_torch import fluid

    old = fluid.get_flags("FLAGS_cuda_graph_capture")
    fluid.set_flags({"FLAGS_cuda_graph_capture": capture})
    try:
        return fluid.Executor(fluid.CUDAPlace(0))
    finally:
        fluid.set_flags(old)


def _delta(before, after):
    return {n: after[n] - before[n] for n in after if after[n] - before[n]}


def _bert_step_launches(cfg):
    return {"flash_fwd": 2 * cfg.num_layers,
            "flash_bwd_dq": cfg.num_layers,
            "flash_bwd_dkv": cfg.num_layers,
            "fused_bias_act": cfg.num_layers + 1}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_captured_and_eager_bert_steps_are_bit_equal(dev, bf16):
    """Three BERT-tiny steps with hidden dropout 0.1, captured (one
    warm-up run, two replays) and eager, from the same state: the same
    losses and every persistable bit for bit, the same kernels run on
    the card each step (the kernels' device counters), and the captured
    executor holds one graph.  The wrappers' counters see the eager
    runs, and of the captured executor's its warm-up and capture only."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import bert

    cfg, main, loss, scope = _bert_tiny_train(bf16)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = {"captured": _executor(True), "eager": _executor(False)}
    feed = bert.make_fake_batch(cfg, 4, 32, seed=1)
    losses = {k: [] for k in exes}
    launches = {k: [] for k in exes}
    on_card = {k: [] for k in exes}
    for _ in range(3):
        for k in exes:  # in turns
            before = kernels.launch_counts()
            dev_before = kernels.device_launch_counts()
            (lv,) = exes[k].run(main, feed=feed, fetch_list=[loss],
                                scope=scopes[k])
            on_card[k].append(_delta(dev_before,
                                     kernels.device_launch_counts()))
            launches[k].append(_delta(before, kernels.launch_counts()))
            losses[k].append(lv.item())
    assert losses["captured"] == losses["eager"]
    step = _bert_step_launches(cfg)
    assert on_card["captured"] == on_card["eager"] == [step] * 3
    assert launches["eager"] == [step] * 3
    assert launches["captured"] == [{n: 2 * c for n, c in step.items()},
                                    {}, {}]
    for n in scopes["eager"].keys():
        assert torch.equal(scopes["captured"].get(n),
                           scopes["eager"].get(n)), n
    (sig,) = exes["captured"].compiled_for(main)
    assert sig.graph is not None
    assert all(h.graph is None for h in exes["eager"].compiled_for(main))


def _dropout_net(seed=0):
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="tanh")
        h = fluid.layers.dropout(h, dropout_prob=0.5, seed=seed or None,
                                 dropout_implementation="upscale_in_train")
        loss = fluid.layers.mean(fluid.layers.fc(h, size=8))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    (mask,) = [op.outputs["Mask"][0] for op in main.global_block().ops
               if op.type == "dropout"]
    return main, startup, loss, mask


@pytest.mark.parametrize("seed", [0, 7], ids=["run_stream", "op_stream"])
def test_replayed_masks_change_every_step_and_match_eager(dev, seed):
    """The dropout mask of each replay differs from the last, and equals
    the eager executor's at the same step (the run's stream, and an
    op's own for a seed attr); a second captured executor from the same
    start draws the same masks again."""
    from paddle_tpu_torch import fluid

    main, startup, loss, mask = _dropout_net(seed)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    feed = {"x": np.ones((8, 64), np.float32)}
    masks = {}
    for k, capture in (("captured", True), ("again", True),
                       ("eager", False)):
        exe = _executor(capture)
        s = _clone_scope(scope)
        masks[k] = [exe.run(main, feed=feed, fetch_list=[mask],
                            scope=s)[0] for _ in range(4)]
    for i in range(1, 4):
        assert not np.array_equal(masks["captured"][i],
                                  masks["captured"][i - 1]), i
    for k in ("again", "eager"):
        for a, b in zip(masks["captured"], masks[k]):
            np.testing.assert_array_equal(a, b)


def test_replaced_scope_tensor_is_read_by_the_next_replay(dev):
    """A parameter the user replaces between replays is copied into the
    graph's storage, which the scope takes back: the next replay's loss
    equals an eager run's from the same replacement."""
    from paddle_tpu_torch import fluid

    main, startup, loss, _ = _dropout_net()
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    feed = {"x": np.ones((8, 64), np.float32)}
    name = main.all_parameters()[0].name
    out = {}
    for k, capture in (("captured", True), ("eager", False)):
        exe = _executor(capture)
        s = _clone_scope(scope)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=s)
        held = s.get(name)
        s.set(name, torch.full_like(held, 0.01))
        out[k] = [exe.run(main, feed=feed, fetch_list=[loss],
                          scope=s)[0].item() for _ in range(2)]
        if capture:
            (sig,) = exe.compiled_for(main)
            assert s.get(name) is held is sig.graph.inputs[0][name]
    assert out["captured"] == out["eager"]


def test_new_feed_shape_captures_a_new_graph(dev):
    """A second batch size is a second signature: its own graph, a
    second cache miss, and each replays at its own shape."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import executor as ex

    main, startup, loss, _ = _dropout_net()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    misses = ex._m_cache().labels(path="single", result="miss")
    hits = ex._m_cache().labels(path="single", result="hit")
    m0, h0 = misses.value, hits.value
    for batch in (8, 4, 8, 4):
        (lv,) = exe.run(main, feed={"x": np.ones((batch, 64), np.float32)},
                        fetch_list=[loss], scope=scope)
        assert np.isfinite(lv).all()
    assert (misses.value - m0, hits.value - h0) == (2, 2)
    sigs = exe.compiled_for(main)
    assert len(sigs) == 2 and all(s.graph is not None for s in sigs)
    assert sorted(s.graph.feeds[0]["x"].shape[0] for s in sigs) == [4, 8]


def test_ema_apply_around_captured_eval_restores_trained_params(dev):
    """An eval program captured on the raw weights, replayed inside
    ``ExponentialMovingAverage.apply()``, reads the averages (its loss
    equals an eager run's on them), and leaving the context gives the
    scope back the trained parameters, not the averages."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="tanh")
        loss = fluid.layers.mean(fluid.layers.fc(h, size=8))
        test = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(0.5)
        ema.update()
    feed = {"x": np.random.RandomState(0).randn(8, 64).astype(np.float32)}
    scope = fluid.Scope()
    exe = _executor(True)
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    names = [p.name for p in main.all_parameters()]
    trained = {n: scope.get(n).clone() for n in names}
    (raw,) = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    with fluid.scope_guard(scope):
        with ema.apply(exe):
            (avg,) = exe.run(test, feed=feed, fetch_list=[loss],
                             scope=scope)
            (eager,) = _executor(False).run(
                test, feed=feed, fetch_list=[loss], scope=_clone_scope(scope))
    assert not np.array_equal(avg, raw)
    np.testing.assert_array_equal(avg, eager)
    for n in names:
        assert torch.equal(scope.get(n), trained[n]), n
    (again,) = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(again, raw)


def test_run_steps_on_card_equals_run_calls(dev):
    """run_steps(5) on the card (the signature's graph replayed) equals
    five captured run() calls: the last loss and every persistable."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg, main, loss, scope = _bert_tiny_train()
    feed = bert.make_fake_batch(cfg, 4, 32, seed=2)
    a, b = scope, _clone_scope(scope)
    exe_a, exe_b = fluid.Executor(fluid.CUDAPlace(0)), \
        fluid.Executor(fluid.CUDAPlace(0))
    for _ in range(5):
        (la,) = exe_a.run(main, feed=feed, fetch_list=[loss], scope=a)
    (lb,) = exe_b.run_steps(main, feed=feed, n_steps=5, fetch_list=[loss],
                            scope=b)
    assert la.item() == lb.item() and exe_a._step == exe_b._step == 5
    for n in a.keys():
        assert torch.equal(a.get(n), b.get(n)), n


def test_dp_captured_step_is_bit_equal_to_eager(dev):
    """BERT-tiny over two replicas on the card with the quantized
    all-reduce and K8's group form: the captured step (warm-up, then
    replays) and the eager one agree bit for bit, and the replicas stay
    identical and the scope's."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg, main, loss, scope = _bert_tiny_train()
    shards = [bert.make_fake_batch(cfg, 2, 32, seed=r) for r in range(2)]
    feed = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    out = {}
    for k, capture in (("captured", True), ("eager", False)):
        s = _clone_scope(scope)
        bs = fluid.BuildStrategy()
        bs.quant_allreduce = True
        # a program a mode: the transpile rewrites its program in place
        _, prog, prog_loss, _ = _bert_tiny_train()
        cp = fluid.CompiledProgram(prog, build_strategy=bs) \
            .with_data_parallel(loss_name=prog_loss.name,
                                places=[fluid.CUDAPlace(0)] * 2)
        exe = _executor(capture)
        out[k] = ([exe.run(cp, feed=feed, fetch_list=[prog_loss],
                           scope=s)[0].tolist() for _ in range(3)], s, cp)
    assert out["captured"][0] == out["eager"][0]
    runner = out["captured"][2]._dp_runner
    assert next(iter(runner._entries.values())).graph is not None
    for p in main.all_parameters():
        vals = runner.replica_values(p.name)
        assert torch.equal(vals[0], vals[1]) and \
            out["captured"][1].get(p.name) is vals[0]
        assert torch.equal(vals[0], out["eager"][1].get(p.name)), p.name


def test_failed_capture_raises_naming_the_op(dev):
    """A lowering that reads a device value on the host cannot be
    captured: the run raises, naming the op, and nothing falls back to
    the eager loop."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import registry
    from paddle_tpu_torch.fluid.layer_helper import LayerHelper

    if not registry.has_op("test_host_read"):
        @registry.simple_op("test_host_read", ["X"], ["Out"], grad=None)
        def _host_read(ctx, x, attrs):
            if x.device.type != "meta":
                float(x.sum())  # a host read: fails a capture
            return x * 2.0

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        helper = LayerHelper("test_host_read")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("test_host_read", inputs={"X": [x]},
                         outputs={"Out": [out]})
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {"x": np.ones((2, 4), np.float32)}
    with pytest.raises(RuntimeError, match="test_host_read"):
        exe.run(main, feed=feed, fetch_list=[out], scope=fluid.Scope())
    torch.cuda.synchronize()
    (got,) = _executor(False).run(
        main, feed=feed, fetch_list=[out], scope=fluid.Scope())
    np.testing.assert_array_equal(got, 2 * feed["x"])


def _scaled_scope(scope, factor):
    """A copy of ``scope`` with every float tensor scaled."""
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        t = scope.get(n)
        out.set(n, t * factor if t.is_floating_point() else t.clone())
    return out


def _assert_scopes_apart(a, b):
    """No tensor is held by both scopes."""
    held = {id(a.get(n)) for n in a.keys()}
    assert held.isdisjoint(id(b.get(n)) for n in b.keys())


def test_one_executor_keeps_two_scopes_apart(dev):
    """One capturing executor runs the same program and feed on scope
    A, then B, then A again: each scope gets its own graph, no tensor
    ends up in both, and each matches its own run by the eager loop
    bit for bit."""
    from paddle_tpu_torch import fluid

    main, startup, loss, _ = _dropout_net()
    base = fluid.Scope()
    _executor(False).run(startup, scope=base)
    feed = {"x": np.ones((8, 64), np.float32)}
    starts = {"a": base, "b": _scaled_scope(base, 0.5)}
    out = {}
    for mode in ("captured", "eager"):
        exe = _executor(mode == "captured")
        scopes = {k: _clone_scope(s) for k, s in starts.items()}
        losses = [exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scopes[k])[0].item()
                  for k in ("a", "b", "a", "b", "a")]
        out[mode] = (losses, scopes, exe)
    assert out["captured"][0] == out["eager"][0]
    scopes = out["captured"][1]
    for k, s in scopes.items():
        for n in s.keys():
            assert torch.equal(s.get(n), out["eager"][1][k].get(n)), (k, n)
    _assert_scopes_apart(scopes["a"], scopes["b"])
    sigs = out["captured"][2].compiled_for(main)
    assert len(sigs) == 2 and all(s.graph is not None for s in sigs)


def test_dp_one_runner_keeps_two_scopes_apart(dev):
    """The data-parallel runner over two replicas on the card, captured,
    on scope A, then B, then A again: each scope matches its own eager
    run bit for bit, its replicas stay identical, and no tensor ends up
    in both scopes."""
    from paddle_tpu_torch import fluid

    main, startup, loss, _ = _dropout_net()
    base = fluid.Scope()
    _executor(False).run(startup, scope=base)
    feed = {"x": np.random.RandomState(3).rand(8, 64).astype(np.float32)}
    starts = {"a": base, "b": _scaled_scope(base, 0.5)}
    out = {}
    for mode in ("captured", "eager"):
        # a program a mode: the transpile rewrites its program in place
        prog, _, prog_loss, _ = _dropout_net()
        cp = fluid.CompiledProgram(prog).with_data_parallel(
            loss_name=prog_loss.name, places=[fluid.CUDAPlace(0)] * 2)
        exe = _executor(mode == "captured")
        scopes = {k: _clone_scope(s) for k, s in starts.items()}
        losses = []
        for k in ("a", "b", "a", "b", "a"):
            losses.append(exe.run(cp, feed=feed, fetch_list=[prog_loss],
                                  scope=scopes[k])[0].tolist())
            runner = cp._dp_runner
            for p in prog.all_parameters():
                vals = runner.replica_values(p.name)
                assert torch.equal(vals[0], vals[1])
                assert scopes[k].get(p.name) is vals[0]
        out[mode] = (losses, scopes, cp)
    assert out["captured"][0] == out["eager"][0]
    scopes = out["captured"][1]
    for k, s in scopes.items():
        for n in s.keys():
            assert torch.equal(s.get(n), out["eager"][1][k].get(n)), (k, n)
    _assert_scopes_apart(scopes["a"], scopes["b"])
    entries = out["captured"][2]._dp_runner._entries.values()
    assert len(entries) == 2 and all(e.graph is not None for e in entries)


def test_graph_cache_frees_the_least_recently_run(dev, monkeypatch):
    """With MAX_GRAPHS 2, feeds of four batch sizes leave two graphs
    held: the least recently run one's graph (and its memory pool) is
    freed, a shape run again captures again (a cache miss), and every
    run matches the eager loop's bit for bit."""
    import gc
    import weakref

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import executor as ex

    main, startup, loss, _ = _dropout_net()
    base = fluid.Scope()
    _executor(False).run(startup, scope=base)
    scopes = {"captured": _clone_scope(base), "eager": _clone_scope(base)}
    monkeypatch.setattr(ex, "MAX_GRAPHS", 2)
    exes = {"captured": _executor(True), "eager": _executor(False)}
    misses = ex._m_cache().labels(path="single", result="miss")
    missed, refs = 0, []
    for batch in (8, 4, 2, 6, 8):
        feed = {"x": np.full((batch, 64), 0.5, np.float32)}
        got = {}
        for k, exe in exes.items():
            m0 = misses.value
            got[k] = exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scopes[k])[0].item()
            if k == "captured":
                missed += misses.value - m0
        assert got["captured"] == got["eager"]
        held = [s.graph for s in exes["captured"].compiled_for(main)
                if s.graph is not None]
        assert len(held) <= 2
        refs += [weakref.ref(g) for g in held]
    assert missed == 5
    gc.collect()
    assert len({id(r()) for r in refs if r() is not None}) == 2


@pytest.mark.parametrize("rows", [2, 512, 30528])
def test_lookup_grad_is_deterministic_on_card(dev, rows):
    """The lookup_table grad at the train step's 16,384 bf16 ids (the
    token-type, position and word tables' sizes): the same bits run to
    run, in a CUDA graph replay, and on the CPU."""
    from paddle_tpu_torch.fluid import registry

    lower = registry.get_op("lookup_table").lower
    g = torch.Generator().manual_seed(rows)
    ids = torch.randint(0, rows, (128, 128), generator=g)
    w = (0.02 * torch.randn(rows, 768, generator=g)).to(torch.bfloat16)
    dout = torch.randn(128 * 128, 768, generator=g).to(torch.bfloat16)

    on = {d: (w.to(d), ids.to(d), dout.to(d)) for d in ("cpu", dev)}

    def grad(device):
        wd, i, d = on[device]
        wd = wd.detach().requires_grad_()
        out = lower(registry.LowerContext(device), wd, i,
                    attrs={}).reshape(-1, 768)
        return torch.autograd.grad(out, wd, d)[0]

    first = grad(dev)
    assert all(torch.equal(first, grad(dev)) for _ in range(3))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad(dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = grad(dev)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)
    assert torch.equal(first.cpu(), grad("cpu"))


# ---------------------------------------------------------------------------
# the default graph passes on the card (fuse_attention sends the unfused
# attention chain to K1-K3) and the decode lane's int8 weights
# ---------------------------------------------------------------------------


def _with_passes(spec, fn):
    from paddle_tpu_torch import fluid

    old = fluid.get_flags("FLAGS_graph_passes")
    fluid.set_flags({"FLAGS_graph_passes": spec})
    try:
        return fn()
    finally:
        fluid.set_flags(old)


def test_unfused_bert_steps_passes_on_off_on_card(dev):
    """BERT-tiny (2 layers) built unfused, fp32, 3 Adam steps from the
    same state with FLAGS_graph_passes default and none: losses within
    1e-4; on the card the fused program launches K1 4, K2 2, K3 2 and
    K4 3 a step (the derived grad recomputes the forward), the composed
    one none of them."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(use_flash_attention=False, attn_dropout=0.0,
                               hidden_dropout=0.0, num_layers=2)

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, loss, _, _ = bert.build_bert_pretrain(cfg)
            fluid.optimizer.Adam(1e-3).minimize(loss)
        startup.random_seed = 5
        return main, startup, loss

    feed = bert.make_fake_batch(cfg, 4, 32, seed=1)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_bias_act")
    want = {"default": dict(zip(names, (4, 2, 2, 3))),
            "none": dict.fromkeys(names, 0)}
    losses = {}
    for spec in want:
        def run():
            main, startup, loss = build()
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup, scope=scope)
            out = []
            for _ in range(3):
                card = _on_card()
                (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)
                got = _on_card()
                assert {n: got[n] - card[n] for n in names} == want[spec]
                out.append(lv.item())
            return out

        losses[spec] = _with_passes(spec, run)
    np.testing.assert_allclose(losses["default"], losses["none"], rtol=1e-4)


def test_fused_softmax_cross_entropy_bit_equal_on_card(dev):
    """The fc -> softmax -> cross_entropy head trained 20 SGD steps on
    the card with the pass on and off: the same losses, bit for bit."""
    from paddle_tpu_torch import fluid

    rng = np.random.RandomState(0)
    feed = {"x": rng.uniform(-1, 1, (16, 8)).astype("float32"),
            "y": rng.randint(0, 4, (16, 1)).astype("int64")}

    def run(spec):
        def go():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), \
                    fluid.unique_name.guard():
                x = fluid.layers.data(name="x", shape=[8], dtype="float32")
                y = fluid.layers.data(name="y", shape=[1], dtype="int64")
                h = fluid.layers.fc(x, size=16, act="relu")
                probs = fluid.layers.softmax(fluid.layers.fc(h, size=4))
                loss = fluid.layers.mean(fluid.layers.cross_entropy(probs, y))
                fluid.optimizer.SGD(0.1).minimize(loss)
            startup.random_seed = 5
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup, scope=scope)
            out = [exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0].item() for _ in range(20)]
            types = [op.type for op in main.global_block().ops]
            return out, types

        return _with_passes(spec, go)

    on, types = run("fuse_softmax_cross_entropy")
    off, _ = run("none")
    assert "fused_softmax_cross_entropy" in types
    assert on == off and on[-1] < on[0]


def test_predictor_over_unfused_bert_on_card(dev, tmp_path):
    """An unfused BERT-tiny encoder saved by the port, served on the
    card: the loaded program holds one flash_attention a layer, each
    run launches K1 once a layer, and the outputs are within 1e-5 of
    the passes-off predictor's."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(use_flash_attention=False, num_layers=2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = [fluid.data(n, [-1, -1], False, dtype=dt)
                 for n, dt in (("src_ids", "int64"), ("pos_ids", "int64"),
                               ("sent_ids", "int64"),
                               ("input_mask", "float32"))]
        enc = bert.bert_encoder(*feeds, cfg, is_test=True)
    startup.random_seed = 3
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path), [f.name for f in feeds],
                                      [enc], exe, main_program=main)
    data = bert.make_fake_batch(cfg, 2, 32, seed=9)
    tensors = [inf.PaddleTensor(data[f.name], name=f.name) for f in feeds]

    def serve(spec):
        def go():
            p = inf.create_paddle_predictor(inf.AnalysisConfig(str(tmp_path)))
            outs = []
            for _ in range(3):
                card = _on_card()["flash_fwd"]
                (out,) = p.run(tensors)
                outs.append((out.as_ndarray(),
                             _on_card()["flash_fwd"] - card))
            return p, outs

        return _with_passes(spec, go)

    p_on, on = serve("default")
    _, off = serve("none")
    types = [op.type for op in p_on._program.global_block().ops]
    assert types.count("flash_attention") == cfg.num_layers
    assert [n for _, n in on] == [cfg.num_layers] * 3
    assert [n for _, n in off] == [0] * 3
    for (a, _), (b, _) in zip(on, off):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_int8_weight_decode_on_card_matches_cpu(dev):
    """A tiny GPT served with int8 weights on the card, captured and
    eager, and on the CPU: the same greedy ids; the scope holds the
    int8 triples only, and K4 and K5 launch once a layer a program
    run."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = gpt.GPTConfig.tiny(num_layers=2, initializer_range=0.2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 4, 33, 4, 8)
    startup.random_seed = 11
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {p.name: init.get(p.name).numpy()
              for p in main.all_parameters()}
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 20))]
    outs = {}
    for key, place, capture in (("cpu", fluid.CPUPlace(), False),
                                ("captured", fluid.CUDAPlace(0), True),
                                ("eager", fluid.CUDAPlace(0), False)):
        scope = fluid.Scope()
        convert.load_params(scope, arrays, place, program=main)
        old = fluid.get_flags("FLAGS_cuda_graph_capture")
        fluid.set_flags({"FLAGS_cuda_graph_capture": capture})
        try:
            eng = DecodeEngine(cfg, scope=scope, place=place, pool_slots=4,
                               page_size=4, prefill_chunk=8, max_len=32,
                               int8_weights=True, auto_start=False)
        finally:
            fluid.set_flags(old)
        assert eng.stats()["int8_weights"]["weights"] == 6 * cfg.num_layers
        card = _on_card()
        try:
            warmed = eng.warmup()
            eng.start()
            outs[key] = eng.generate(prompts, max_new_tokens=8, timeout=120)
        finally:
            eng.close()
        runs = eng.stats()["prefill_chunks"] + eng.stats()["steps"] + warmed
        after = _on_card()
        for k in ("fused_bias_act", "paged_attention"):
            assert after[k] - card[k] == (
                0 if key == "cpu" else cfg.num_layers * runs), (key, k)
    assert outs["captured"] == outs["eager"] == outs["cpu"]


def test_gpt_two_layer_step_on_card_matches_cpu(dev):
    """GPT-tiny (2 layers, dropout 0), fp32, AdamW with the global-norm
    clip, 3 steps on the card (captured) and on the CPU from the same
    parameters: losses and the clip's global norms within 1e-4; the
    card launches K1 4, K2 2, K3 2 and K4 2 a step (causal flash, the
    derived grad's recompute, no MLM head)."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny(num_layers=2, hidden_dropout=0.0)

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, loss = gpt.build_gpt_lm(cfg)
            fluid.optimizer.AdamW(
                1e-3, beta2=0.95, weight_decay=0.1,
                grad_clip=fluid.clip.GradientClipByGlobalNorm(0.5)).minimize(
                    loss)
        startup.random_seed = 5
        (gnorm,) = [op.outputs["Out"][0] for op in main.global_block().ops
                    if op.type == "sqrt"]
        return main, startup, loss, gnorm

    feed = gpt.make_fake_lm_batch(cfg, 4, 64, seed=1)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_bias_act")
    out, init = {}, None
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main, startup, loss, gnorm = build()
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        if init is None:
            init = {p.name: scope.get(p.name).cpu().numpy()
                    for p in main.all_parameters()}
        else:
            convert.load_params(scope, init, place, program=main)
        rows = []
        on_card = isinstance(place, fluid.CUDAPlace)
        for _ in range(3):
            card = _on_card() if on_card else None
            lv, nv = exe.run(main, feed=feed, fetch_list=[loss, gnorm],
                             scope=scope)
            if on_card:
                got = _on_card()
                assert {n: got[n] - card[n] for n in names} == dict(
                    zip(names, (4, 2, 2, 2)))
            rows.append((float(lv), float(np.asarray(nv).reshape(()))))
        out[type(place).__name__] = np.asarray(rows)
    np.testing.assert_allclose(out["CUDAPlace"], out["CPUPlace"], rtol=1e-4)
    assert np.isfinite(out["CUDAPlace"]).all()


# ---------------------------------------------------------------------------
# the serving fleet on the card: Router, Frontend, failover, launches
# ---------------------------------------------------------------------------


def _card_replicas(n=2):
    """Two tiny GPT DecodeEngines on the card with equal weights (replica
    1's scope filled from replica 0's arrays), both warmed up before
    either starts."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = gpt.GPTConfig.tiny(num_layers=2, initializer_range=0.2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 4, 33, 4, 8)
    startup.random_seed = 11
    scopes = [fluid.Scope() for _ in range(n)]
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scopes[0])
    for s in scopes[1:]:
        for p in main.all_parameters():
            s.set(p.name, scopes[0].get(p.name).clone())
    engines = [DecodeEngine(cfg, scope=s, place=fluid.CUDAPlace(0),
                            pool_slots=4, page_size=4, prefill_chunk=8,
                            max_len=32, auto_start=False, name=f"replica{i}",
                            drain_on_sigterm=False)
               for i, s in enumerate(scopes)]
    for eng in engines:
        eng.warmup()
    for eng in engines:
        eng.start()
    return cfg, engines


def test_fleet_failover_on_card_token_exact(dev):
    """The failover drill over two replicas on the card, through a Router
    and the HTTP Frontend: every stream token-exact with the one-replica
    baseline, failovers and recovery booked, no executor-cache miss (no
    new capture), the SLO alert fired and cleared; K4 and K5 launched
    once a layer per program run of both replicas, warmups included."""
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.serving import Frontend, Router, drill

    card = _on_card()
    cfg, engines = _card_replicas()
    router = Router(engines, name="card-fleet", hedge_ms=0,
                    probe_interval_ms=20)
    fe = Frontend(router)
    pool = ThreadPoolExecutor(4)

    def http(prompt, n):
        def call():
            req = urllib.request.Request(
                f"http://{fe.host}:{fe.port}/v1/generate",
                data=json.dumps({"prompt": prompt,
                                 "max_new_tokens": n}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())["tokens"]
        return pool.submit(call)

    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
               for n in (3, 9, 17, 5, 12, 7)]
    try:
        report = drill.failover_drill(
            engines=engines, prompts=prompts, max_new_tokens=12,
            kill_after=3, router=router, submit=http, timeout_s=120)
    finally:
        pool.shutdown()
        fe.close()
        router.close()
        for eng in engines:
            eng.close()
    assert report["ok"], report
    assert report["failed_over_trace"]["root"] == "generate"
    runs = sum(e.stats()["prefill_chunks"] + e.stats()["steps"] + 2
               for e in engines)
    after = _on_card()
    for k in ("fused_bias_act", "paged_attention"):
        assert after[k] - card[k] == cfg.num_layers * runs, k
    assert after["paged_attention_quant"] == card["paged_attention_quant"]


def test_fleet_http_infer_on_card_bit_equal(dev, tmp_path):
    """/v1/infer through the Router to a ragged Engine on the card equals
    a direct submit of the same feeds bit for bit; a model loaded after
    the warmup captures its graph on its first request beside a live
    decode replica; K6 launched once a layer a batch."""
    import json
    import urllib.request

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
    card = _on_card()["ragged_attention"]
    _, (dec,) = _card_replicas(1)
    eng = serving.Engine(batch_buckets=[4], seq_buckets=[8, 16],
                         max_wait_ms=2, auto_start=False,
                         place=fluid.CUDAPlace(0), name="card-infer")
    eng.load_model("m", str(tmp_path), ragged=True)
    eng.warmup()
    eng.start()
    router = serving.Router([dec, eng], name="card-infer", hedge_ms=0)
    fe = serving.Frontend(router)
    try:
        def post(model, feed):
            req = urllib.request.Request(
                f"http://{fe.host}:{fe.port}/v1/infer",
                data=json.dumps({"model": model, "feed": {
                    n: a.tolist() for n, a in feed.items()}}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                return np.asarray(json.loads(r.read())["outputs"][
                    score.name], np.float32)

        live = dec.submit(list(range(1, 20)), 12)
        eng.load_model("cold", str(tmp_path), ragged=True)
        cold = post("cold", feeds[0])
        got = [post("m", f) for f in feeds]
        want = [eng.submit("m", f).result(timeout=60)[score.name]
                for f in feeds]
        live.result(timeout=60)
        st = eng.stats()["models"]
    finally:
        fe.close()
        router.close()
        eng.close()
        dec.close()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(cold, want[0])
    batches = sum(s["batches"] + s["warmup_batches"] for s in st.values())
    assert _on_card()["ragged_attention"] - card == batches
