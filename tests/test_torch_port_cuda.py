"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test is marked ``cuda`` and skips without a GPU.  The
file imports no jax, so it runs on a GPU machine without it:

    PADDLE_TPU_TEST_REAL=1 python -m pytest tests/test_torch_port_cuda.py -q

(``PADDLE_TPU_TEST_REAL=1`` keeps tests/cpu_mesh.py from importing jax.)

Tolerances: K5 atol 2e-5 / rtol 1e-4 (online softmax over pages merged
across warps vs one softmax: same fp32 terms, other order); K4 1e-6 (the
same elementwise formula; erfcf/tanhf may differ by an ulp); the decode
lane's greedy ids exactly (the tiny model's top-two gaps are far wider
than the fp32 differences between cuBLAS and the CPU).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_bias_act as fba
from paddle_tpu_torch.kernels.primitives import paged

pytestmark = pytest.mark.cuda

K5_TOL = dict(atol=2e-5, rtol=1e-4)
K4_TOL = dict(atol=1e-6, rtol=1e-6)


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
        counters = kernel_wrappers()
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
