#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi).
  2. build: every kernel under paddle_tpu_torch/csrc, one nvcc each, all
     started together, for sm_90a.
  3. kernels: each kernel's wrapper (K1-K8) on tensors on the card at
     the shapes its path gives it, held against its plain PyTorch
     version; timed against the plain version, its bound and, where one
     PyTorch call computes the same function, that call (library_ms).
  4. train path: BERT-base pretraining (vocab 30528, flash attention,
     hidden dropout 0.1) at b128 s128 under the bf16 dtype policy with
     Adam(1e-4), through the port's fluid.Executor on CUDAPlace(0):
     2 warm-up and 10 timed steps on one batch.  Losses finite and
     falling; launch counts exactly 24 (K1: 12 layers, forward and the
     grad op's recompute), 12 (K2, K3) and 13 (K4) per step.  Then a
     torch.profiler breakdown of one step.
  5. train parity: the same network at full width, 2 layers, b4 s128,
     fp32, dropout 0: 3 Adam steps on the card and on a CPUPlace
     executor from the same parameters.
  6. decode path: GPTConfig() at full width (random weights from the
     port's own startup program, fixed seed) served by DecodeEngine: 16
     seeded requests of 8-512 prompt tokens, 32 new tokens each.  K4 and
     K5 launch exactly 12 (layers) x program runs.
  7. decode parity: the same weights on a CPUPlace executor (plain
     versions): logprobs of prefill chunks and a decode step, and the
     greedy ids of two requests, against the card's.
  8. int8 decode path: phase 6 over the dual-int8 KV pool
     (pool_dtype="int8"): K4 and K7 launch exactly 12 x program runs, K5
     never.
  9. int8 decode parity: phase 7 over the int8 pool.
 10. ragged Engine path: the repo's ragged scorer (vocab 8192, hidden
     256, 8 heads, 4 layers, a causal ragged_attention a layer), saved
     with save_inference_model and served by serving.Engine (batch
     bucket 8, sequence buckets 32/64/128) in its ragged and its
     bucketed arm: waves of two requests each of 20, 50, 90 and 126
     tokens, one priming and 10 timed.  K6 launches exactly 4 x the
     batches each arm ran, warmup included; the ragged arm warms one
     shape and serves with no padding rows and no cold run.
 11. ragged Engine parity: each arm's scores against a CPUPlace engine
     on the same saved model and requests.
 12. data-parallel train path: phase 4's configuration through
     CompiledProgram(...).with_data_parallel(places=[CUDAPlace(0)] * 4)
     with the quantized gradient all-reduce: the global batch b128 s128
     split into four replica shards of b32, 2 warm-up and 5 timed
     steps.  Losses finite and falling; K8 launches exactly (the
     program's fused_adam_quant_grad ops) x 4 a step and K1-K4 4x their
     phase-4 counts; every replica's parameters bit-identical; the
     bucket plan, modeled wire bytes, fused-update bytes saved, peak
     memory and tokens/s (four replicas share one card: not a scaling
     figure); a torch.profiler step with K8's device time against its
     bound.
 13. data-parallel parity: full width, 2 layers, b8 s128, fp32,
     dropout 0, 3 steps over four replicas on the card and over four
     CPUPlace replicas from the same parameters: the losses, and each
     parameter above the rounding floor by the relative norms of its
     Moment1, Moment2 and change (DP_GRAD_FLOOR); the worst leaf of
     each reading, and the leaves at the floor, are printed.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel of the path launched no time fails the run.  The
last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Exits non-zero (and prints no result)
without CUDA or without the package beside it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234

# K5 kernel vs plain: the kernel sums keys page by page with an online
# softmax merged across four warps; the plain version takes one softmax
# over the whole row and one matmul.  Same fp32 terms, other order.
K5_TOL = dict(atol=2e-5, rtol=1e-4)
# K4 kernel vs plain: the same elementwise formula; erfcf/tanhf in the
# kernel and PyTorch's CUDA erfc/tanh may differ by an ulp.
K4_TOL = dict(atol=1e-6, rtol=1e-6)
# K4 in bf16: kernel and plain version both round the same fp32 value to
# bf16, so they may differ by one bf16 ulp (2^-8 relative)
K4_BF16_TOL = dict(atol=8e-3, rtol=8e-3)
# K1-K3 vs plain: fp32 sums over 64-key (or 64-query) tiles vs one
# matmul; in bf16 both round one fp32 result, so one bf16 ulp apart
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# dBias sums dL over every query: fp32 in both, other order
FLASH_DBIAS_TOL = dict(atol=1e-4, rtol=1e-4)
# full model on the card vs on the CPU: 12 layers of fp32 matmuls summed
# in other orders (cuBLAS vs the CPU BLAS) before a 32000-way log_softmax
PATH_LOGP_ATOL = 1e-3
# BERT training on the card vs the CPU, fp32: per-step losses; and the
# parameters of one layer after 3 Adam steps, where one element's update
# is at most lr in size and its sign can follow a grad that is zero up
# to the two BLAS libraries' rounding: max abs diff within 3 x lr, mean
# abs diff within 1e-6
TRAIN_LOSS_RTOL = 1e-4
TRAIN_LR = 1e-4
TRAIN_PARAM_MAX_ATOL = 3 * TRAIN_LR
TRAIN_PARAM_MEAN_ATOL = 1e-6

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32
# (non-tensor-core) flop/s and bf16 dense tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
GELU_FLOPS_PER_ELEMENT = 10  # add, scale, erfc, mul... as counted in PERF.md
SLEEP_CYCLES = 400_000_000  # ~0.2 s of device sleep ahead of a timed run


def _gpu_place():
    from paddle_tpu_torch import fluid

    return fluid.CUDAPlace(0)


def _model_config():
    """The served model: GPTConfig() at its defaults (vocab 32000, hidden
    768, 12 layers, 12 heads, FFN 3072, 1024 positions)."""
    from paddle_tpu_torch.models import gpt

    return gpt.GPTConfig()


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, iters, flush=None):
    """Mean device time of one fn() call, CUDA events around each call;
    `flush` (run between calls, untimed) evicts L2.  A device sleep is
    queued first, so the host has enqueued every call before the card
    reaches the first: the events then time the card's work, not the
    host's launch overhead (checked: the sleep must outlast the
    enqueueing, so `iters` x the launches of one call must stay within
    the stream's queue of pending work, a few hundred entries)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for a, b in evs:
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if start.elapsed_time(evs[0][0]) <= host_ms:
        raise RuntimeError(f"timing: the device sleep ended before the host "
                           f"finished enqueueing ({host_ms:.2f} ms); raise "
                           f"SLEEP_CYCLES")
    return sum(a.elapsed_time(b) for a, b in evs) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _paged_inputs(dev, b, n, t, d, page_size, max_pages, num_pages,
                  q_start, rng):
    q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                         .astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                         .astype(np.float32)).to(dev)
    # page 0 is the trash page: poison it, so attending it would show
    k[0] = 1e4
    v[0] = 1e4
    return (q, k, v) + _page_table(dev, b, t, page_size, max_pages,
                                   num_pages, q_start, rng)


def _page_table(dev, b, t, page_size, max_pages, num_pages, q_start, rng):
    """(page_table, q_start) on the card: each row's live pages drawn
    without repeats from pages 1.. (never the trash page)."""
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        live = min(max_pages, (q_start[r] + t - 1) // page_size + 1)
        table[r, :live] = perm[r * max_pages:r * max_pages + live]
    return (torch.from_numpy(table).to(dev),
            torch.tensor(q_start, dtype=torch.int32, device=dev))


def _bound(byts, flops, peak=FP32_FLOPS):
    """(least ms on the card, what bounds it): bytes over the HBM rate vs
    flops over the ``peak`` rate (fp32 SIMT unless given)."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _paged_bound(b, n, t, d, page_size, q_start):
    """Least time for one call with these q_start values: each visible
    K/V row, q, out and the live page-table entries moved once; 4·d
    flops per visible (query, key) pair."""
    keys = sum(qs + t for qs in q_start)          # K/V rows per head
    pairs = sum((qs + 1 + qs + t) * t // 2 for qs in q_start)
    live_pages = sum(-(-(qs + t) // page_size) for qs in q_start)
    byts = (keys * n * d * 4 * 2 + 2 * b * n * t * d * 4 + b * 4
            + live_pages * 4)
    return _bound(byts, pairs * n * 4 * d) + (byts,)


def check_paged(dev, rng):
    from paddle_tpu_torch.kernels.primitives import paged

    n, d, page_size, max_pages, num_pages = 12, 64, 16, 64, 513
    cases = [("decode", 8, 1, [0, 15, 16, 17, 500, 777, 1000, 1023])]
    cases += [(f"prefill@{qs}", 1, 32, [qs]) for qs in (0, 32, 992)]
    worst, timings = 0.0, {}
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)  # 256 MB > 50 MB L2
    for name, b, t, q_start in cases:
        args = _paged_inputs(dev, b, n, t, d, page_size, max_pages,
                             num_pages, q_start, rng)
        got = paged.paged_attention(*args, sm_scale=d ** -0.5)
        want = paged.paged_attention_reference(*args, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **K5_TOL) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention {name}: max abs err {err} "
                                 f"outside {K5_TOL}")
        worst = max(worst, err)
        flush = flush_buf.zero_
        ms = _time_ms(lambda: paged.paged_attention(*args, sm_scale=d ** -0.5),
                      50, flush)
        plain_ms = _time_ms(lambda: paged.paged_attention_reference(
            *args, sm_scale=d ** -0.5), 20, flush)
        bound_ms, bound_by, byts = _paged_bound(b, n, t, d, page_size,
                                                q_start)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=byts,
                             max_abs_err=err)
    del flush_buf
    return worst, timings


def _quant_pool(dev, num_pages, page_size, n, d, rng):
    """A dual-int8 pool (hi, lo, scale for K and V) quantized from random
    fp32 by the port's codec; the trash page's scales poisoned, so
    attending it would show."""
    from paddle_tpu_torch.kernels.primitives import int8

    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                             .astype(np.float32)).to(dev)
        hi, lo, sc = int8.quantize_lastdim(x)
        sc[0] = 1e4
        out += [hi, lo, sc]
    return out


def _paged_quant_bound(b, n, t, d, page_size, q_start):
    """Least time for one K7 call: as K5's, with each visible K/V row
    read as 2 bytes a code (hi + lo) and a 4-byte scale."""
    keys = sum(qs + t for qs in q_start)
    pairs = sum((qs + 1 + qs + t) * t // 2 for qs in q_start)
    live_pages = sum(-(-(qs + t) // page_size) for qs in q_start)
    byts = (keys * n * (2 * d + 4) * 2 + 2 * b * n * t * d * 4 + b * 4
            + live_pages * 4)
    return _bound(byts, pairs * n * 4 * d) + (byts,)


def check_paged_quant(dev, rng):
    """K7 at the int8 decode lane's shapes: the decode step (8 slots) and
    the prefill chunk (32 queries), over a 513-page pool with a poisoned
    trash page."""
    from paddle_tpu_torch.kernels.primitives import paged

    n, d, page_size, max_pages, num_pages = 12, 64, 16, 64, 513
    cases = [("decode", 8, 1, [0, 15, 16, 17, 500, 777, 1000, 1023])]
    cases += [(f"prefill@{qs}", 1, 32, [qs]) for qs in (0, 32, 992)]
    pool = _quant_pool(dev, num_pages, page_size, n, d, rng)
    worst, timings = 0.0, {}
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)  # 256 MB > 50 MB L2
    for name, b, t, q_start in cases:
        q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)).to(dev)
        args = (q, *pool, *_page_table(dev, b, t, page_size, max_pages,
                                       num_pages, q_start, rng))
        got = paged.paged_attention_quant(*args, sm_scale=d ** -0.5)
        want = paged.paged_attention_quant_reference(*args,
                                                     sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **K5_TOL) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention_quant {name}: max abs err "
                                 f"{err} outside {K5_TOL}")
        worst = max(worst, err)
        flush = flush_buf.zero_
        ms = _time_ms(lambda: paged.paged_attention_quant(
            *args, sm_scale=d ** -0.5), 50, flush)
        plain_ms = _time_ms(lambda: paged.paged_attention_quant_reference(
            *args, sm_scale=d ** -0.5), 10, flush)
        bound_ms, bound_by, byts = _paged_quant_bound(b, n, t, d, page_size,
                                                      q_start)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=byts,
                             max_abs_err=err, library_ms=None)
    del flush_buf
    return worst, timings


def _ragged_bound(h, s, d, lengths, causal):
    """Least time for one K6 call: q and o of every row, and K/V rows
    below each row's length, moved once; 4·d flops per live (query, key)
    pair — j < length (and j <= i when causal) — at the fp32 rate
    without tensor cores (exact fp32 products)."""
    pairs, kv_rows = 0, 0
    for ln in lengths:
        n_keys = min(max(ln, 0), s)
        kv_rows += n_keys
        pairs += (sum(min(i + 1, n_keys) for i in range(s)) if causal
                  else s * n_keys)
    byts = (2 * len(lengths) * h * s * d + 2 * h * kv_rows * d) * 4 \
        + 4 * len(lengths)
    return _bound(byts, h * pairs * 4 * d) + (byts,)


def _sdpa_ragged_ms(q, k, v, lengths, causal, scale):
    """The library yardstick: scaled_dot_product_attention with the same
    boolean key mask (a length-0 row gives NaN there; timing only)."""
    import torch.nn.functional as F

    s = q.shape[2]
    j = torch.arange(s, device=q.device)
    mask = j.view(1, 1, 1, s) < lengths.view(-1, 1, 1, 1)
    if causal:
        mask = mask & (j.view(1, 1, 1, s) <= j.view(1, 1, s, 1))
    return _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), 50)


def check_ragged(dev, rng):
    """K6 at the ragged Engine path's shapes: q/k/v [8, 8, S, 32] fp32
    transposed views of [8, S, 8, 32], S = 128 with the wave's lengths
    (timed) and with a row of length 0, the bucketed arm's S = 32 and 64
    whose padding rows carry length 0; and S = 200, D = 64, causal on
    and off."""
    from paddle_tpu_torch.kernels.primitives import ragged

    wave = [20, 20, 50, 50, 90, 90, 126, 126]
    cases = [("path", 8, 8, 128, 32, True, wave),
             ("len0", 8, 8, 128, 32, True, [20, 50, 90, 126, 0, 126, 3, 128]),
             ("bucket32", 8, 8, 32, 32, True, [20, 20, 0, 0, 0, 0, 0, 0]),
             ("bucket64", 8, 8, 64, 32, True, [50, 50, 0, 0, 0, 0, 0, 0]),
             ("s200_causal", 4, 4, 200, 64, True, [200, 150, 7, 0]),
             ("s200", 4, 4, 200, 64, False, [200, 150, 7, 0])]
    worst, timings = 0.0, {}
    for name, b, h, s, d, causal, lens in cases:
        q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(dev).transpose(1, 2) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        got = ragged.ragged_attention(q, k, v, lengths, causal, scale)
        want = ragged.ragged_attention(q, k, v, lengths, causal, scale,
                                       force="reference")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **FLASH_TOL[torch.float32]) \
                or not torch.isfinite(got).all() \
                or got.stride() != q.stride():
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} outside {FLASH_TOL[torch.float32]}")
        worst = max(worst, err)
        if name not in ("path", "bucket32", "bucket64"):
            continue
        bound_ms, bound_by, byts = _ragged_bound(h, s, d, lens, causal)
        timings[name] = dict(
            ms=_time_ms(lambda: ragged.ragged_attention(
                q, k, v, lengths, causal, scale), 50),
            plain_ms=_time_ms(lambda: ragged.ragged_attention(
                q, k, v, lengths, causal, scale, force="reference"), 20),
            bound_ms=bound_ms, bound_by=bound_by, bytes=byts,
            library_ms=_sdpa_ragged_ms(q, k, v, lengths, causal, scale),
            max_abs_err=err, shape=[b, h, s, d], lengths=lens)
    return worst, timings


def _bias_gelu_bound(r, h, with_mask):
    byts = r * h * 4 * 2 + h * 4 + (r * h if with_mask else 0)
    return _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT) + (byts,)


def check_bias_gelu(dev, rng):
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    worst, timings = 0.0, {}
    for r in (8, 32, 37):
        h = 3072
        x = torch.from_numpy(rng.randn(r, h).astype(np.float32) * 3).to(dev)
        bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(dev)
        mask = torch.from_numpy((rng.rand(r, h) > 0.1).astype(np.uint8)).to(dev)
        for with_mask in (False, True):
            for approx in (False, True):
                kw = dict(mask=mask if with_mask else None,
                          scale=1 / 0.9 if with_mask else 1.0,
                          approximate=approx)
                got = fba.fused_bias_gelu(x, bias, **kw)
                want = fba.fused_bias_gelu_reference(x, bias, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, **K4_TOL):
                    raise AssertionError(
                        f"fused_bias_gelu [{r},{h}] mask={with_mask} "
                        f"approximate={approx}: max abs err {err} outside "
                        f"{K4_TOL}")
                worst = max(worst, err)
                if not approx:
                    ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias, **kw),
                                  100)
                    plain_ms = _time_ms(
                        lambda: fba.fused_bias_gelu_reference(x, bias, **kw),
                        30)
                    bound_ms, bound_by, byts = _bias_gelu_bound(
                        r, h, with_mask)
                    timings[f"[{r},{h}] mask={with_mask}"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bytes=byts, max_abs_err=err)
    return worst, timings


def check_bias_gelu_bf16(dev, rng):
    """K4 on bf16 input at the training path's two shapes: the 12 FFN
    fc_0 outputs [b*s, 3072] and the MLM head [b*s/8, 768]."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    worst, timings = 0.0, {}
    for r, h in ((16384, 3072), (2048, 768)):
        x = torch.from_numpy(rng.randn(r, h).astype(np.float32) * 3).to(
            dev, torch.bfloat16)
        bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(
            dev, torch.bfloat16)
        got = fba.fused_bias_gelu(x, bias)
        want = fba.fused_bias_gelu_reference(x, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != torch.bfloat16 \
                or not torch.allclose(got.float(), want.float(),
                                      **K4_BF16_TOL):
            raise AssertionError(f"fused_bias_gelu bf16 [{r},{h}]: max abs "
                                 f"err {err} outside {K4_BF16_TOL}")
        worst = max(worst, err)
        ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias), 50)
        plain_ms = _time_ms(lambda: fba.fused_bias_gelu_reference(x, bias),
                            20)
        byts = r * h * 2 * 2 + h * 2
        bound_ms, bound_by = _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT)
        timings[f"[{r},{h}] bf16"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=byts, max_abs_err=err)
    return worst, timings


def _flash_inputs(dev, b, h, s, d, dtype, rng):
    """q, k, v, dO as the BERT program hands them to the op: [B, H, S, D]
    transposed views of [B, S, H, D] activations; a key bias [B*H, S]
    with -1e4 pads on a quarter of the rows' tails."""
    def t():
        a = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        return a.to(dev, dtype).transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    bias = np.zeros((b, s), np.float32)
    bias[::4, s - s // 4:] = -1e4
    rows = torch.from_numpy(np.repeat(bias, h, axis=0)).to(dev)
    return q, k, v, do, rows


def _flash_bounds(bh, s, d, elem, causal):
    """(ms, bound_by) of K1, K2, K3: each operand read once and each
    output written once at HBM rate vs the products' flops (2 per
    multiply-add over the live (query, key) pairs) at the bf16
    tensor-core rate."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    mat = elem * bh * s * d      # one [BH, S, D] operand
    row = 4 * bh * s             # one fp32 [BH, S] row vector
    k1 = _bound(3 * mat + row + mat + row, 2 * 2 * pairs * d, BF16_TC_FLOPS)
    k2 = _bound(4 * mat + 3 * row + mat, 3 * 2 * pairs * d, BF16_TC_FLOPS)
    k3 = _bound(4 * mat + 3 * row + 2 * mat + row, 4 * 2 * pairs * d,
                BF16_TC_FLOPS)
    return k1, k2, k3


def _sdpa_ms(q, k, v, do, rows, scale):
    """The library yardstick: scaled_dot_product_attention with the same
    float key mask, forward, and its backward (dQ, dK, dV together)."""
    import torch.nn.functional as F

    b, h, s, _ = q.shape
    mask = rows.reshape(b, h, 1, s).to(q.dtype)
    fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), 20)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         scale=scale)
    bwd = _time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                               retain_graph=True), 20)
    return fwd, bwd


def check_flash(dev, rng):
    """K1, K2, K3 against their plain versions: at the BERT path's shape
    (BH = 1536, S = 128, D = 64, bf16) and at S = 200 (a ragged tile),
    causal on and off, in fp32.  Timed at the path's shape."""
    from paddle_tpu_torch.kernels.primitives import flash

    cases = [("path", 128, 12, 128, 64, torch.bfloat16, False),
             ("ragged", 4, 12, 200, 64, torch.float32, False),
             ("ragged_causal", 4, 12, 200, 64, torch.float32, True)]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    timings = {}
    for name, b, h, s, d, dtype, causal in cases:
        q, k, v, do, rows = _flash_inputs(dev, b, h, s, d, dtype, rng)
        scale = d ** -0.5
        o, lse = flash.flash_fwd(q, k, v, rows, causal, scale)
        o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, causal, scale,
                                         force="reference")
        lse_rows = lse_ref.reshape(b * h, s)
        delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
        bargs = (q, k, v, rows, do, lse_rows, delta, causal, scale)
        dq = flash.flash_bwd_dq(*bargs)
        dk, dv, db = flash.flash_bwd_dkv(*bargs)
        dq_ref = flash.flash_bwd_dq(*bargs, force="reference")
        dk_ref, dv_ref, db_ref = flash.flash_bwd_dkv(*bargs,
                                                     force="reference")
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        for kern, got, want, t in (
                ("flash_fwd", o, o_ref, tol),
                ("flash_fwd", lse, lse_ref, FLASH_TOL[torch.float32]),
                ("flash_bwd_dq", dq, dq_ref, tol),
                ("flash_bwd_dkv", dk, dk_ref, tol),
                ("flash_bwd_dkv", dv, dv_ref, tol),
                ("flash_bwd_dkv", db, db_ref, FLASH_DBIAS_TOL)):
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), **t) \
                    or not torch.isfinite(got).all():
                raise AssertionError(f"{kern} {name}: max abs err {err} "
                                     f"outside {t}")
            worst[kern] = max(worst[kern], err)
        if name != "path":
            continue
        k1, k2, k3 = _flash_bounds(b * h, s, d, 2, causal)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do, rows, scale)
        for kern, fn, plain, (bound_ms, bound_by), lib in (
                ("flash_fwd",
                 lambda: flash.flash_fwd(q, k, v, rows, causal, scale),
                 lambda: flash.flash_fwd(q, k, v, rows, causal, scale,
                                         force="reference"), k1, lib_fwd),
                ("flash_bwd_dq", lambda: flash.flash_bwd_dq(*bargs),
                 lambda: flash.flash_bwd_dq(*bargs, force="reference"), k2,
                 lib_bwd),
                ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(*bargs),
                 lambda: flash.flash_bwd_dkv(*bargs, force="reference"), k3,
                 lib_bwd)):
            timings[kern] = dict(
                ms=_time_ms(fn, 30), plain_ms=_time_ms(plain, 10),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                shape=[b * h, s, d], dtype="bfloat16")
        timings["sdpa_note"] = ("library_ms: flash_fwd against SDPA "
                                "forward; flash_bwd_dq and flash_bwd_dkv "
                                "each against SDPA's whole backward")
    return worst, timings


K8_BLOCK = 256
# K8 kernel vs plain: the kernel spells every operation in the plain
# version's order with round-to-nearest intrinsics (no fused
# multiply-add), so the two should agree bit for bit; 1e-6 relative is
# the gate in case the card's sqrt or division rounds otherwise, and
# the requant codes must be equal
K8_RTOL = 1e-6
# (name, numel): BERT-base's word embedding (30528 x 768), an FFN weight
# (768 x 3072), a 768 bias (launch-bound), and a numel that is not a
# multiple of the block
K8_SHAPES = (("word_embedding", 30528 * 768), ("ffn_weight", 768 * 3072),
             ("bias", 768), ("ragged", 1000003))
# (kind, use_nesterov) of every K8 kind
K8_KINDS = (("adam", False), ("adamw", False), ("momentum", False),
            ("momentum", True), ("sgd", False))


def _k8_case(dev, numel, rng, offset_blocks=3):
    """Parameter state and a gradient bucket slice for one K8 call: the
    member's blocks start ``offset_blocks`` into a wire image quantized
    by the port's codec from random fp32 (zero in the member's padding),
    with two blocks after it."""
    from paddle_tpu_torch.kernels import quantized_collectives as qc

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    nb = -(-numel // K8_BLOCK)
    bucket = rng.randn((offset_blocks + nb + 2) * K8_BLOCK)
    # the member's alignment padding is zero, as coalesce_tensor pads it
    bucket[offset_blocks * K8_BLOCK + numel:(offset_blocks + nb) * K8_BLOCK] = 0
    hi, lo, sc = qc.quantize_block_scaled(f32(bucket), K8_BLOCK)
    state = dict(p=f32(rng.randn(numel) * 0.1),
                 m1=f32(rng.randn(numel) * 0.01),
                 m2=f32(np.abs(rng.randn(numel)) * 0.01),
                 lr=f32([1e-3]), b1p=f32([0.9 ** 3]), b2p=f32([0.999 ** 3]))
    return state, (hi, lo, sc, offset_blocks, numel)


def _k8_call(kind, nesterov, s, grad, requant, force=None):
    """One fused update through the public entry; returns every tensor
    it wrote (the state is updated in place)."""
    from paddle_tpu_torch.kernels import fused_update as fu

    pad = K8_BLOCK if requant else None
    kw = dict(block_size=K8_BLOCK, requant_pad=pad, force=force)
    if kind in ("adam", "adamw"):
        fn = fu.fused_adam_update if kind == "adam" else fu.fused_adamw_update
        out = fn(s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"],
                 s["b2p"], **kw)
    elif kind == "momentum":
        out = fu.fused_momentum_update(s["p"], grad, s["m1"], s["lr"],
                                       use_nesterov=nesterov, **kw)
    else:
        out = fu.fused_sgd_update(s["p"], grad, s["lr"], **kw)
    return out if isinstance(out, tuple) else (out,)


def _k8_bytes(kind, numel):
    """Bytes one K8 call must move: p (and each moment) read and
    written, hi and lo read, one scale a block, lr and the powers."""
    state = {"adam": 3, "adamw": 3, "momentum": 2, "sgd": 1}[kind]
    return numel * (8 * state + 2) + 4 * -(-numel // K8_BLOCK) + 12


def check_fused_update(dev, rng):
    """K8 against its plain version for every kind, in the fp32 and the
    requant form, at K8_SHAPES; the adam form timed at each shape."""
    from paddle_tpu_torch.kernels import fused_update as fu

    worst, timings = 0.0, {}
    for name, numel in K8_SHAPES:
        for kind, nesterov in K8_KINDS:
            for requant in (False, True):
                state, grad = _k8_case(dev, numel, rng)
                ref = {k: v.clone() for k, v in state.items()}
                got = _k8_call(kind, nesterov, state, grad, requant)
                want = _k8_call(kind, nesterov, ref, grad, requant,
                                force="reference")
                torch.cuda.synchronize()
                label = (f"{kind}{'-nesterov' if nesterov else ''} {name} "
                         f"requant={requant}")
                # the requant form writes p as the payload's dequantized
                # image on the kernel's path: its codes and scales are
                # what to compare
                for g, w in list(zip(got, want))[1 if requant else 0:]:
                    if g.dtype == torch.int8:
                        bad = int((g != w).sum())
                        if bad:
                            raise AssertionError(f"fused_update {label}: "
                                                 f"{bad} codes differ")
                        continue
                    err = (g - w).abs().max().item()
                    if not torch.allclose(g, w, rtol=K8_RTOL,
                                          atol=K8_RTOL * w.abs().max()) \
                            or not torch.isfinite(g).all():
                        raise AssertionError(f"fused_update {label}: max abs "
                                             f"err {err}")
                    worst = max(worst, err)
        state, grad = _k8_case(dev, numel, rng)
        s = state
        hyper = (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8, 0.0)
        ms = _time_ms(lambda: fu.fused_update_kernel(
            "adam", s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"],
            s["b2p"], hyper, K8_BLOCK), 50 if numel > 1e6 else 200)
        # the plain version launches some 30 kernels a call: few calls at
        # the large shapes, so the host finishes enqueueing within the
        # device sleep
        plain_ms = _time_ms(lambda: _k8_call("adam", False, s, grad, False,
                                             force="reference"),
                            3 if numel > 1e6 else 20)
        byts = _k8_bytes("adam", numel)
        bound_ms, bound_by = _bound(byts, 0)
        timings[name] = dict(numel=numel, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bytes=byts, library_ms=None)
    return worst, timings


# ---------------------------------------------------------------------------
# phases 4-5: BERT-base training at full width, and its CPU parity
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 128, 128
TRAIN_WARMUP, TRAIN_STEPS = 2, 10


def _bert_program(cfg, bf16):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss


def run_train_path(counters):
    """BERT-base, b128 s128, bf16 policy, Adam, flash, on the card."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=True)
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counters.values():
        w.launches = 0
    losses, secs = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        secs.append(time.perf_counter() - t0)  # the fetch synchronizes
        losses.append(float(lv))
    launches = {k: w.launches for k, w in counters.items()}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    expect = {"flash_fwd": 2 * cfg.num_layers * steps,
              "flash_bwd_dq": cfg.num_layers * steps,
              "flash_bwd_dkv": cfg.num_layers * steps,
              "fused_bias_act": (cfg.num_layers + 1) * steps}
    if launches != expect:
        raise AssertionError(f"train path launches {launches}, expected "
                             f"{expect}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train path losses not finite and falling: "
                             f"{losses}")
    timed = np.asarray(secs[TRAIN_WARMUP:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = bert.train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    path = dict(model="BertConfig.base(vocab_size=30528)", batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, dtype_policy="bf16", steps=TRAIN_STEPS,
                warmup_steps=TRAIN_WARMUP, losses=losses,
                tokens_per_s=tokens * TRAIN_STEPS / float(timed.sum()),
                step_p50_ms=1e3 * float(np.percentile(timed, 50)),
                step_p95_ms=1e3 * float(np.percentile(timed, 95)),
                model_flops_per_step=flops,
                mfu_vs_989_tflops=flops / float(np.median(timed))
                / BF16_TC_FLOPS,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches)
    return (exe, main, scope, feed, loss), path


def _profile(step, n, match=None):
    """Host wall time vs summed device time of ``n`` calls of ``step``
    (torch.profiler), with the top device and host ops; with ``match``,
    also the summed device time and count a call of the device events
    whose name contains it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    dev, host = [], []
    for e in prof.key_averages():
        # device-side events (kernels, copies) only: a CPU op such as
        # aten::mm also carries the device time of the kernels under it
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            d_us = (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) or 0)
            dev.append((d_us, e.key, e.count))
        else:
            host.append((getattr(e, "self_cpu_time_total", 0) or 0, e.key,
                         e.count))
    dev_us = sum(t for t, _, _ in dev)

    def top(rows, k=8):
        return [[key[:60], round(t / n, 1), c // n]
                for t, key, c in sorted(rows, reverse=True)[:k]]

    out = dict(wall_profiled_ms=1e3 * wall,
               device_busy_ms=dev_us / n / 1e3 if dev_us else None,
               device_events=sum(c for _, _, c in dev) // n,
               top_device_us=top(dev), top_host_self_us=top(host))
    if match is not None:
        hits = [(t, c) for t, key, c in dev if match in key]
        out[f"{match}_device_ms"] = sum(t for t, _ in hits) / n / 1e3
        out[f"{match}_events"] = sum(c for _, c in hits) // n
    return out


def profile_train_step(state):
    exe, main, scope, feed, loss = state
    out = _profile(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope), 1)
    t0 = time.perf_counter()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    out["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    if out["device_busy_ms"]:
        out["device_idle_share"] = 1 - out["device_busy_ms"] \
            / out["step_wall_ms"]
    return out


def run_train_parity():
    """Full width, 2 layers, b4 s128, fp32, dropout 0: 3 Adam steps on
    the card and on the CPU from the same parameters."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=False)
    feed = bert.make_fake_batch(cfg, 4, 128, seed=1)
    gpu = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=gpu)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    convert.load_params(cpu, {p.name: gpu.get(p.name).cpu().numpy()
                              for p in main.all_parameters()},
                        fluid.CPUPlace(), program=main)
    losses = {}
    for key, scope, place in (("gpu", gpu, _gpu_place()),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        losses[key] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["gpu"],
                                                  losses["cpu"]))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"train parity: losses {losses}, max rel diff "
                             f"{rel} >= {TRAIN_LOSS_RTOL}")
    layer = [p.name for p in main.all_parameters()
             if p.name.startswith("encoder_layer_1_")]
    worst, mean = 0.0, 0.0
    for n in layer:
        d = np.abs(gpu.get(n).cpu().numpy() - cpu.get(n).numpy())
        worst, mean = max(worst, float(d.max())), max(mean, float(d.mean()))
    if not (worst <= TRAIN_PARAM_MAX_ATOL and mean <= TRAIN_PARAM_MEAN_ATOL):
        raise AssertionError(f"train parity: encoder_layer_1 params differ "
                             f"by max {worst} / mean {mean}")
    return dict(losses=losses, loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, layer="encoder_layer_1",
                layer_params=len(layer), param_max_abs_diff=worst,
                param_mean_abs_diff=mean,
                param_tol=[TRAIN_PARAM_MAX_ATOL, TRAIN_PARAM_MEAN_ATOL])


# ---------------------------------------------------------------------------
# phases 12-13: the data-parallel training lane (four replicas on one
# card, quantized gradient all-reduce, K8), and its CPU parity
# ---------------------------------------------------------------------------

DP_REPLICAS = 4
DP_WARMUP, DP_STEPS = 2, 5
# card vs CPU replicas, fp32, 3 Adam steps.  The losses within 1e-4
# relative.  A leaf (a parameter) whose reference gradient sits at the
# rounding floor — its bias-corrected RMS, read from the CPU run's
# Moment2, under DP_GRAD_FLOOR x the median leaf's, about fp32's
# relative rounding, as for the attention key biases whose true
# gradient is 0 — has no direction to hold.  Every other leaf is held by
# relative norms: Moment1 and Moment2 (which carry the gradient's scale,
# which Adam's step hides) within DP_MOMENT_RTOL, the parameter's change
# within DP_PARAM_RTOL.  The dual-int8 wire resolves 1/(127 x 254) of a
# block's max, so card-vs-CPU rounding that flips a code moves a reduced
# gradient by ~3e-5 of its block; a wrong average or scale index moves
# a leaf's moments by 0.5 or more
DP_GRAD_FLOOR = 1e-6
DP_MOMENT_RTOL = 1e-3
DP_PARAM_RTOL = 1e-2
DP_PARITY_STEPS = 3


def _dp_feed(cfg, batch, seq, seed):
    """The global batch as DP_REPLICAS per-replica batches of
    make_fake_batch, concatenated: each replica's mask_pos (flat
    positions into its own rows) indexes its shard, as a user of the
    data-parallel lane feeds it."""
    from paddle_tpu_torch.models import bert

    shards = [bert.make_fake_batch(cfg, batch // DP_REPLICAS, seq,
                                   seed=seed + r)
              for r in range(DP_REPLICAS)]
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}


def _dp_compiled(main, loss, places):
    """The lane as a user writes it: quantized all-reduce on, the fused
    update and the rest at their flag defaults."""
    from paddle_tpu_torch import fluid

    bs = fluid.BuildStrategy()
    bs.quant_allreduce = True
    return fluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, places=places)


def _counter_value(name):
    from paddle_tpu_torch.observability import metrics

    fam = metrics.snapshot().get(name)
    return sum(fam["samples"].values()) if fam else 0.0


def run_dp_path(counters):
    """BERT-base (phase 4's configuration) over DP_REPLICAS replicas on
    CUDAPlace(0): global batch b128 s128, b32 a replica.  K8 must launch
    (fused_adam_quant_grad ops) x replicas a step, K1-K4 replicas x
    their phase-4 counts; the replicas' parameters bit-identical after
    the run."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=True)
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    compiled = _dp_compiled(main, loss, [_gpu_place()] * DP_REPLICAS)
    feed = _dp_feed(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    saved0 = _counter_value("pt_fused_update_bytes_saved_total")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counters.values():
        w.launches = 0
    losses, secs = [], []
    for _ in range(DP_WARMUP + DP_STEPS):
        t0 = time.perf_counter()
        (lv,) = exe.run(compiled, feed=feed, fetch_list=[loss], scope=scope)
        secs.append(time.perf_counter() - t0)  # the fetch synchronizes
        losses.append([float(v) for v in lv])
    launches = {k: w.launches for k, w in counters.items()}
    runner = compiled._dp_runner
    prog = runner.program
    n_fused = sum(op.type == "fused_adam_quant_grad"
                  for op in prog.global_block().ops)
    steps, n = DP_WARMUP + DP_STEPS, DP_REPLICAS
    expect = {"flash_fwd": 2 * cfg.num_layers * n * steps,
              "flash_bwd_dq": cfg.num_layers * n * steps,
              "flash_bwd_dkv": cfg.num_layers * n * steps,
              "fused_bias_act": (cfg.num_layers + 1) * n * steps,
              "fused_update": n_fused * n * steps}
    expect = {k: v for k, v in expect.items() if k in counters}
    if launches != expect:
        raise AssertionError(f"dp path launches {launches}, expected "
                             f"{expect} ({n_fused} fused_adam_quant_grad "
                             f"ops)")
    means = [float(np.mean(x)) for x in losses]
    if not np.isfinite(losses).all() or not means[-1] < means[0]:
        raise AssertionError(f"dp path losses not finite and falling: "
                             f"{losses}")
    params = main.all_parameters()
    for p in params:
        vals = runner.replica_values(p.name)
        if not all(torch.equal(v, vals[0]) for v in vals[1:]):
            raise AssertionError(f"dp path: replicas differ on {p.name}")
    plan = prog._quant_allreduce_plan
    timed = np.asarray(secs[DP_WARMUP:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    path = dict(
        model="BertConfig.base(vocab_size=30528)", replicas=n,
        places="[CUDAPlace(0)] x 4", global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, dtype_policy="bf16", steps=DP_STEPS,
        warmup_steps=DP_WARMUP, losses=losses,
        fused_adam_quant_grad_ops=n_fused,
        plain_adam_ops=sum(op.type == "adam"
                           for op in prog.global_block().ops),
        parameters=len(params),
        parameter_elements=int(sum(int(np.prod(p.shape)) for p in params)),
        buckets=[[b["elements"], b["algo"], b["fused_update"]]
                 for b in plan["buckets"]],
        modeled_wire_bytes_per_step=prog._collective_bytes_per_step,
        fused_update_bytes_saved_per_step=prog._fused_update_bytes_saved,
        pt_fused_update_bytes_saved_total=_counter_value(
            "pt_fused_update_bytes_saved_total") - saved0,
        tokens_per_s=tokens * DP_STEPS / float(timed.sum()),
        tokens_per_s_note=("global tokens a step over the host-clock step; "
                           "four replicas share one card, so this is not a "
                           "scaling figure"),
        step_p50_ms=1e3 * float(np.percentile(timed, 50)),
        step_p95_ms=1e3 * float(np.percentile(timed, 95)),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        replicas_bit_identical=True, launches=launches)
    return (exe, compiled, scope, feed, loss, n_fused), path


def profile_dp_step(state):
    """One data-parallel step under torch.profiler: device busy and
    idle, the top kernels, and K8's summed device time against its
    bound (every fused op's bytes, every replica, at the HBM rate)."""
    exe, compiled, scope, feed, loss, _ = state
    out = _profile(lambda: exe.run(compiled, feed=feed, fetch_list=[loss],
                                   scope=scope), 1,
                   match="fused_update_kernel")
    t0 = time.perf_counter()
    exe.run(compiled, feed=feed, fetch_list=[loss], scope=scope)
    out["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    if out["device_busy_ms"]:
        out["device_idle_share"] = 1 - out["device_busy_ms"] \
            / out["wall_profiled_ms"]
    prog = compiled._dp_runner.program
    byts = sum(_k8_bytes("adam", int(op.attrs["numel"]))
               for op in prog.global_block().ops
               if op.type == "fused_adam_quant_grad") * DP_REPLICAS
    out["k8_bound_ms_per_step"] = _bound(byts, 0)[0]
    out["k8_bytes_per_step"] = byts
    return out


def _dp_parity_run(cfg, place, feed, init):
    """DP_PARITY_STEPS steps over DP_REPLICAS replicas on ``place`` from
    the parameters ``init`` (None: the startup's, returned).  Returns the
    losses, ``init`` and {param: (param, Moment1, Moment2)} after the
    run, read from the fused adam ops, with the ops' beta2."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss = _bert_program(cfg, bf16=False)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if init is None:
        init = {p.name: scope.get(p.name).cpu().numpy().copy()
                for p in main.all_parameters()}
    else:
        convert.load_params(scope, init, place, program=main)
    compiled = _dp_compiled(main, loss, [place] * DP_REPLICAS)
    losses = [exe.run(compiled, feed=feed, fetch_list=[loss],
                      scope=scope)[0].tolist()
              for _ in range(DP_PARITY_STEPS)]
    ops = [op for op in compiled._dp_runner.program.global_block().ops
           if op.type == "fused_adam_quant_grad"]
    state = {op.inputs["Param"][0]: tuple(
        scope.get(op.inputs[slot][0]).cpu().numpy().astype(np.float64)
        for slot in ("Param", "Moment1", "Moment2")) for op in ops}
    return losses, init, state, float(ops[0].attrs["beta2"])


def _dp_leaf_readings(init, gpu, cpu, beta2):
    """Per leaf: the reference gradient's bias-corrected RMS (from the
    CPU Moment2) against the median leaf's, and, card against CPU, the
    relative norms of the Moment1, Moment2 and parameter-change
    differences and the parameter's max abs difference."""
    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    g_rms = {n: float(np.sqrt(cpu[n][2].mean()
                              / (1 - beta2 ** DP_PARITY_STEPS)))
             for n in cpu}
    median = float(np.median(list(g_rms.values())))
    out = {}
    for n, (p, m1, m2) in gpu.items():
        p0 = init[n].astype(np.float64)
        out[n] = dict(grad_rms_to_median=g_rms[n] / median,
                      held=g_rms[n] >= DP_GRAD_FLOOR * median,
                      moment1_rel=rel(m1, cpu[n][1]),
                      moment2_rel=rel(m2, cpu[n][2]),
                      change_rel=rel(p - p0, cpu[n][0] - p0),
                      param_max_abs=float(np.abs(p - cpu[n][0]).max()))
    return out


def run_dp_parity():
    """Full width, 2 layers, b8 s128, fp32, dropout 0: 3 steps over four
    replicas on the card and over four CPUPlace replicas (the plain
    versions) from the same parameters; the losses, and each leaf's
    moments and parameter change above the rounding floor (see
    DP_GRAD_FLOOR)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    feed = _dp_feed(cfg, 8, 128, seed=1)
    gl, init, gpu, beta2 = _dp_parity_run(cfg, _gpu_place(), feed, None)
    cl, _, cpu, _ = _dp_parity_run(cfg, fluid.CPUPlace(), feed, init)
    gl, cl = np.asarray(gl), np.asarray(cl)
    rel = float(np.abs(gl - cl).max() / np.abs(cl).min())
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"dp parity: losses {gl.tolist()} (card) vs "
                             f"{cl.tolist()} (CPU), max rel diff {rel}")
    leaves = _dp_leaf_readings(init, gpu, cpu, beta2)
    held = {n: r for n, r in leaves.items() if r["held"]}
    worst = {}
    for key, tol in (("moment1_rel", DP_MOMENT_RTOL),
                     ("moment2_rel", DP_MOMENT_RTOL),
                     ("change_rel", DP_PARAM_RTOL)):
        name = max(held, key=lambda n: held[n][key])
        worst[key] = dict(leaf=name, **held[name])
        if not held[name][key] <= tol:
            raise AssertionError(f"dp parity: {key} {held[name][key]} > "
                                 f"{tol} on leaf {name}: {held[name]}")
    floor = {n: r for n, r in leaves.items() if not r["held"]}
    return dict(replicas=DP_REPLICAS, losses_gpu=gl.tolist(),
                losses_cpu=cl.tolist(), loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, leaves=len(leaves),
                leaves_held=len(held), worst_held=worst,
                rtol=dict(moments=DP_MOMENT_RTOL, change=DP_PARAM_RTOL),
                floor_leaves=floor, grad_floor_to_median=DP_GRAD_FLOOR,
                least_held_grad_to_median=min(
                    r["grad_rms_to_median"] for r in held.values()),
                param_max_abs_diff=max(r["param_max_abs"]
                                       for r in leaves.values()))


# ---------------------------------------------------------------------------
# phases 6-7: the decode lane at full width, and its CPU parity
# ---------------------------------------------------------------------------


class Lane:
    """The decode lane's two programs run directly on one executor, for
    the parity checks: prefill a token list through pages 1.., then
    decode steps, returning logprobs."""

    def __init__(self, cfg, place, scope, pool_slots, page_size, max_len,
                 chunk, pool_dtype="float32"):
        from paddle_tpu_torch import fluid
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.serving.kv_pool import KVPool

        self.cfg, self.scope, self.chunk = cfg, scope, chunk
        self.page_size = page_size
        self.max_pages = max_len // page_size
        num_pages = pool_slots * self.max_pages + 1
        self.pool_slots = pool_slots
        self.exe = fluid.Executor(place)
        KVPool(cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
               num_pages, page_size, self.max_pages,
               dtype=pool_dtype).install(scope, self.exe.device)
        self.pf, self.dec = fluid.Program(), fluid.Program()
        with fluid.program_guard(self.pf, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, lp = gpt.build_gpt_prefill_chunk(
                cfg, chunk, num_pages, page_size, self.max_pages,
                pool_dtype=pool_dtype)
        self.pf_logp = lp.name
        with fluid.program_guard(self.dec, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, lp = gpt.build_gpt_decode_step(
                cfg, pool_slots, num_pages, page_size, self.max_pages,
                pool_dtype=pool_dtype)
        self.dec_logp = lp.name

    def table(self, n_tokens):
        row = np.zeros(self.max_pages, np.int32)
        used = -(-n_tokens // self.page_size)
        row[:used] = np.arange(1, used + 1)
        return row

    def prefill(self, tokens):
        """Logprobs after each chunk of `tokens` (pages 1, 2, ...)."""
        out, c, pgs = [], self.chunk, self.page_size
        table = self.table(len(tokens))
        for s in range(0, len(tokens), c):
            valid = min(c, len(tokens) - s)
            tok = np.zeros((1, c), np.int64)
            tok[0, :valid] = tokens[s:s + valid]
            wp = np.zeros(c // pgs, np.int32)
            for j in range(c // pgs):
                if s + j * pgs < s + valid:
                    wp[j] = table[(s + j * pgs) // pgs]
            feed = {"pf_tok": tok,
                    "pf_pos": np.minimum(s + np.arange(c), 1023)[None, :]
                    .astype(np.int64),
                    "pf_page_table": table[None, :],
                    "pf_write_pages": wp,
                    "pf_qstart": np.asarray([s], np.int32),
                    "pf_last_idx": np.asarray([valid - 1], np.int64)}
            (lp,) = self.exe.run(self.pf, feed=feed,
                                 fetch_list=[self.pf_logp], scope=self.scope)
            out.append(lp[0])
        return out

    def decode(self, token, pos):
        """Logprobs of one decode step with slot 0 active at `pos`."""
        ps = self.pool_slots
        table = np.zeros((ps, self.max_pages), np.int32)
        table[0] = self.table(pos + 1)
        feed = {"dec_tok": np.zeros((ps, 1), np.int64),
                "dec_pos": np.zeros((ps, 1), np.int64),
                "dec_page_table": table,
                "dec_write_page": np.zeros(ps, np.int32),
                "dec_write_off": np.zeros(ps, np.int32)}
        feed["dec_tok"][0, 0] = token
        feed["dec_pos"][0, 0] = pos
        feed["dec_write_page"][0] = table[0, pos // self.page_size]
        feed["dec_write_off"][0] = pos % self.page_size
        (lp,) = self.exe.run(self.dec, feed=feed, fetch_list=[self.dec_logp],
                             scope=self.scope)
        return lp[0]


def _param_names(cfg):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 1, 2, 16, 1)
    return main, [p.name for p in main.all_parameters()]


def run_path(dev, counters, pool_dtype="float32"):
    """The decode lane at full width over a ``pool_dtype`` KV pool.
    ``counters`` maps each kernel the run reads to the launches it must
    make per layer per program run (1 on the path, 0 off it)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)

    eng = DecodeEngine(cfg, scope=scope, place=_gpu_place(),
                       pool_slots=8, page_size=16, max_len=1024,
                       pool_dtype=pool_dtype, name=f"smoke-{pool_dtype}",
                       auto_start=False)
    eng.warmup()
    rng = np.random.RandomState(SEED)
    lens = [8, 512] + list(rng.randint(8, 513, 14))
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    for w, _ in counters.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.start()
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    outs = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, (w, _) in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = eng.stats()
    eng.close()
    if any(len(o) != 32 for o in outs):
        raise AssertionError(f"wrong token counts {[len(o) for o in outs]}")
    runs = stats["prefill_chunks"] + stats["steps"]
    for k, got in launches.items():
        want = counters[k][1] * cfg.num_layers * runs
        if got != want:
            raise AssertionError(
                f"{k}: {got} launches, expected {counters[k][1]} x "
                f"{cfg.num_layers} x {runs} program runs = {want}")
    gen = sum(len(o) for o in outs)
    path = dict(pool_dtype=pool_dtype,
                pool_bytes=eng.pool.modeled_bytes(),
                requests=len(prompts), prompt_tokens=int(sum(lens)),
                generated_tokens=gen, wall_s=wall,
                generated_tokens_per_s=gen / wall,
                total_tokens_per_s=(gen + sum(lens)) / wall,
                prefill_chunks=stats["prefill_chunks"],
                decode_steps=stats["steps"],
                decode_step_p50_ms=1e3 * float(np.median(eng.step_seconds)),
                prefill_chunk_p50_ms=1e3 * float(
                    np.median(eng.prefill_seconds)),
                evictions=stats["evictions"], peak_memory_gb=peak_gb,
                launches=launches)
    return cfg, scope, prompts, outs, path


def profile_decode_step(cfg, scope, steps=5, pool_dtype="float32"):
    """Host wall time vs summed device kernel time of decode steps
    (torch.profiler): slot 0 active at positions 65-69, the other seven
    slots on the trash page."""
    lane = Lane(cfg, _gpu_place(), _copy_scope(scope), 8, 16, 1024, 32,
                pool_dtype)
    lane.prefill(list(range(1, 65)))
    lane.decode(5, 64)
    pos = iter(range(65, 65 + 2 * steps))
    out = _profile(lambda: lane.decode(5, next(pos)), steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lane.decode(5, next(pos))
    torch.cuda.synchronize()
    out["step_wall_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    return out


def _copy_scope(scope):
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        if not n.startswith("@KVPOOL@"):
            out.set(n, scope.get(n))
    return out


def run_parity(cfg, scope, prompts, outs, pool_dtype="float32"):
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.serving import DecodeEngine

    main, names = _param_names(cfg)
    cpu_scope = fluid.Scope()
    convert.load_params(cpu_scope,
                        {n: scope.get(n).cpu().numpy() for n in names},
                        fluid.CPUPlace(), program=main)
    rng = np.random.RandomState(SEED + 1)
    tokens = rng.randint(1, cfg.vocab_size, 40).tolist()
    lanes = {"gpu": Lane(cfg, _gpu_place(), _copy_scope(scope), 2, 16,
                         1024, 32, pool_dtype),
             "cpu": Lane(cfg, fluid.CPUPlace(), cpu_scope, 2, 16, 1024, 32,
                         pool_dtype)}
    res = {}
    for k, lane in lanes.items():
        chunks = lane.prefill(tokens)
        nxt = int(np.argmax(chunks[-1]))
        res[k] = chunks + [lane.decode(nxt, len(tokens))]
    logp_err = max(float(np.abs(a - b).max())
                   for a, b in zip(res["gpu"], res["cpu"]))
    if not logp_err < PATH_LOGP_ATOL:
        raise AssertionError(f"card vs CPU logprobs: max abs err {logp_err} "
                             f">= {PATH_LOGP_ATOL}")

    # greedy ids of the two shortest requests, card vs CPU
    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
    eng = DecodeEngine(cfg, scope=cpu_scope, place=fluid.CPUPlace(),
                       pool_slots=2, page_size=16, max_len=1024,
                       pool_dtype=pool_dtype, name="cpu-parity")
    try:
        cpu_outs = eng.generate([prompts[i] for i in order],
                                max_new_tokens=32, timeout=900)
    finally:
        eng.close()
    cpu_lane = lanes["cpu"]
    ids = []
    for i, cpu_ids in zip(order, cpu_outs):
        gpu_ids = outs[i]
        k = next((j for j, (a, b) in enumerate(zip(gpu_ids, cpu_ids))
                  if a != b), None)
        entry = dict(request=i, prompt_tokens=len(prompts[i]),
                     first_mismatch=k)
        if k is not None:
            # allowed only at a near-tie: the CPU's top-two gap there must
            # be below the logprob tolerance
            lp = cpu_lane.prefill(prompts[i] + gpu_ids[:k])[-1]
            top2 = np.sort(lp)[-2:]
            gap = float(top2[1] - top2[0])
            entry["top2_gap"] = gap
            if not gap < PATH_LOGP_ATOL:
                raise AssertionError(
                    f"request {i}: greedy ids differ at step {k} with a "
                    f"top-two gap {gap} >= {PATH_LOGP_ATOL}")
        ids.append(entry)
    return dict(pool_dtype=pool_dtype, logprob_max_abs_err=logp_err,
                logprob_atol=PATH_LOGP_ATOL, greedy=ids)


# ---------------------------------------------------------------------------
# phases 10-11: the ragged serving.Engine lane over a saved inference
# model, both arms, and its CPU parity (phases 8-9 are phases 6-7 over
# the int8 pool)
# ---------------------------------------------------------------------------

# the repo's ragged-serving model at its "base" size (bench.py :985-1017)
RAGGED_VOCAB, RAGGED_HIDDEN, RAGGED_HEADS, RAGGED_LAYERS = 8192, 256, 8, 4
RAGGED_SEQ_BUCKETS = [32, 64, 128]
RAGGED_WAVE = (20, 50, 90, 126)  # two requests of each length a wave
RAGGED_BATCH = 2 * len(RAGGED_WAVE)
RAGGED_WAVES = 10
# card vs CPU scores: 4 layers of fp32 products summed in other orders
RAGGED_SCORE_ATOL = 1e-4


def save_ragged_model(dirname):
    """Build the ragged scorer with the port's front end (ids [-1, -1]
    int64, lens [-1] int32; a causal ragged_attention per layer), give it
    seeded random weights and save it with save_inference_model."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers as L

    head_dim = RAGGED_HIDDEN // RAGGED_HEADS
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [-1, -1], False, dtype="int64")
        lens = fluid.data("lens", [-1], False, dtype="int32")
        x = L.embedding(ids, size=[RAGGED_VOCAB, RAGGED_HIDDEN])
        for _ in range(RAGGED_LAYERS):
            qkv = [L.reshape(L.fc(x, size=RAGGED_HIDDEN, num_flatten_dims=2),
                             shape=[0, 0, RAGGED_HEADS, head_dim])
                   for _ in range(3)]
            q, k, v = [L.transpose(t, perm=[0, 2, 1, 3]) for t in qkv]
            ctx = L.ragged_attention(q, k, v, lens, causal=True)
            ctx = L.reshape(L.transpose(ctx, perm=[0, 2, 1, 3]),
                            shape=[0, 0, RAGGED_HIDDEN])
            x = L.elementwise_add(x, L.fc(ctx, size=RAGGED_HIDDEN,
                                          num_flatten_dims=2))
        score = L.reshape(L.reduce_mean(x, dim=[1, 2]), shape=[-1, 1])
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["ids", "lens"], [score], exe,
                                  main_program=main, scope=scope)
    return score.name


def ragged_waves(n_waves):
    """The traffic: waves of two requests of each RAGGED_WAVE length,
    seeded; the first wave primes."""
    rng = np.random.RandomState(SEED + 2)
    return [[{"ids": rng.randint(1, RAGGED_VOCAB, (1, ln)).astype(np.int64),
              "lens": np.full((1,), ln, np.int32)}
             for ln in RAGGED_WAVE for _ in range(2)]
            for _ in range(n_waves)]


def _serve_rows(model, kind):
    from paddle_tpu_torch.observability import metrics

    fam = metrics.snapshot().get("pt_serve_rows_total")
    return fam["samples"].get((model, kind), 0.0) if fam else 0.0


def run_ragged_arm(model_dir, fetch, ragged, place, waves, counter=None):
    """One Engine arm serving ``waves`` (the first primes).  Returns the
    served scores of every request and the arm's figures; with a
    ``counter`` (K6's wrapper) its launches are zeroed before the arm
    and must equal 4 x the batches the arm executed, warmup included."""
    from paddle_tpu_torch import serving

    name = "ragged" if ragged else "bucketed"
    if counter is not None:
        counter.launches = 0
    eng = serving.Engine(batch_buckets=[RAGGED_BATCH],
                         seq_buckets=RAGGED_SEQ_BUCKETS, max_wait_ms=5,
                         auto_start=False, name=f"smoke_{name}", place=place)
    try:
        eng.load_model(name, model_dir, ragged=ragged)
        warmed = eng.warmup()[name]
        eng.start()

        def wave(feeds):
            futs = [eng.submit(name, f) for f in feeds]
            return [float(f.result(timeout=300)[fetch].reshape(-1)[0])
                    for f in futs]

        def cold():
            return eng.stats()["models"][name]["executable_cache"]["cold"]

        scores = [wave(waves[0])]
        pad0, real0 = _serve_rows(name, "padding"), _serve_rows(name, "real")
        cold0 = cold()
        t0 = time.perf_counter()
        for feeds in waves[1:]:
            scores.append(wave(feeds))
        dt = time.perf_counter() - t0
        timed = len(waves) - 1
        arm = dict(arm=name, warmed_shapes=warmed,
                   real_tokens_per_s=timed * 2 * sum(RAGGED_WAVE) / dt,
                   timed_waves=timed, wall_s=dt,
                   real_rows=int(_serve_rows(name, "real") - real0),
                   padding_rows=int(_serve_rows(name, "padding") - pad0),
                   steady_state_cold=int(cold() - cold0))
        prof = None
        if counter is not None:  # one more wave, under the profiler
            prof = _profile(lambda: wave(waves[1]), 1)
            if prof["device_busy_ms"]:
                prof["device_idle_share"] = (1 - prof["device_busy_ms"]
                                             / prof["wall_profiled_ms"])
        stats = eng.stats()["models"][name]
    finally:
        eng.close()
    arm.update(batches=stats["batches"],
               warmup_batches=stats["warmup_batches"],
               executable_cache=stats["executable_cache"])
    if counter is not None:
        arm["launches"] = counter.launches
        executed = stats["batches"] + stats["warmup_batches"]
        if counter.launches != RAGGED_LAYERS * executed:
            raise AssertionError(
                f"{name} arm: ragged_attention launched {counter.launches} "
                f"times, expected {RAGGED_LAYERS} x {executed} batches")
        arm["profile_one_wave"] = prof
    return scores, arm


def run_ragged_path(counter):
    """Both arms on the card, then each against a CPUPlace engine on the
    same saved model and requests."""
    import tempfile

    from paddle_tpu_torch import fluid

    waves = ragged_waves(1 + RAGGED_WAVES)
    arms, parity = {}, {}
    with tempfile.TemporaryDirectory(prefix="pt_ragged_model_") as d:
        fetch = save_ragged_model(d)
        for ragged in (True, False):
            scores, arm = run_ragged_arm(d, fetch, ragged, _gpu_place(),
                                         waves, counter)
            name = arm["arm"]
            if not np.isfinite(scores).all():
                raise AssertionError(f"{name} arm: non-finite scores")
            if ragged and (arm["warmed_shapes"] != 1
                           or arm["steady_state_cold"] != 0
                           or arm["padding_rows"] != 0):
                raise AssertionError(f"ragged arm: {arm}")
            arms[name] = arm
            cpu_scores, _ = run_ragged_arm(d, fetch, ragged,
                                           fluid.CPUPlace(), waves[:1])
            err = float(np.abs(np.asarray(scores[0])
                               - np.asarray(cpu_scores[0])).max())
            if not err < RAGGED_SCORE_ATOL:
                raise AssertionError(f"{name} arm: card vs CPU scores differ "
                                     f"by {err} >= {RAGGED_SCORE_ATOL}")
            parity[name] = dict(score_max_abs_err=err,
                                atol=RAGGED_SCORE_ATOL,
                                requests=len(scores[0]))
    return arms, parity


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    from paddle_tpu_torch.kernels import _build, kernel_wrappers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"{json.dumps({k: round(v, 2) for k, v in took.items()})}",
          flush=True)
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    rng = np.random.RandomState(SEED)
    k5_err, k5_t = check_paged(dev, rng)
    k4_err, k4_t = check_bias_gelu(dev, rng)
    k4b_err, k4b_t = check_bias_gelu_bf16(dev, rng)
    fl_err, fl_t = check_flash(dev, rng)
    k6_err, k6_t = check_ragged(dev, rng)
    k7_err, k7_t = check_paged_quant(dev, rng)
    k8_err, k8_t = check_fused_update(dev, rng)
    print("kernel timings " + json.dumps({
        "paged_attention": k5_t, "fused_bias_act": {**k4_t, **k4b_t},
        "flash": fl_t, "ragged_attention": k6_t,
        "paged_attention_quant": k7_t, "fused_update": k8_t,
        "card": smi}), flush=True)

    wrappers = kernel_wrappers()
    train_kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "fused_bias_act")
    state, train = run_train_path({k: wrappers[k] for k in train_kernels})
    print("train path " + json.dumps({"card": smi, **train}), flush=True)
    print("train step " + json.dumps(profile_train_step(state)), flush=True)
    del state
    torch.cuda.empty_cache()
    print("train parity " + json.dumps(run_train_parity()), flush=True)

    decode_kernels = ("fused_bias_act", "paged_attention")
    cfg, scope, prompts, outs, path = run_path(
        dev, {k: (wrappers[k], 1) for k in decode_kernels})
    print("decode path " + json.dumps({"card": smi, **path}), flush=True)
    prof = profile_decode_step(cfg, scope)
    print("decode step " + json.dumps(prof), flush=True)
    parity = run_parity(cfg, scope, prompts, outs)
    print("decode parity " + json.dumps(parity), flush=True)
    del scope
    torch.cuda.empty_cache()

    # the int8 KV pool: K4 and K7 once a layer per program run, K5 never
    int8_counts = {"fused_bias_act": 1, "paged_attention_quant": 1,
                   "paged_attention": 0}
    cfg, scope, prompts, outs, path8 = run_path(
        dev, {k: (wrappers[k], n) for k, n in int8_counts.items()},
        pool_dtype="int8")
    print("int8 decode path " + json.dumps({"card": smi, **path8}),
          flush=True)
    print("int8 decode step " + json.dumps(
        profile_decode_step(cfg, scope, pool_dtype="int8")), flush=True)
    print("int8 decode parity " + json.dumps(
        run_parity(cfg, scope, prompts, outs, pool_dtype="int8")),
        flush=True)
    del scope
    torch.cuda.empty_cache()

    arms, ragged_parity = run_ragged_path(wrappers["ragged_attention"])
    print("ragged engine path " + json.dumps({"card": smi, **arms}),
          flush=True)
    print("ragged engine parity " + json.dumps(ragged_parity), flush=True)
    torch.cuda.empty_cache()

    dp_kernels = train_kernels + ("fused_update",)
    state, dp = run_dp_path({k: wrappers[k] for k in dp_kernels})
    print("dp train path " + json.dumps({"card": smi, **dp}), flush=True)
    print("dp train step " + json.dumps(profile_dp_step(state)), flush=True)
    del state
    torch.cuda.empty_cache()
    print("dp train parity " + json.dumps(run_dp_parity()), flush=True)

    dec = k5_t["decode"]
    k4 = k4b_t["[16384,3072] bf16"]
    by_path = {"train": train["launches"], "dp_train": dp["launches"],
               "decode": path["launches"],
               "decode_int8": path8["launches"],
               **{f"engine_{k}": {"ragged_attention": a["launches"]}
                  for k, a in arms.items()}}

    def launches(name):
        return {p: n[name] for p, n in by_path.items() if name in n}

    def row(name, source, replaces, err, t):
        runs = launches(name)
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(runs.values()),
                    launches_by_path=runs, max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"],
                    library_ms=t.get("library_ms"))

    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_py = "paddle_tpu/kernels/primitives/flash.py"
    kernels = [
        row("flash_fwd", flash_src, f"{flash_py}:78", fl_err["flash_fwd"],
            fl_t["flash_fwd"]),
        row("flash_bwd_dq", flash_src, f"{flash_py}:130",
            fl_err["flash_bwd_dq"], fl_t["flash_bwd_dq"]),
        row("flash_bwd_dkv", flash_src, f"{flash_py}:167",
            fl_err["flash_bwd_dkv"], fl_t["flash_bwd_dkv"]),
        row("fused_bias_act", "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "paddle_tpu/kernels/fused_bias_act.py:106", max(k4_err, k4b_err),
            k4),
        row("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/primitives/paged.py:121", k5_err, dec),
        row("ragged_attention", "paddle_tpu_torch/csrc/ragged_attention.cu",
            "paddle_tpu/kernels/primitives/ragged.py:74", k6_err,
            k6_t["path"]),
        row("paged_attention_quant",
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/primitives/paged.py:241", k7_err,
            k7_t["decode"]),
        row("fused_update", "paddle_tpu_torch/csrc/fused_update.cu",
            "paddle_tpu/kernels/fused_update.py:322", k8_err,
            k8_t["word_embedding"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
