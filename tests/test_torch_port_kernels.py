"""The port's two kernels (K4 fused bias+GeLU, K5 paged attention) against
the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
here against the JAX oracles — the XLA reference and the Pallas kernel
in interpret mode — on the same seeded numpy inputs.  The CUDA kernels
themselves run only on a GPU: tests/test_torch_port_cuda.py holds them
against the plain versions there, and ``python3 chip_smoke.py`` does the
same at the decode lane's full-width shapes.

Tolerances: K5 1e-5 (fp32, the oracles sum keys in another order); K4
1e-6 (the same elementwise formula; erfc/tanh may differ by an ulp).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.kernels import fused_bias_act as jfba
from paddle_tpu.kernels.primitives import paged as jpaged

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_bias_act as tfba
from paddle_tpu_torch.kernels.primitives import paged as tpaged

K5_TOL = 1e-5
K4_TOL = 1e-6


# ---------------------------------------------------------------------------
# K5 paged attention
# ---------------------------------------------------------------------------

PGS, MAXP, NPAGES, N, D = 4, 4, 13, 2, 16

# q_start cases: start of the pool, a page boundary, mid-page, and the
# last query at the last position of a full page table
Q_STARTS = {"zero": 0, "page_boundary": PGS, "mid_page": PGS + 2,
            "full_length": None}


def _paged_case(t, start, seed=0):
    rng = np.random.RandomState(seed)
    b = 3
    if start is None:
        start = MAXP * PGS - t
    q = rng.randn(b, N, t, D).astype(np.float32)
    kp = rng.randn(NPAGES, PGS, N, D).astype(np.float32)
    vp = rng.randn(NPAGES, PGS, N, D).astype(np.float32)
    pages = rng.permutation(np.arange(1, NPAGES))
    table = np.zeros((b, MAXP), np.int32)
    q_start = np.array([start, max(start - 1, 0), min(start + 1,
                                                       MAXP * PGS - t)],
                       np.int32)
    for r in range(b):
        live = (q_start[r] + t - 1) // PGS + 1
        table[r, :live] = pages[r * MAXP:r * MAXP + live]
    return q, kp, vp, table, q_start


def _port_paged(q, kp, vp, table, q_start, **kw):
    out = tpaged.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(q_start),
        sm_scale=D ** -0.5, **kw)
    return out.numpy()


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("start", sorted(Q_STARTS))
@pytest.mark.parametrize("t", [1, 4])
def test_paged_plain_matches_jax(t, start, oracle):
    case = _paged_case(t, Q_STARTS[start])
    got = _port_paged(*case)
    if oracle == "reference":
        want = jpaged.paged_attention_reference(*case, sm_scale=D ** -0.5)
    else:
        want = jpaged.paged_attention(*case, sm_scale=D ** -0.5,
                                      force="pallas")
    np.testing.assert_allclose(got, np.asarray(want), atol=K5_TOL,
                               rtol=K5_TOL)


def test_paged_never_attends_trash_page():
    """Poisoning page 0 (the trash page) changes nothing: no row's mask
    exposes it."""
    q, kp, vp, table, q_start = _paged_case(4, PGS + 2)
    clean = _port_paged(q, kp, vp, table, q_start)
    kp[0] = 1e4
    vp[0] = -1e4
    np.testing.assert_array_equal(_port_paged(q, kp, vp, table, q_start),
                                  clean)


def test_paged_wrapper_checks():
    q, kp, vp, table, q_start = (torch.from_numpy(a)
                                 for a in _paged_case(1, 0))
    with pytest.raises(ValueError, match="one dtype"):
        tpaged.paged_attention(q, kp, vp.double(), table, q_start)
    with pytest.raises(ValueError, match="page_table"):
        tpaged.paged_attention(q, kp, vp, table[:1], q_start)
    with pytest.raises(ValueError, match="force"):
        tpaged.paged_attention(q, kp, vp, table, q_start, force="pallas")
    launches = tpaged.paged_attention.launches
    ref = tpaged.paged_attention(q, kp, vp, table, q_start,
                                 force="reference")
    assert tpaged.paged_attention.launches == launches  # no kernel on CPU
    assert ref.shape == q.shape


WARPS = 8  # the warps of K5's CTA, as its library reports them


@pytest.mark.parametrize("max_pages,page_size", [
    (1, 16), (8, 16), (9, 16), (64, 16), (64, 32), (40, 4), (33, 1)])
@pytest.mark.parametrize("b,n,t,d", [(8, 12, 1, 64), (1, 3, 32, 6)])
def test_paged_split_plan_covers_every_page_once(b, n, t, d, max_pages,
                                                 page_size):
    """K5's split plan, from shapes alone: its chunks cover each logical
    page exactly once, and the partials workspace is [B, n, T, splits,
    d + 2] fp32 with B * n * T arrival counters when there is more than
    one chunk, else none."""
    plan = tpaged.split_plan(b, n, t, d, max_pages, page_size, WARPS)
    assert plan == tpaged.split_plan(b, n, t, d, max_pages, page_size,
                                     WARPS)
    chunks = [_split_pages(plan, s, max_pages) for s in range(plan.splits)]
    assert [p for c in chunks for p in c] == list(range(max_pages))
    assert all(chunks)  # no chunk is empty
    assert plan.pages_per_split % WARPS == 0  # whole pages for each warp
    if plan.splits == 1:
        assert plan.workspace is None and plan.arrivals == 0
    else:
        assert plan.workspace == (b, n, t, plan.splits, d + 2)
        assert plan.arrivals == b * n * t
    if page_size == 16:  # one page a warp: 8 pages a split
        assert plan.pages_per_split == 8


def _split_pages(plan, split, max_pages):
    """The logical pages chunk ``split`` covers, as the kernel's CTA
    takes them: [split * pages_per_split, + pages_per_split) within the
    page table."""
    first = split * plan.pages_per_split
    return list(range(first, min(first + plan.pages_per_split, max_pages)))


class _FakeLib:
    """Stands in for the built library: a CTA of ``warps`` warps, and
    each launch's arguments recorded."""

    def __init__(self, warps):
        self.warps = warps
        self.calls = []

    def pt_paged_warps(self):
        return self.warps

    def pt_paged_attention_f32(self, *args):
        self.calls.append(args)
        return 0


def test_paged_wrapper_passes_the_shape_plan(monkeypatch):
    """The wrapper's kernel branch, driven on CPU tensors with the build
    stubbed (each pointer argument is handed over as its tensor): it
    plans with the library's warps, hands the kernel the plan's numbers,
    a workspace of the plan's shape and zeroed arrival counters, the same
    plan for other q_start and page-table values (nothing read from the
    tensors' values), and the same counters for the next launch in the
    stream."""
    lib = _FakeLib(warps=4)
    monkeypatch.setattr(tpaged, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_of",
                        lambda dev: ctypes.c_void_p(1234))
    monkeypatch.setattr(tpaged, "_arrivals", {})
    rng = np.random.RandomState(0)
    b, n, t, d, pgs, maxp = 2, 3, 1, 16, 16, 64
    q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32))
    pool = torch.zeros(2 * maxp + 1, pgs, n, d)
    plan = tpaged.split_plan(b, n, t, d, maxp, pgs, 4)
    assert (plan.pages_per_split, plan.splits) == (4, 16)
    before = tpaged.paged_attention.launches
    for starts in ([0, 5], [1023, 700]):
        table = torch.from_numpy(rng.randint(1, 2 * maxp + 1, (b, maxp))
                                 .astype(np.int32))
        tpaged.paged_attention(q, pool, pool, table,
                               torch.tensor(starts, dtype=torch.int32))
    assert tpaged.paged_attention.launches == before + 2
    for part, arrivals, *ints in (c[6:17] for c in lib.calls):
        assert part.shape == plan.workspace and part.dtype == torch.float32
        assert arrivals.dtype == torch.int32
        assert arrivals.numel() >= plan.arrivals and not arrivals.any()
        assert tuple(ints) == (b, n, t, d, pgs, maxp, 2 * maxp + 1,
                               plan.pages_per_split, plan.splits)
    assert lib.calls[0][7] is lib.calls[1][7]  # one set for the stream
    # one split: null workspace and counters
    lib.calls.clear()
    small = torch.zeros(5, pgs, n, d)
    one = tpaged.split_plan(b, n, t, d, 2, pgs, 4)
    tpaged.paged_attention(q, small, small,
                           torch.ones(b, 2, dtype=torch.int32),
                           torch.zeros(b, dtype=torch.int32))
    assert one.splits == 1 and one.workspace is None
    assert lib.calls[0][6:8] == (None, None)
    assert lib.calls[0][15:17] == (one.pages_per_split, 1)


def test_paged_cpu_wrapper_takes_plain_version_without_a_plan(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no split plan,
    no workspace, no build, no launch counted."""
    def boom(*a, **kw):
        raise AssertionError("the kernel branch ran on CPU tensors")

    monkeypatch.setattr(tpaged, "split_plan", boom)
    monkeypatch.setattr(_build, "load", boom)
    q, kp, vp, table, q_start = (torch.from_numpy(a)
                                 for a in _paged_case(1, PGS + 2))
    launches = tpaged.paged_attention.launches
    out = tpaged.paged_attention(q, kp, vp, table, q_start,
                                 sm_scale=D ** -0.5)
    assert tpaged.paged_attention.launches == launches
    np.testing.assert_array_equal(out.numpy(), _port_paged(
        *(a.numpy() for a in (q, kp, vp, table, q_start)),
        force="reference"))


@pytest.mark.parametrize("t", [1, 3])
def test_paged_plain_at_split_shapes_matches_jax(t):
    """The port's plain K5, which the card's tests hold the split form
    against, matches the JAX package's paged_attention_reference where
    the split form splits (40 pages of 4: two splits of 32 pages), with
    rows that end in the first split, on the split boundary and in the
    second."""
    rng = np.random.RandomState(t)
    b, n, d, pgs, maxp = 4, 2, 16, 4, 40
    npages = b * maxp + 1
    q = rng.randn(b, n, t, d).astype(np.float32)
    kp = rng.randn(npages, pgs, n, d).astype(np.float32)
    vp = rng.randn(npages, pgs, n, d).astype(np.float32)
    q_start = np.array([0, 127 - (t - 1), 128, 160 - t], np.int32)
    table = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, npages))
    for r in range(b):
        live = (q_start[r] + t - 1) // pgs + 1
        table[r, :live] = perm[r * maxp:r * maxp + live]
    assert tpaged.split_plan(b, n, t, d, maxp, pgs, WARPS).splits == 2
    got = _port_paged(q, kp, vp, table, q_start)
    want = jpaged.paged_attention_reference(q, kp, vp, table, q_start,
                                            sm_scale=D ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), atol=K5_TOL,
                               rtol=K5_TOL)


# ---------------------------------------------------------------------------
# K4 fused bias + GeLU (+ dropout mask)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("h", [128, 256])
def test_bias_gelu_plain_matches_pallas_interpret(monkeypatch, h,
                                                  approximate, dropout):
    """Held against the JAX Pallas kernel in interpret mode; with
    dropout, the uint8 mask the JAX function drew is fed to the port."""
    monkeypatch.setenv("PT_FUSED_BIAS_ACT_IMPL", "interpret")
    rng = np.random.RandomState(h + 2 * approximate + dropout)
    x = rng.randn(5, 3, h).astype(np.float32) * 3
    bias = rng.randn(h).astype(np.float32)
    p = 0.25 if dropout else 0.0
    want, mask = jfba.fused_bias_gelu_dropout(
        x, bias, dropout_prob=p, approximate=approximate,
        rng_key=jax.random.key(7) if dropout else None)
    tmask = None if mask is None else torch.from_numpy(np.asarray(mask))
    got = tfba.fused_bias_gelu(torch.from_numpy(x), torch.from_numpy(bias),
                               mask=tmask, scale=1.0 / (1.0 - p),
                               approximate=approximate)
    assert (mask is not None) == dropout
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K4_TOL,
                               rtol=K4_TOL)


def test_bias_gelu_ragged_width_plain():
    """The port keeps no H % 128 rule: any width runs (here against the
    JAX XLA branch, which is what the JAX package takes for H = 37)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 37).astype(np.float32)
    bias = rng.randn(37).astype(np.float32)
    want, _ = jfba.fused_bias_gelu_dropout(x, bias)
    got = tfba.fused_bias_gelu(torch.from_numpy(x), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K4_TOL,
                               rtol=K4_TOL)


def test_bias_gelu_wrapper_checks():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="bias"):
        tfba.fused_bias_gelu(x, torch.zeros(7))
    with pytest.raises(TypeError, match="float32"):
        tfba.fused_bias_gelu(x.double(), torch.zeros(8))
    with pytest.raises(ValueError, match="mask"):
        tfba.fused_bias_gelu(x, torch.zeros(8),
                             mask=torch.ones(2, 8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# K0 launch layer
# ---------------------------------------------------------------------------


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed nvcc run raises with the compiler's output; nothing is
    loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build_all(["paged_attention"])
    assert not list(tmp_path.glob("*.so"))


def test_build_names_library_by_source_hash():
    assert _build.sources() == ["flash_attention", "fused_bias_act",
                                "fused_update", "paged_attention",
                                "ragged_attention"]
    paths = [_build._so_path(n) for n in _build.sources()]
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert len(set(paths)) == len(paths)
    a = paths[1]
    assert a == _build._so_path("fused_bias_act")  # stable
