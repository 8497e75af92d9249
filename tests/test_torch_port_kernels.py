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
                                "paged_attention", "ragged_attention"]
    paths = [_build._so_path(n) for n in _build.sources()]
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert len(set(paths)) == len(paths)
    a = paths[1]
    assert a == _build._so_path("fused_bias_act")  # stable
