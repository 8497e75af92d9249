"""GPT generation and the Transformer's while-loop greedy decode through
the PyTorch port, against the JAX package, on the CPU.

GPTConfig.tiny (2 layers) with a 6-token prompt and 4 new tokens: the
three generation programs — ``build_gpt_generate`` (the prefix
recomputed each step), ``build_gpt_generate_cached`` (KV caches, the
steps unrolled) and ``build_gpt_generate_scan`` (fixed-size caches in a
while loop) — at beam 1 and 3, built in both packages from one seed and
run from the JAX startup's weights: ids equal, scores within 1e-5.  The
three builds give the port the same ids, and an end id that a beam
picks freezes it.  The Transformer's ``build_greedy_decode_scan`` gives
the JAX package's ids and the unrolled decode's.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
from importlib import import_module

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import convert

P, G, BATCH = 6, 4, 2
SCORE_RTOL = 1e-5
BUILDS = ("build_gpt_generate", "build_gpt_generate_cached",
          "build_gpt_generate_scan")


def _prompt(vocab, seed=0):
    return np.random.RandomState(seed).randint(
        2, vocab, (BATCH, P)).astype("int64")


def _persistables(startup, scope):
    return {n: np.asarray(scope.get(n))
            for op in startup.global_block().ops
            for n in op.output_arg_names
            if startup.global_block().vars.get(n) is not None
            and startup.global_block().vars[n].persistable}


def _run(pkg, make, feed, init=None):
    """Build ``make(pkg)`` -> (fetch vars), run its startup (then load
    ``init`` into the port's scope) and the program once.  Returns the
    numpy fetches and the startup's persistables."""
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = make(pkg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is not None:
        convert.load_params(scope, init, fluid.CPUPlace())
    out = exe.run(main, feed=feed, fetch_list=[v.name for v in fetch],
                  scope=scope)
    return [np.asarray(o) for o in out], (
        _persistables(startup, scope) if init is None else None)


def _gen(build, beam, end_id=0):
    def make(pkg):
        gpt = import_module(pkg.__name__ + ".models.gpt")
        cfg = gpt.GPTConfig.tiny(num_layers=2)
        _, sent, scores = getattr(gpt, build)(cfg, P, G, beam_size=beam,
                                              end_id=end_id)
        return [sent, scores]
    return make


def _both(make, feed):
    j, init = _run(jpaddle, make, feed)
    t, _ = _run(tpaddle, make, feed, init=init)
    return j, t


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("build", BUILDS)
def test_gpt_generation_matches_jax(build, beam):
    feed = {"gpt_prompt": _prompt(256)}
    (jsent, jsc), (tsent, tsc) = _both(_gen(build, beam), feed)
    assert tsent.shape == (BATCH, beam, G)
    np.testing.assert_array_equal(tsent, jsent)
    np.testing.assert_allclose(tsc, jsc, rtol=SCORE_RTOL, atol=0)
    assert np.all(np.diff(tsc, axis=1) <= 0)   # best first


def test_gpt_generation_builds_agree():
    """On the port, from one start: the recompute, cached and scan
    builds give the same ids."""
    feed = {"gpt_prompt": _prompt(256, seed=1)}
    outs = {}
    init = None
    for build in BUILDS:
        (sent, sc), got = _run(tpaddle, _gen(build, 3), feed, init=init)
        init = init or got
        outs[build] = (sent, sc)
    for build in BUILDS[1:]:
        np.testing.assert_array_equal(outs[build][0], outs[BUILDS[0]][0])
        np.testing.assert_allclose(outs[build][1], outs[BUILDS[0]][1],
                                   rtol=SCORE_RTOL, atol=0)


def test_gpt_end_id_freezes_a_beam():
    """With the end id set to a token the beams pick, a beam that emits
    it emits only it afterwards and keeps its score; the scan build and
    the JAX package's agree on ids and scores."""
    feed = {"gpt_prompt": _prompt(256)}
    (first, _), _ = _run(jpaddle, _gen("build_gpt_generate_scan", 3), feed)
    end_id = int(first[0, 0, 0])
    j, t = _both(_gen("build_gpt_generate_scan", 3, end_id=end_id), feed)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=SCORE_RTOL, atol=0)
    sent = t[0]
    hit = 0
    for b in range(BATCH):
        for k in range(3):
            where = np.flatnonzero(sent[b, k] == end_id)
            if len(where):
                hit += 1
                assert np.all(sent[b, k, where[0]:] == end_id)
    assert hit, sent


def _nmt(scan):
    def make(pkg):
        tr = import_module(pkg.__name__ + ".models.transformer")
        cfg = tr.TransformerConfig.tiny()
        build = tr.build_greedy_decode_scan if scan \
            else tr.build_greedy_decode
        _, out = build(cfg, max_out_len=5)
        return [out]
    return make


def test_transformer_greedy_decode_scan_matches_jax():
    rng = np.random.RandomState(3)
    feed = {"src_ids": rng.randint(2, 64, (3, 7)).astype("int64")}
    (jids,), (tids,) = _both(_nmt(scan=True), feed)
    np.testing.assert_array_equal(tids, jids)
    _, init = _run(jpaddle, _nmt(scan=True), feed)
    (unrolled,), _ = _run(tpaddle, _nmt(scan=False), feed, init=init)
    np.testing.assert_array_equal(tids, unrolled)
