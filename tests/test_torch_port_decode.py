"""The decode serving lane of the PyTorch port against the JAX package's.

A child process (tests/torch_port_jax_oracle.py) trains the tiny GPT of
tests/decode_e2e_checks.py for 30 steps, runs the JAX DecodeEngine and
the two decode-lane programs, and dumps parameters, prompts, greedy ids,
logprobs and post-pass op lists to an npz file.  The port loads the
parameters through ``convert.load_params`` on CPUPlace and must be:

- token-exact with the JAX engine's greedy ids, also under eviction and
  for prompts that stream through several prefill chunks;
- within 1e-4 of the JAX logprobs for two prefill chunks and a decode
  step (fp32; matmuls sum in another order);
- built of the same ops, in the same order, after the graph passes.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch import convert, fluid
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import DecodeEngine, ServingOverloadError

LOGP_ATOL = 1e-4
ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_jax_oracle.py")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / "oracle.npz"
    r = subprocess.run([sys.executable, ORACLE, str(out)],
                       capture_output=True, text=True, timeout=900,
                       cwd=os.path.dirname(os.path.dirname(ORACLE)))
    assert r.returncode == 0 and "TORCH_PORT_ORACLE_OK" in r.stdout, (
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
    arrays = {k[len("param:"):]: v for k, v in oracle.items()
              if k.startswith("param:")}
    convert.load_params(scope, arrays, fluid.CPUPlace(), program=main)
    return cfg, scope


def _generate(oracle, prompts, **kw):
    cfg, scope = _params_scope(oracle)
    slots, page, chunk, max_len = (int(v) for v in oracle["engine"])
    sizing = dict(pool_slots=slots, page_size=page, prefill_chunk=chunk,
                  max_len=max_len)
    eng = DecodeEngine(cfg, scope=scope, place=fluid.CPUPlace(),
                       auto_start=False, **{**sizing, **kw})
    try:
        eng.warmup()
        eng.start()
        return eng.generate([list(p) for p in prompts], max_new_tokens=6,
                            timeout=300), eng.stats()
    finally:
        eng.close()


def test_greedy_ids_token_exact(oracle):
    ids, _ = _generate(oracle, oracle["prompts_base"])
    np.testing.assert_array_equal(np.asarray(ids), oracle["ids_base"])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_chunked_prefill_token_exact(oracle, i):
    """Prompts of 11 and 19 tokens stream through 3 and 5 prefill chunks
    of 4; a 2-token prompt through one padded chunk."""
    ids, _ = _generate(oracle, [oracle[f"prompt_long{i}"]])
    np.testing.assert_array_equal(np.asarray(ids[0]), oracle[f"ids_long{i}"])


def test_eviction_under_pressure_token_exact(oracle):
    ids, stats = _generate(oracle, oracle["prompts_base"], max_len=16,
                           num_pages=6)
    np.testing.assert_array_equal(np.asarray(ids), oracle["evict_ids"])
    np.testing.assert_array_equal(np.asarray(ids), oracle["ids_base"])
    assert stats["evictions"] > 0, "pool never evicted: test is vacuous"
    assert int(oracle["evict_count"]) > 0


def _lane(oracle):
    cfg, scope = _params_scope(oracle)
    lane = dict(zip(("page_size", "max_pages", "num_pages", "chunk",
                     "slots"), (int(v) for v in oracle["lane"])))
    n, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    from paddle_tpu_torch.serving.kv_pool import KVPool

    KVPool(cfg.num_layers, n, d, lane["num_pages"], lane["page_size"],
           lane["max_pages"]).install(scope, "cpu")
    progs = {}
    for name, build in (
            ("prefill", lambda: gpt.build_gpt_prefill_chunk(
                cfg, lane["chunk"], lane["num_pages"], lane["page_size"],
                lane["max_pages"])),
            ("decode", lambda: gpt.build_gpt_decode_step(
                cfg, lane["slots"], lane["num_pages"], lane["page_size"],
                lane["max_pages"]))):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, logp = build()
        progs[name] = (main, logp.name)
    return scope, progs


def _feed(oracle, prefix):
    return {k[len(prefix):]: v for k, v in oracle.items()
            if k.startswith(prefix)}


def test_logprobs_match_jax(oracle):
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
def test_post_pass_op_lists_match_jax(oracle, program):
    scope, progs = _lane(oracle)
    exe = fluid.Executor(fluid.CPUPlace())
    main, fetch = progs[program]
    feed = _feed(oracle, "dec:" if program == "decode" else "pf0:")
    exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)  # passes run
    ops = [op.type for op in main.global_block().ops]
    assert ops == [str(t) for t in oracle[f"ops_{program}"]]
    assert ops.count("fused_bias_act_dropout") == 2  # one per layer
    assert ops.count("paged_attention") == 2


def test_load_params_rejects_mismatch(oracle):
    """The trained parameters load only into a program of their shapes."""
    cfg = gpt.GPTConfig.tiny(num_layers=2, hidden_size=32)
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
    arrays = {k[len("param:"):]: v for k, v in oracle.items()
              if k.startswith("param:")}
    with pytest.raises(ValueError, match="shape"):
        convert.load_params(fluid.Scope(), arrays, fluid.CPUPlace(),
                            program=main)


# ---------------------------------------------------------------------------
# admission: the typed rejections (no oracle needed; random weights)
# ---------------------------------------------------------------------------


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


def test_queue_limit_rejects_typed():
    eng = _random_engine(max_queue=1)
    try:
        eng.submit([1, 2], max_new_tokens=2)
        with pytest.raises(ServingOverloadError) as e:
            eng.submit([3], max_new_tokens=2)
        assert e.value.reason == "overload"
    finally:
        eng.close()


def test_tenant_quota_rejects_typed_per_tenant():
    eng = _random_engine(tenant_quota=1)
    try:
        eng.submit([1, 2], max_new_tokens=2, tenant="a")
        with pytest.raises(ServingOverloadError) as e:
            eng.submit([3], max_new_tokens=2, tenant="a")
        assert e.value.reason == "tenant_quota"
        eng.submit([3], max_new_tokens=2, tenant="b")  # other tenant: ok
    finally:
        eng.close()


def test_closed_engine_rejects_and_fails_pending():
    eng = _random_engine()
    fut = eng.submit([1, 2], max_new_tokens=2)
    eng.close()
    with pytest.raises(ServingOverloadError):
        fut.result(timeout=10)
    with pytest.raises(ServingOverloadError) as e:
        eng.submit([1], max_new_tokens=1)
    assert e.value.reason == "closed"


def test_eos_and_single_token():
    """max_new_tokens=1 finishes on the prefill's token alone; an eos id
    equal to a generated token stops the stream there."""
    eng = _random_engine()
    eng.start()
    try:
        full = eng.generate([[5, 6, 7]], max_new_tokens=6, timeout=60)[0]
        assert len(full) == 6
        assert eng.generate([[5, 6, 7]], max_new_tokens=1,
                            timeout=60)[0] == full[:1]
        stop = eng.generate([[5, 6, 7]], max_new_tokens=6, eos_id=full[2],
                            timeout=60)[0]
        assert stop == full[:full.index(full[2]) + 1]
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the fleet's decode surface: failover, resume, drain (oracle weights)
# ---------------------------------------------------------------------------


def _replica(oracle, name, **kw):
    cfg, scope = _params_scope(oracle)
    slots, page, chunk, max_len = (int(v) for v in oracle["engine"])
    eng = DecodeEngine(cfg, scope=scope, place=fluid.CPUPlace(),
                       pool_slots=slots, page_size=page, prefill_chunk=chunk,
                       max_len=max_len, auto_start=False, name=name,
                       drain_on_sigterm=False, **kw)
    eng.warmup()
    return eng


@pytest.mark.parametrize("kill_after", [1, 3])
def test_failover_drill_token_exact_with_jax(oracle, kill_after):
    """replica_kill lands ``kill_after`` decode steps into the loaded run
    on replica0; the router resumes every victim on replica1 from its
    emitted prefix, and every stream equals the JAX engine's greedy ids.
    The drill also gates the failovers and recovery booked, no new
    executor plan, the SLO page alert fired and cleared, and the trace of
    a failed-over request."""
    from paddle_tpu_torch.serving import drill

    engines = [_replica(oracle, f"replica{i}") for i in range(2)]
    for eng in engines:
        eng.start()
    try:
        prompts = [list(p) for p in oracle["prompts_base"]]
        report = drill.failover_drill(
            engines=engines, prompts=prompts, max_new_tokens=6,
            kill_after=kill_after,
            baseline=oracle["ids_base"].tolist())
    finally:
        for eng in engines:
            eng.close()
    assert report["ok"], report
    assert report["failovers"] > 0 and report["token_exact"]
    spans = report["failed_over_trace"]["spans"]
    assert ("request", "generate", "ok") in spans


@pytest.mark.parametrize("j", [1, 2, 4, 6])
def test_submit_with_prefix_resumes_token_exact(oracle, j):
    """A stream resumed from its first j tokens (re-prefilled prompt +
    prefix[:-1]) equals the JAX engine's uninterrupted one; j = the whole
    budget resolves without a prefill."""
    eng = _replica(oracle, "resume")
    eng.start()
    try:
        reqs = [eng.submit_request(list(p), 6, prefix=list(ids[:j]))
                for p, ids in zip(oracle["prompts_base"], oracle["ids_base"])]
        got = [r.future.result(timeout=120) for r in reqs]
        assert all(r.span is None for r in reqs) == (j == 6)
    finally:
        eng.close()
    np.testing.assert_array_equal(np.asarray(got), oracle["ids_base"])
    with pytest.raises(ValueError, match="prefix"):
        eng.submit_request([1], 2, prefix=[1, 2, 3])


def test_drain_fails_queued_typed_and_finishes_slotted(oracle):
    """drain(): admission stops typed, queued futures fail with reason
    "draining", sequences already in decode slots finish token-exact."""
    eng = _replica(oracle, "drain")
    prompts = [list(p) for p in oracle["prompts_base"]]
    try:
        first = [eng.submit(p, 6) for p in prompts[:2]]
        # drive the scheduler by hand until both hold decode slots
        while eng.stats()["active_slots"] < 2:
            eng._step_once()
        queued = [eng.submit(p, 6) for p in prompts[2:] + prompts[:2]]
        assert eng.drain() is True and not eng.healthy()
        with pytest.raises(ServingOverloadError) as e:
            eng.submit(prompts[0], 6)
        assert e.value.reason == "draining"
        eng.start()
        assert eng.drain(timeout=120) is True
        for f in queued:
            with pytest.raises(ServingOverloadError) as e:
                f.result(timeout=60)
            assert e.value.reason == "draining"
        got = [f.result(timeout=60) for f in first]
        np.testing.assert_array_equal(np.asarray(got),
                                      oracle["ids_base"][:2])
        assert eng.stats()["draining"] and eng.load() == 0
        assert eng.pool.stats()["pages_in_use"] == 0
    finally:
        eng.close()


def test_killed_replica_fails_every_future_and_rejects_typed(oracle):
    """A replica_kill: rule kills the scheduler before the step runs; every
    live future gets the injected death, later submits reject typed
    (scheduler_failed), and close() still works."""
    from paddle_tpu_torch.distributed import fault_injection

    eng = _replica(oracle, "victim")
    fault_injection.install("replica_kill:victim:step:2")
    try:
        futs = [eng.submit(list(p), 6) for p in oracle["prompts_base"]]
        eng.start()
        for f in futs:
            with pytest.raises(fault_injection.InjectedReplicaDeath):
                f.result(timeout=60)
        assert eng.stats()["steps"] == 1 and not eng.healthy()
        with pytest.raises(ServingOverloadError) as e:
            eng.submit([1, 2], 2)
        assert e.value.reason == "scheduler_failed"
    finally:
        fault_injection.uninstall()
        eng.close()
