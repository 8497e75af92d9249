"""JAX oracle for tests/test_torch_port_decode.py, run in a child process.

Builds the decode e2e fixture (tests/decode_e2e_checks.py: a tiny GPT
trained 30 steps), runs the JAX package's DecodeEngine and its two
decode-lane programs, and writes everything the PyTorch port is held
against to one npz file:

  param:<name>     every parameter of the decode-step program
  prompts_<k>      prompt sets; ids_<k> the JAX engine's greedy ids
  evict_ids        the 4-prompt set under a pool sized for eviction
  engine           the engine sizing [pool_slots, page_size, chunk, max_len]
  lane             [page_size, max_pages, num_pages, chunk, slots]
  pf<i>:<feed>, pf<i>_logp, dec:<feed>, dec_logp   program feeds/logprobs
  ops_decode, ops_prefill  op types of both programs after the passes

A child process because the decode lane's e2e runs in a fresh process
with the persistent compile cache off (decode_e2e_checks.py explains the
jaxlib heap-corruption workaround); it is also what keeps JAX and the
port's tensors out of one process's allocator history.

    python tests/torch_port_jax_oracle.py OUT.npz
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import decode_e2e_checks as e2e  # noqa: E402  (cpu_mesh first, cache off)

import numpy as np  # noqa: E402

from paddle_tpu import fluid, serving  # noqa: E402
from paddle_tpu.models import gpt  # noqa: E402

ENGINE = dict(pool_slots=4, page_size=4, prefill_chunk=4, max_len=32)
LANE = dict(page_size=4, max_pages=8, num_pages=9, chunk=4, slots=2)


def _generate(cfg, scope, prompts, **kw):
    eng = serving.DecodeEngine(cfg, scope=scope, auto_start=False,
                               **{**ENGINE, **kw})
    try:
        eng.warmup()
        eng.start()
        return eng.generate([list(p) for p in prompts], max_new_tokens=6,
                            timeout=300), eng.stats()
    finally:
        eng.close()


def _lane_programs(cfg):
    progs = {}
    for name, build in (
            ("prefill", lambda: gpt.build_gpt_prefill_chunk(
                cfg, LANE["chunk"], LANE["num_pages"], LANE["page_size"],
                LANE["max_pages"])),
            ("decode", lambda: gpt.build_gpt_decode_step(
                cfg, LANE["slots"], LANE["num_pages"], LANE["page_size"],
                LANE["max_pages"]))):
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start), fluid.unique_name.guard():
            _, tok, logp = build()
        progs[name] = (main, logp.name)
    return progs


def lane_feeds(tokens):
    """Two prefill chunks over `tokens` (7 tokens: 4 + 3 valid) into
    pages 1 and 2, then one decode step of slot 0 at position 7."""
    ps, c, mp = LANE["page_size"], LANE["chunk"], LANE["max_pages"]
    table = np.zeros(mp, np.int32)
    table[:2] = [1, 2]
    feeds = []
    for i, (s, valid) in enumerate(((0, 4), (4, 3))):
        tok = np.zeros((1, c), np.int64)
        tok[0, :valid] = tokens[s:s + valid]
        feeds.append({
            "pf_tok": tok,
            "pf_pos": (s + np.arange(c, dtype=np.int64))[None, :],
            "pf_page_table": table[None, :].copy(),
            "pf_write_pages": np.asarray([i + 1], np.int32),
            "pf_qstart": np.asarray([s], np.int32),
            "pf_last_idx": np.asarray([valid - 1], np.int64)})
    slots = LANE["slots"]
    dec_table = np.zeros((slots, mp), np.int32)
    dec_table[0] = table
    dec = {"dec_tok": np.asarray([[int(tokens[-1])]] + [[0]] * (slots - 1),
                                 np.int64),
           "dec_pos": np.asarray([[7]] + [[0]] * (slots - 1), np.int64),
           "dec_page_table": dec_table,
           "dec_write_page": np.asarray([2] + [0] * (slots - 1), np.int32),
           "dec_write_off": np.asarray([7 % ps] + [0] * (slots - 1),
                                       np.int32)}
    return feeds, dec


def main(out_path):
    cfg, scope, prompts, ref_ids = e2e.build_fixture()
    rng = np.random.RandomState(5)
    long_prompts = [rng.randint(1, cfg.vocab_size, n) for n in (11, 19, 2)]
    res = {"prompts_base": np.asarray(prompts, np.int64)}
    ids, _ = _generate(cfg, scope, prompts)
    res["ids_base"] = np.asarray(ids, np.int64)
    ids, _ = _generate(cfg, scope, long_prompts)
    for i, (p, g) in enumerate(zip(long_prompts, ids)):
        res[f"prompt_long{i}"] = np.asarray(p, np.int64)
        res[f"ids_long{i}"] = np.asarray(g, np.int64)
    ids, stats = _generate(cfg, scope, prompts, max_len=16, num_pages=6)
    res["evict_ids"] = np.asarray(ids, np.int64)
    res["evict_count"] = np.asarray(stats["evictions"])

    progs = _lane_programs(cfg)
    lane_scope = fluid.Scope()
    names = [p.name for p in progs["decode"][0].all_parameters()]
    for n in names:
        lane_scope.set(n, np.asarray(scope.get(n)))
        res[f"param:{n}"] = np.asarray(scope.get(n))
    n, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    for kn, vn in gpt.kv_pool_var_names(cfg.num_layers):
        for nm in (kn, vn):
            lane_scope.set(nm, np.zeros((LANE["num_pages"],
                                         LANE["page_size"], n, d),
                                        np.float32))
    tokens = rng.randint(1, cfg.vocab_size, 7)
    pf_feeds, dec_feed = lane_feeds(tokens)
    for i, feed in enumerate(pf_feeds):
        res.update({f"pf{i}:{k}": v for k, v in feed.items()})
    res.update({f"dec:{k}": v for k, v in dec_feed.items()})
    res["engine"] = np.asarray([ENGINE["pool_slots"], ENGINE["page_size"],
                                ENGINE["prefill_chunk"], ENGINE["max_len"]])
    res["lane"] = np.asarray([LANE[k] for k in ("page_size", "max_pages",
                                                "num_pages", "chunk",
                                                "slots")])
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(lane_scope):
        for i, feed in enumerate(pf_feeds):
            (lp,) = exe.run(progs["prefill"][0], feed=feed,
                            fetch_list=[progs["prefill"][1]])
            res[f"pf{i}_logp"] = np.asarray(lp)
        (lp,) = exe.run(progs["decode"][0], feed=dec_feed,
                        fetch_list=[progs["decode"][1]])
        res["dec_logp"] = np.asarray(lp)
    for key, (prog, _) in progs.items():
        res[f"ops_{key}"] = np.asarray(
            [op.type for op in prog.global_block().ops])
    np.savez(out_path, **res)
    print("TORCH_PORT_ORACLE_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
