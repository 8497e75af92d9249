"""JAX oracle for tests/test_torch_port_int8.py, run in a child process.

Builds the decode e2e fixture (tests/decode_e2e_checks.py: a tiny GPT
trained 30 steps), runs the JAX package's DecodeEngine over the dual-int8
KV pool (``pool_dtype="int8"``) and its two int8 decode-lane programs,
and writes what the PyTorch port is held against to one npz file:

  param:<name>     every parameter of the decode-step program
  prompts_base, ids_base   4 prompts and the int8 engine's greedy ids
  prompt_long<i>, ids_long<i>  prompts of 11, 19 and 2 tokens (several
                   prefill chunks, and one padded chunk) and their ids
  engine           the engine sizing [pool_slots, page_size, chunk, max_len]
  lane             [page_size, max_pages, num_pages, chunk, slots]
  pf<i>:<feed>, pf<i>_logp, dec:<feed>, dec_logp   program feeds/logprobs
                   over the int8 pool
  ops_decode, ops_prefill  op types of both int8 programs after the passes
  ops_fc_decode, ops_fc_prefill  the same, then after fc_fuse_pass

A child process for the reason tests/torch_port_jax_oracle.py gives (the
decode lane's e2e runs in a fresh process with the persistent compile
cache off).

    python tests/torch_port_serving_oracle.py OUT.npz
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import decode_e2e_checks as e2e  # noqa: E402  (cpu_mesh first, cache off)
import torch_port_jax_oracle as fp32_oracle  # noqa: E402

import numpy as np  # noqa: E402

from paddle_tpu import fluid, serving  # noqa: E402
from paddle_tpu.models import gpt  # noqa: E402

ENGINE = fp32_oracle.ENGINE
LANE = fp32_oracle.LANE


def _generate(cfg, scope, prompts):
    eng = serving.DecodeEngine(cfg, scope=scope, auto_start=False,
                               pool_dtype="int8", **ENGINE)
    try:
        eng.warmup()
        eng.start()
        return eng.generate([list(p) for p in prompts], max_new_tokens=6,
                            timeout=300)
    finally:
        eng.close()


def _lane_programs(cfg):
    progs = {}
    for name, build in (
            ("prefill", lambda: gpt.build_gpt_prefill_chunk(
                cfg, LANE["chunk"], LANE["num_pages"], LANE["page_size"],
                LANE["max_pages"], pool_dtype="int8")),
            ("decode", lambda: gpt.build_gpt_decode_step(
                cfg, LANE["slots"], LANE["num_pages"], LANE["page_size"],
                LANE["max_pages"], pool_dtype="int8"))):
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start), fluid.unique_name.guard():
            _, _, logp = build()
        progs[name] = (main, logp.name)
    return progs


def main(out_path):
    cfg, scope, prompts, _ = e2e.build_fixture()
    rng = np.random.RandomState(5)
    long_prompts = [rng.randint(1, cfg.vocab_size, n) for n in (11, 19, 2)]
    res = {"prompts_base": np.asarray(prompts, np.int64),
           "ids_base": np.asarray(_generate(cfg, scope, prompts), np.int64)}
    for i, (p, g) in enumerate(zip(long_prompts,
                                   _generate(cfg, scope, long_prompts))):
        res[f"prompt_long{i}"] = np.asarray(p, np.int64)
        res[f"ids_long{i}"] = np.asarray(g, np.int64)

    progs = _lane_programs(cfg)
    lane_scope = fluid.Scope()
    for p in progs["decode"][0].all_parameters():
        lane_scope.set(p.name, np.asarray(scope.get(p.name)))
        res[f"param:{p.name}"] = np.asarray(scope.get(p.name))
    n, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    shape = (LANE["num_pages"], LANE["page_size"], n, d)
    for layer in gpt.kv_pool_quant_var_names(cfg.num_layers):
        for hi, lo, sc in layer:
            lane_scope.set(hi, np.zeros(shape, np.int8))
            lane_scope.set(lo, np.zeros(shape, np.int8))
            lane_scope.set(sc, np.zeros(shape[:-1] + (1,), np.float32))
    pf_feeds, dec_feed = fp32_oracle.lane_feeds(
        rng.randint(1, cfg.vocab_size, 7))
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
    for key, (prog, fetch) in progs.items():
        res[f"ops_{key}"] = np.asarray(
            [op.type for op in prog.global_block().ops])
        fluid.ir.apply_pass(prog, "fc_fuse_pass", keep_vars=[fetch])
        res[f"ops_fc_{key}"] = np.asarray(
            [op.type for op in prog.global_block().ops])
    np.savez(out_path, **res)
    print("TORCH_PORT_SERVING_ORACLE_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
