"""JAX oracle for tests/test_torch_port_data_parallel.py and
tests/test_torch_port_fused_update.py, run in a child
process (as tests/torch_port_bert_oracle.py is: it keeps the JAX
runtime out of the pytest process's allocator history).

Each lane builds its program in the JAX package under
``unique_name.guard``, runs the startup program, and trains through
``CompiledProgram.with_data_parallel(places=[CPUPlace()] * 4)`` on the
8-virtual-device CPU mesh, one fixed global batch a step.  Written to
one npz file, for each lane L:

  L:init:<name>   every parameter after the startup program
  L:loss          the stacked [steps, 4] per-replica losses
  L:final:<name>  every parameter after the last step
  feed:<name>     BERT-tiny's global batch: four per-replica batches of
                  make_fake_batch(cfg, 2, 32, seed=r), concatenated, so
                  each replica's mask_pos indexes its own rows
  mlp:feed:<name> the MLP's global batch

Lanes: ``quant`` and ``plain`` (BERT-tiny, fp32, dropout 0, Adam(1e-4),
the quantized all-reduce with the fused update, and the plain
``c_allreduce_sum`` lane, 5 steps),
``bf16`` (``quant`` under the bf16 dtype policy, 3 steps), and
``momentum``, ``nesterov``, ``sgd``, ``adamw`` (a two-layer MLP with
that optimizer, quantized all-reduce with block size 16, fused, 5
steps).

    python tests/torch_port_dp_oracle.py OUT.npz bert|mlp

(``bert`` runs the BERT-tiny lanes, ``mlp`` the MLP lanes.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import cpu_mesh  # noqa: F401,E402  (must precede any jax-using import)

os.environ.setdefault("FLAGS_compile_cache_dir", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from paddle_tpu import fluid  # noqa: E402
from paddle_tpu.fluid.contrib.mixed_precision import (  # noqa: E402
    enable_bf16_policy)
from paddle_tpu.models import bert  # noqa: E402

N_REPLICAS = 4
BERT_STEPS, BF16_STEPS, MLP_STEPS = 5, 3, 5
MLP_BLOCK = 16


def bert_config():
    return bert.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                                hidden_dropout=0.0)


def bert_feed(cfg):
    shards = [bert.make_fake_batch(cfg, 2, 32, seed=r)
              for r in range(N_REPLICAS)]
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}


def mlp_feed():
    rng = np.random.RandomState(5)
    return {"x": rng.randn(16, 8).astype("float32"),
            "y": rng.randint(0, 3, (16, 1)).astype("int64")}


def build_bert(opt):
    cfg = bert_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        opt().minimize(loss)
    return main, startup, loss


def build_mlp(opt):
    """The MLP of tests/test_fused_update.py with the ops both packages
    have: tanh for relu, softmax_with_cross_entropy for softmax +
    cross_entropy."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(x, size=6, act="tanh")
        logits = L.fc(h, size=3)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        opt().minimize(loss)
    return main, startup, loss


MLP_OPTS = {
    "momentum": lambda: fluid.optimizer.Momentum(0.1, 0.9),
    "nesterov": lambda: fluid.optimizer.Momentum(0.1, 0.9,
                                                 use_nesterov=True),
    "sgd": lambda: fluid.optimizer.SGD(0.1),
    "adamw": lambda: fluid.optimizer.AdamW(0.01, weight_decay=0.05),
}


def train(main, startup, loss, feed, steps, quant, bf16=False):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
    params = [p.name for p in main.all_parameters()]
    init = {n: np.asarray(scope.get(n)) for n in params}
    if bf16:
        enable_bf16_policy(main)
    bs = fluid.compiler.BuildStrategy()
    bs.quant_allreduce = quant
    cp = fluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, places=[fluid.CPUPlace()] * N_REPLICAS)
    losses = []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            (lv,) = exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(np.asarray(lv, np.float32))
    final = {n: np.asarray(scope.get(n)) for n in params}
    return init, np.stack(losses), final


def main(out, group):
    res = {}

    def put(lane, init, loss, final):
        res[f"{lane}:loss"] = loss
        for n, v in init.items():
            res[f"{lane}:init:{n}"] = v
        for n, v in final.items():
            res[f"{lane}:final:{n}"] = v

    if group == "bert":
        feed = bert_feed(bert_config())
        for k, v in feed.items():
            res[f"feed:{k}"] = v
        adam = lambda: fluid.optimizer.Adam(learning_rate=1e-4)  # noqa
        for lane, quant, bf16, steps in (
                ("quant", True, False, BERT_STEPS),
                ("plain", False, False, BERT_STEPS),
                ("bf16", True, True, BF16_STEPS)):
            put(lane, *train(*build_bert(adam), feed, steps, quant, bf16))
    else:
        mfeed = mlp_feed()
        for k, v in mfeed.items():
            res[f"mlp:feed:{k}"] = v
        fluid.set_flags({"FLAGS_quant_allreduce_block_size": MLP_BLOCK})
        for lane, opt in MLP_OPTS.items():
            put(lane, *train(*build_mlp(opt), mfeed, MLP_STEPS, True))
    np.savez(out, **res)
    print("TORCH_PORT_DP_ORACLE_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
