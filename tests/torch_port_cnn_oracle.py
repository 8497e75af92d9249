"""JAX oracle for tests/test_torch_port_cnn.py, run in a child process.

Builds each case's image-model program in the JAX package under
``unique_name.guard`` with ``Momentum(LR, 0.9)``, runs the startup
program, then trains on one fixed seeded batch on the CPU, and writes
one npz file a case:

  ops            the training program's op list (JSON: type, input and
                 output slots, attrs), taken before any dropout_prob is
                 set to 0
  init:<name>    every parameter and every moving statistic after the
                 startup program
  feed:<name>    the batch
  loss           per-step losses in fp32
  grad:<name>    each parameter's Momentum velocity after the first
                 step: its first gradient (velocities start at zero)
  final:<name>   every parameter and moving statistic after those steps
  bf16_loss      (resnet18_bf16, in place of the three above) per-step
                 losses under the bf16 dtype policy
  test_pred      (resnet18 only) the prediction of
                 ``clone(for_test=True)`` after the fp32 steps

A model with dropout has its ``dropout_prob`` set to 0 in the built
program (the masks of two frameworks' generators cannot agree).  A
child process, as tests/torch_port_bert_oracle.py is.

    python tests/torch_port_cnn_oracle.py OUT_DIR CASE [CASE ...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import cpu_mesh  # noqa: F401,E402  (must precede any jax-using import)

os.environ.setdefault("FLAGS_compile_cache_dir", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# Batch norm over a batch of 2-4 at these sizes' last maps (1x1 or
# 2x2) normalizes 2-16 values a channel: the step is ill-conditioned,
# and at a learning rate of 1e-3 the two frameworks' fp32 roundings
# (4.5e-6 of ResNet-18's first loss) grow about tenfold a step.  At
# 1e-6 the loss still falls by a third over 5 steps.  In bf16 one ulp
# (2^-8) of difference through a batch norm over 4 values (ResNet-18's
# last stage at 32x32, b4) moves the loss by several percent, so the
# bf16 case runs at b16 (16 values); SE-ResNeXt at 64x64 for the same
# reason (at 32x32, b2 its last batch norms see 2 values).
LR = 1e-6


def cases(models):
    """{case: (builder(), batch, image shape, steps, bf16)}: the builder
    returns (feed names, prediction, loss) in the current program, and
    ``bf16`` runs the steps under the bf16 dtype policy; ``models`` is
    either package's model zoo module."""
    resnet, mlp = models.resnet, models.mlp

    def resnet18():
        return resnet.build_resnet(depth=18, class_dim=10,
                                   image_shape=(3, 32, 32))[:3]


    def bottleneck_stack():
        """ResNet-50's stem and first stage (three bottleneck blocks at
        its widths) at 32x32, a global pool and a 10-way fc."""
        fl = _fluid_of(models)
        img = fl.data(name="img", shape=[-1, 3, 32, 32],
                      append_batch_size=False, dtype="float32")
        label = fl.data(name="label", shape=[-1, 1],
                        append_batch_size=False, dtype="int64")
        conv = resnet.conv_bn_layer(img, 64, 7, stride=2, act="relu",
                                    name="res_conv1")
        conv = fl.layers.pool2d(conv, pool_size=3, pool_stride=2,
                                pool_padding=1, pool_type="max")
        for blk in range(3):
            conv = resnet.bottleneck_block(conv, 64, 1,
                                           name=f"res2{chr(97 + blk)}")
        pool = fl.layers.pool2d(conv, pool_type="avg", global_pooling=True)
        pred = fl.layers.fc(pool, size=10, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=pred,
                                                      label=label))
        return ["img", "label"], pred, loss

    def se_resnext():
        return models.se_resnext.build_se_resnext(
            class_dim=10, image_shape=(3, 64, 64),
            cfg=([1, 1, 1, 1], 4, 4, 4))[:3]

    def mobilenet():
        return models.mobilenet.build_mobilenet(
            class_dim=10, image_shape=(3, 32, 32), scale=0.25,
            cfg=((64, 1), (128, 2), (256, 2), (512, 2)))[:3]

    def vgg():
        return models.vgg.build_vgg(class_dim=10, image_shape=(3, 32, 32),
                                    fc_dim=32,
                                    groups=([8], [16], [16, 16]))[:3]

    def densenet():
        return models.densenet.build_densenet(
            class_dim=10, image_shape=(3, 32, 32), growth_rate=4,
            block_cfg=(2, 2))[:3]

    def googlenet():
        return models.googlenet.build_googlenet(
            class_dim=10, image_shape=(3, 96, 96),
            cfg={"3a": (8, 4, 8, 2, 4, 4), "4a": (8, 4, 8, 2, 4, 4),
                 "4d": (8, 4, 8, 2, 4, 4), "5a": (8, 4, 8, 2, 4, 4)})[:3]

    def conv_net():
        return mlp.build_conv_net()[:3]

    return {"resnet18": (resnet18, 4, (3, 32, 32), 5, False),
            "resnet18_bf16": (resnet18, 16, (3, 32, 32), 3, True),
            "bottleneck_stack": (bottleneck_stack, 2, (3, 32, 32), 2, False),
            "se_resnext": (se_resnext, 2, (3, 64, 64), 2, False),
            "mobilenet": (mobilenet, 2, (3, 32, 32), 2, False),
            "vgg": (vgg, 2, (3, 32, 32), 2, False),
            "densenet": (densenet, 2, (3, 32, 32), 2, False),
            "googlenet": (googlenet, 2, (3, 96, 96), 2, False),
            "conv_net": (conv_net, 4, (1, 28, 28), 2, False)}


def _fluid_of(models):
    """The fluid package beside ``models`` (the JAX or the port's)."""
    import importlib

    return importlib.import_module(models.__name__.rsplit(".", 1)[0]
                                   + ".fluid")


def build(fl, builder, lr=LR):
    """The case's training program; returns (main, startup, loss,
    prediction)."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, pred, loss = builder()
        fl.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return main, startup, loss, pred


def no_dropout(program):
    """dropout_prob 0 on every dropout op: a step then draws no mask."""
    for op in program.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    return program


def state_names(program):
    """Parameters and the persistables the forward ops read besides
    them (batch norm's moving statistics)."""
    params = {p.name for p in program.all_parameters()}
    stats = {n for op in program.global_block().ops
             if op.type == "batch_norm"
             for n in op.inputs["Mean"] + op.inputs["Variance"]}
    return sorted(params | stats)


def make_feed(batch, image_shape, classes=10, seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.randn(batch, *image_shape).astype(np.float32),
            "label": r.randint(0, classes, (batch, 1)).astype(np.int64)}


def op_list(program):
    def attr(v):
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, tuple):
            return list(v)
        return v

    return json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str)


def velocities(program):
    """{parameter name: its Momentum velocity's name}."""
    return {op.inputs["Param"][0]: op.inputs["Velocity"][0]
            for op in program.global_block().ops if op.type == "momentum"}


def main(out_dir, names):
    from paddle_tpu import fluid, models
    from paddle_tpu.models import se_resnext, vgg  # noqa: F401  (not in
    # the package's __init__)
    from paddle_tpu.fluid.contrib.mixed_precision import enable_bf16_policy

    table = cases(models)
    exe = fluid.Executor(fluid.CPUPlace())
    # every value a builder's startup program wrote: a later case of the
    # same builder starts from them without compiling the startup again
    started = {}
    for name in names:
        builder, batch, shape, steps, bf16 = table[name]
        prog, startup, loss, pred = build(fluid, builder)
        res = {"ops": np.asarray(op_list(prog))}
        no_dropout(prog)
        if bf16:
            enable_bf16_policy(prog)
        if builder not in started:
            first = fluid.Scope()
            exe.run(startup, scope=first)
            started[builder] = {n: np.array(first.get(n))
                                for n in first.keys()
                                if first.get(n) is not None}
        scope = fluid.Scope()
        for n, a in started[builder].items():
            scope.set(n, np.array(a))
        names_ = state_names(prog)
        res.update({f"init:{n}": np.array(scope.get(n), np.float32)
                    for n in names_})
        feed = make_feed(batch, shape)
        res.update({f"feed:{k}": v for k, v in feed.items()})
        test_prog = prog.clone(for_test=True)
        losses = []
        for i in range(steps):
            losses.append(np.asarray(exe.run(
                prog, feed=feed, fetch_list=[loss], scope=scope)[0],
                np.float32).reshape(()))
            if i == 0 and not bf16:
                res.update({f"grad:{p}": np.array(scope.get(v), np.float32)
                            for p, v in velocities(prog).items()})
        res["bf16_loss" if bf16 else "loss"] = np.asarray(losses)
        if not bf16:
            res.update({f"final:{n}": np.array(scope.get(n), np.float32)
                        for n in names_})
        if name == "resnet18":
            (tp,) = exe.run(test_prog, feed=feed, fetch_list=[pred],
                            scope=scope)
            res["test_pred"] = np.asarray(tp, np.float32)
        np.savez(os.path.join(out_dir, f"{name}.npz"), **res)
    print("TORCH_PORT_CNN_ORACLE_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
