"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package, its entry points run on the GPU unless the caller asks
for the CPU, and weights load only where they fit."""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import convert, fluid
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import DecodeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import paddle_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # the GPU smoke script: module level only
sys.path.insert(0, "tests")
import torch_port_books  # noqa: F401  (the book programs of phase 27)
import torch_port_detection_models  # noqa: F401  (phase 35's programs)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_fresh_interpreter_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    for mod in ("serving.decode", "kernels.primitives.paged",
                "kernels.primitives.flash", "fluid.backward",
                "fluid.optimizer", "fluid.contrib.mixed_precision.bf16_policy",
                "fluid.layers.tensor", "ops.optimizer_ops", "models.bert",
                "inference", "fluid.io", "fluid.ir", "observability.metrics",
                "serving.engine", "serving.batching",
                "kernels.primitives.ragged", "kernels.primitives.int8",
                "observability.reqtrace", "observability.exposition",
                "observability.slo", "serving.status", "serving.router",
                "serving.frontend", "serving.drill",
                "distributed.resilience", "distributed.fault_injection",
                "distributed.elastic", "models.transformer",
                "ops.nn_extra_ops", "fluid.layers.nn_tail2", "reader",
                "dataset", "dataset.common", "dataset.cifar",
                "dataset.conll05", "dataset.flowers", "dataset.image",
                "dataset.imdb", "dataset.imikolov", "dataset.mnist",
                "dataset.movielens", "dataset.mq2007", "dataset.sentiment",
                "dataset.uci_housing", "dataset.voc2012", "dataset.wmt14",
                "dataset.wmt16", "ops.sequence_ops", "ops.rnn_ops",
                "ops.compat_ops", "ops.structured_ops", "fluid.layers.rnn",
                "fluid.layers.structured", "health", "health.detect",
                "health.transpile", "health.gating", "health.sentinel",
                "ops.amp_ops", "ops.health_ops", "serving.promote",
                "observability.profiling", "ops.control_flow_ops",
                "ops.tensor_array_ops", "fluid.struct_values",
                "fluid.layers.control_flow",
                "fluid.layers.learning_rate_scheduler", "models.gpt",
                "fluid.contrib.mixed_precision.fp16_lists",
                "fluid.contrib.mixed_precision.fp16_utils",
                "fluid.contrib.mixed_precision.decorator",
                "ops.detection_ops", "ops.detection_extra_ops",
                "fluid.layers.detection"):
        assert f"paddle_tpu_torch.{mod}" in res["modules"], mod
    assert res["bad"] == []


def test_package_sources_name_no_jax_import():
    """Belt and braces for the fresh-interpreter check: no source file of
    the port has an import line naming jax or paddle_tpu."""
    root = os.path.join(REPO, "paddle_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for ln in fh:
                    words = ln.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1 \
                            and words[1].split(".")[0] in ("jax", "jaxlib",
                                                           "paddle_tpu"):
                        offenders.append(f"{path}: {ln.strip()}")
    assert offenders == []


def test_executor_without_place_runs_on_cuda_or_raises():
    if torch.cuda.is_available():
        assert fluid.Executor().place == fluid.CUDAPlace(0)
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            fluid.Executor()
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"


def test_tpu_place_is_cuda_place():
    assert fluid.TPUPlace is fluid.CUDAPlace
    assert fluid.TPUPlace(0).torch_device() == torch.device("cuda", 0)


def test_decode_engine_without_place_raises_before_building():
    cfg = gpt.GPTConfig.tiny(num_layers=1)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: DecodeEngine() would run on it")
    scope = fluid.Scope()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        DecodeEngine(cfg, scope=scope, auto_start=False)
    assert list(scope.keys()) == []  # nothing installed


def test_explicit_cuda_place_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor(fluid.CUDAPlace(0))


def _program(cfg):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
    return main


def _arrays(main):
    rng = np.random.RandomState(0)
    return {p.name: rng.randn(*p.shape).astype(np.float32)
            for p in main.all_parameters()}


def test_load_params_loads_on_place():
    main = _program(gpt.GPTConfig.tiny(num_layers=1))
    arrays = _arrays(main)
    scope = fluid.Scope()
    names = convert.load_params(scope, arrays, fluid.CPUPlace(),
                                program=main)
    assert names == sorted(arrays)
    w = scope.get("gpt_word_embedding")
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(), arrays["gpt_word_embedding"])


@pytest.mark.parametrize("fault", ["missing", "shape", "dtype"])
def test_load_params_raises_on_mismatch(fault):
    main = _program(gpt.GPTConfig.tiny(num_layers=1))
    arrays = _arrays(main)
    name = "decoder_layer_0_att_query_fc.w_0"
    if fault == "missing":
        del arrays[name]
    elif fault == "shape":
        arrays[name] = arrays[name][:, :-1]
    else:
        arrays[name] = arrays[name].astype(np.float64)
    scope = fluid.Scope()
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        convert.load_params(scope, arrays, fluid.CPUPlace(), program=main)
    assert list(scope.keys()) == []  # all or nothing
