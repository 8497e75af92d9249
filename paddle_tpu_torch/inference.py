"""Inference engine: the AnalysisPredictor serving API (counterpart of
``paddle_tpu/inference.py``).

``AnalysisPredictor`` loads a saved inference model (``fluid.io`` JSON
layout: ``__model__`` + ``__params__.npz``, as either package saves it),
runs the graph passes (FLAGS_graph_passes, lane "serving") and
``fc_fuse_pass`` on the loaded program, and serves it through a
``fluid.Executor`` whose scope keeps the parameters on the device across
calls; only inputs and outputs cross the host boundary.

Device: the predictor runs on the card (CUDAPlace(0)) unless the config
asks otherwise — ``disable_gpu()`` means the CPU, ``enable_use_gpu(...,
device_id)`` a card — or the caller passes ``place=`` (the serving
engine hands its own place to each predictor).  With no GPU and no CPU
request it raises, as every entry point of the port does.

Not ported: post-training int8 quantization (``enable_quantizer``,
``paddle_tpu/fluid/contrib/ptq.py``), which raises NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["AnalysisConfig", "AnalysisPredictor", "PaddleTensor",
           "PaddleDType", "create_paddle_predictor", "ZeroCopyTensor",
           "check_feed_against_var"]

_PTQ = ("post-training int8 quantization (enable_quantizer) is not ported "
        "to paddle_tpu_torch yet")


def _resolve_np_dtype(dtype):
    """np.dtype of a framework dtype string; None when numpy has no such
    dtype (bfloat16), in which case the executor coerces."""
    if not isinstance(dtype, str) or not dtype:
        return None
    from .fluid.framework import convert_np_dtype_to_dtype_

    try:
        return np.dtype(convert_np_dtype_to_dtype_(dtype))
    except TypeError:
        return None


def check_feed_against_var(name, arr, var, error_cls=ValueError):
    """Edge validation of a feed array against the program's static var:
    rank and every fixed dim must match, and the dtype KIND must match
    (width differences such as float64 -> float32 are safe: the executor
    coerces them).  ``var=None`` (no static info) passes.

    The serving lane puts many callers into one batch, so a bad feed
    must fail here with the caller's name on it."""
    if var is None:
        return
    arr = np.asarray(arr)
    if var.shape is not None:
        want = tuple(var.shape)
        if arr.ndim != len(want):
            raise error_cls(
                f"feed {name!r}: rank {arr.ndim} array {tuple(arr.shape)} "
                f"does not match the program's static shape {list(want)}")
        for axis, (got, exp) in enumerate(zip(arr.shape, want)):
            if exp >= 0 and int(got) != int(exp):
                raise error_cls(
                    f"feed {name!r}: shape {tuple(arr.shape)} does not "
                    f"match the program's static shape {list(want)} "
                    f"(dim {axis}: got {got}, expected {exp})")
    want_dtype = _resolve_np_dtype(var.dtype)
    if want_dtype is not None and arr.dtype.kind != want_dtype.kind:
        raise error_cls(
            f"feed {name!r}: dtype {arr.dtype} is not {var.dtype}-"
            f"compatible (kind {arr.dtype.kind!r} vs {want_dtype.kind!r}) "
            f"— cast at the caller")


class PaddleDType:
    FLOAT32 = "float32"
    INT64 = "int64"
    INT32 = "int32"


class PaddleTensor:
    """Input/output container of the ``run`` API."""

    def __init__(self, data=None, name="", lod=None):
        arr = np.asarray(data) if data is not None else None
        self.name = name
        self.data = arr
        self.dtype = str(arr.dtype) if arr is not None else None
        self.shape = list(arr.shape) if arr is not None else []
        self.lod = lod or []

    def as_ndarray(self):
        return self.data


class AnalysisConfig:
    """Where the model is and which device serves it.  The pass and
    engine switches are accepted for API parity."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._place = None  # None: the card (CUDAPlace(0))
        self._ir_optim = True

    def set_model(self, model_dir, params_file=None):
        if params_file is None:
            self._model_dir = model_dir
        else:
            self._prog_file = model_dir
            self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    def disable_gpu(self):
        from .fluid.framework import CPUPlace

        self._place = CPUPlace()

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        from .fluid.framework import CUDAPlace

        self._place = CUDAPlace(device_id)

    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def enable_memory_optim(self):
        pass

    def switch_use_feed_fetch_ops(self, x=True):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def enable_quantizer(self):
        raise NotImplementedError(_PTQ)

    enable_mkldnn_quantizer = enable_quantizer
    quantizer_config = enable_quantizer
    mkldnn_quantizer_config = enable_quantizer

    def quantizer_enabled(self):
        return False

    mkldnn_quantizer_enabled = quantizer_enabled


class ZeroCopyTensor:
    """Named handle onto a predictor slot: copy_from_cpu stages the next
    run's input; copy_to_cpu reads the last run's output."""

    def __init__(self, predictor, name, is_input):
        self._pred = predictor
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise ValueError(f"{self.name} is an output tensor")
        arr = np.ascontiguousarray(arr)
        check_feed_against_var(self.name, arr, self._pred._var(self.name))
        self._pred._staged[self.name] = arr

    def copy_to_cpu(self):
        store = self._pred._staged if self._is_input else self._pred._outputs
        if self.name not in store:
            raise RuntimeError(
                f"tensor {self.name!r} has no value yet — "
                + ("copy_from_cpu() first" if self._is_input
                   else "call zero_copy_run() first"))
        return np.asarray(store[self.name])

    def shape(self):
        store = self._pred._staged if self._is_input else self._pred._outputs
        if self.name in store:
            return list(np.shape(store[self.name]))
        var = self._pred._var(self.name)
        if var is not None and var.shape is not None:
            return list(var.shape)
        raise RuntimeError(f"tensor {self.name!r} has no value or static "
                           f"shape yet")


class AnalysisPredictor:
    """A loaded inference model on one device.  ``place`` overrides the
    config's device choice."""

    def __init__(self, config: AnalysisConfig, place=None):
        from . import passes as _graph_passes
        from .fluid import io as _io
        from .fluid import ir
        from .fluid.executor import Executor, Scope
        from .fluid.framework import resolve_place

        self._config = config
        self._scope = Scope()
        self._exe = Executor(resolve_place(
            place if place is not None else config._place))
        if config._model_dir:
            prog, feeds, fetches = _io.load_inference_model(
                config._model_dir, self._exe, scope=self._scope)
        else:
            prog, feeds, fetches = _io.load_inference_model(
                os.path.dirname(config._prog_file) or ".", self._exe,
                model_filename=os.path.basename(config._prog_file),
                params_filename=(os.path.basename(config._params_file)
                                 if config._params_file else None),
                scope=self._scope)
        fetch_names = [v.name for v in fetches]
        # the graph passes on the loaded program; the fetch list pins
        # keep_vars, so no pass can fuse a fetch target away
        _graph_passes.apply_graph_passes(prog, lane="serving",
                                         keep_vars=fetch_names)
        if config._ir_optim:
            ir.apply_pass(prog, "fc_fuse_pass", keep_vars=fetch_names)
        self._program = prog
        self._feed_names = list(feeds)
        self._fetch_names = fetch_names
        self._staged = {}
        self._outputs = {}

    @property
    def place(self):
        return self._exe.place

    def _var(self, name):
        return self._program.global_block()._find_var_recursive(name)

    def _run(self, feed):
        return dict(zip(self._fetch_names, self._exe.run(
            self._program, feed=feed, fetch_list=self._fetch_names,
            scope=self._scope)))

    # -- ZeroCopy API ---------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_tensor(self, name):
        if name not in self._feed_names:
            raise KeyError(f"unknown input {name!r}; have {self._feed_names}")
        return ZeroCopyTensor(self, name, is_input=True)

    def get_output_tensor(self, name):
        if name not in self._fetch_names:
            raise KeyError(f"unknown output {name!r}")
        return ZeroCopyTensor(self, name, is_input=False)

    def zero_copy_run(self):
        missing = [n for n in self._feed_names if n not in self._staged]
        if missing:
            raise ValueError(f"inputs not set: {missing}")
        self._outputs = self._run(dict(self._staged))
        return True

    # -- PaddleTensor API -----------------------------------------------
    def run(self, inputs):
        """inputs: PaddleTensors in get_input_names() order (or named).
        Returns a list of PaddleTensor."""
        if any(not t.name for t in inputs) and \
                len(inputs) != len(self._feed_names):
            raise ValueError(
                f"run() got {len(inputs)} positional inputs but the model "
                f"expects {len(self._feed_names)}: {self._feed_names}")
        feed = {}
        for i, t in enumerate(inputs):
            name = t.name or self._feed_names[i]
            if name not in self._feed_names:
                raise ValueError(f"run() got unknown input {name!r}; "
                                 f"expected {self._feed_names}")
            if name in feed:
                raise ValueError(
                    f"run() fed input {name!r} twice; expected exactly one "
                    f"tensor per input in {self._feed_names}")
            feed[name] = t.data
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"run() is missing inputs {missing}; expected "
                             f"{self._feed_names}")
        return [PaddleTensor(o, name=n) for n, o in self._run(feed).items()]

    # -- dict-in/dict-out serving entry ----------------------------------
    def run_feed_dict(self, feed, validate=True):
        """The serving engine's entry: a complete ``{input: array}`` feed
        in, ``{output: array}`` out.  ``validate=False`` skips the edge
        checks for a caller that already made them."""
        missing = [n for n in self._feed_names if n not in feed]
        extra = [n for n in feed if n not in self._feed_names]
        if missing or extra:
            raise ValueError(
                f"run_feed_dict expects exactly {self._feed_names}; missing "
                f"{missing}, unexpected {extra}")
        if validate:
            for n in self._feed_names:
                check_feed_against_var(n, feed[n], self._var(n))
        return self._run(dict(feed))

    def program(self):
        return self._program


def create_paddle_predictor(config: AnalysisConfig, place=None):
    """The factory the reference API names CreatePaddlePredictor."""
    return AnalysisPredictor(config, place=place)
