"""Token-level continuous-batching decode lane (counterpart of
``paddle_tpu/serving/decode.py``).

A step-level scheduler admits and evicts SEQUENCES PER DECODE STEP over
a paged KV pool (serving/kv_pool.py), with a prefill/decode phase split
so long prompts stream through a separate fixed-shape prefill program
and never stall the running decode step.

Two fixed-shape programs, built once (models/gpt.py):

  prefill chunk   build_gpt_prefill_chunk — [1, C] tokens of ONE
                  sequence, K/V written into whole pool pages, attention
                  over the sequence's prefix through its page table.  A
                  P-token prompt is ceil(P/C) runs.
  decode step     build_gpt_decode_step — [pool_slots] one-token rows,
                  scatter-write + paged attention, greedy argmax out.

Scheduling loop (one scheduler thread per engine):

  1. run ONE prefill chunk of the oldest queued sequence (if any);
  2. admit prefill-complete sequences into free decode slots;
  3. run ONE decode step over the active slots; finished sequences
     (eos / max_new_tokens) resolve their futures and free pages + slot.

Eviction under pool pressure: when a page allocation fails, the
YOUNGEST other live sequence is evicted — its pages return to the pool
and its request re-queues for re-prefill of prompt + already-generated
tokens.  Greedy decode is deterministic, so the replay reproduces the
same stream.

The KV pool is fp32, or dual-int8 with ``pool_dtype="int8"`` (default:
FLAGS_int8_kv_cache): hi/lo int8 plus a per-vector fp32 scale, written
by the quant write ops and read by K7, which dequantises in registers.
The modeled saving against the fp32 pool books once per engine on
``pt_int8_bytes_saved_total{kind="kv_cache"}``.

``int8_weights=True`` stores the matmul weights dual-int8 at rest: the
``int8_weight_storage`` pass (passes/int8_weights.py) rewrites both
programs, and the scope's fp32 weights are quantized once and dropped,
before ``warmup()`` captures anything, so no graph reads a dropped
tensor.  Each program run rebuilds the weights in fp32 for its matmuls
(``dequantize_weight_storage``): the saving is at rest, booked on
``pt_int8_bytes_saved_total{kind="weights"}``.

Not ported yet (ROADMAP.md): the pt_decode_* metrics, request spans and
/servez; the SIGTERM drain; the fault-injection hook; router resume
(``submit_request(prefix=...)``).
Each program run's host-clock seconds are kept in ``prefill_seconds``
and ``step_seconds``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
import time

import numpy as np

from .errors import PoolExhaustedError, ServingOverloadError
from .kv_pool import TRASH_PAGE, KVPool

__all__ = ["DecodeEngine", "DecodeRequest"]


class DecodeRequest:
    """One generate() call: prompt tokens in, generated tokens out
    (greedy; the future resolves to a list[int] of generated ids,
    including the eos token when one stops the sequence)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "tenant", "future",
                 "seq_id", "generated", "prefilled")

    def __init__(self, prompt, max_new_tokens, eos_id, tenant):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.tenant = tenant
        self.future = concurrent.futures.Future()
        self.seq_id = None
        self.generated = []  # greedy stream; [-1] is the pending token
        self.prefilled = 0   # tokens whose K/V sit in the pool

    @property
    def written_target(self):
        """Tokens that must be in the pool before decode can proceed:
        the prompt plus every generated token except the pending one."""
        return len(self.prompt) + max(len(self.generated) - 1, 0)

    def tokens_to_write(self):
        return (self.prompt + self.generated[:-1] if self.generated
                else self.prompt)

    def done(self):
        return bool(self.generated) and (
            len(self.generated) >= self.max_new_tokens
            or (self.eos_id is not None
                and self.generated[-1] == self.eos_id))


class DecodeEngine:
    """Continuous-batching greedy decode over a GPT's parameters.

    ``scope`` must already hold the model parameters on the engine's
    device (run a startup program, or ``convert.load_params``); the
    engine installs the pool tensors beside them.  ``place=None`` runs
    on CUDAPlace(0); without a GPU the caller must pass CPUPlace().

    Sizing: ``pool_slots`` concurrent decoding sequences; ``max_len`` >=
    prompt + max_new_tokens per request (default cfg.max_position);
    ``num_pages`` defaults to every slot at full length (+1 trash) —
    shrink it to exercise eviction.

    ``int8_weights`` quantizes the scope's matmul weights in place (the
    fp32 tensors leave the scope): use it on a scope no other program
    shares."""

    def __init__(self, cfg, *, scope=None, place=None, pool_slots=4,
                 page_size=16, prefill_chunk=None, max_len=None,
                 num_pages=None, max_queue=None, pool_dtype=None,
                 attn_force=None, name="decode", auto_start=True,
                 tenant_quota=None, int8_weights=False):
        from paddle_tpu_torch import fluid
        from paddle_tpu_torch.fluid import flags as _flags
        from paddle_tpu_torch.fluid.framework import resolve_place
        from paddle_tpu_torch.models import gpt as _gpt

        place = resolve_place(place)  # first: no GPU and no place raises
        if pool_dtype is None:
            pool_dtype = ("int8" if _flags.flag("int8_kv_cache")
                          else "float32")
        self.cfg = cfg
        self.name = name
        self.scope = scope if scope is not None else fluid.global_scope()
        self.pool_slots = int(pool_slots)
        page_size = int(page_size)
        max_len = int(max_len if max_len is not None else cfg.max_position)
        if max_len > cfg.max_position:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_position {cfg.max_position}")
        max_pages = -(-max_len // page_size)
        if prefill_chunk is None:
            prefill_chunk = min(max(page_size, 32), max_len)
            prefill_chunk -= prefill_chunk % page_size
            prefill_chunk = max(prefill_chunk, page_size)
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk <= 0 or prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a positive multiple "
                f"of page_size {page_size} (chunks cover whole pool pages)")
        if num_pages is None:
            num_pages = self.pool_slots * max_pages + 1
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self._max_queue = int(_flags.flag("serving_max_queue")
                              if max_queue is None else max_queue)
        self._tenant_quota = int(_flags.flag("serving_tenant_quota")
                                 if tenant_quota is None else tenant_quota)
        self.pool = KVPool(cfg.num_layers, cfg.num_heads,
                           cfg.hidden_size // cfg.num_heads, num_pages,
                           page_size, max_pages, dtype=pool_dtype)
        self._exe = fluid.Executor(place)
        self.pool.install(self.scope, self._exe.device)
        if pool_dtype == "int8":
            from paddle_tpu_torch.kernels.primitives import int8 as _int8

            _int8.book_bytes_saved(
                "kv_cache",
                self.pool.modeled_bytes_fp32() - self.pool.modeled_bytes())

        # two programs, built once against the parameter names the
        # training lanes use
        dec_prog, dec_start = fluid.Program(), fluid.Program()
        with fluid.program_guard(dec_prog, dec_start), \
                fluid.unique_name.guard():
            _, dec_tok, _ = _gpt.build_gpt_decode_step(
                cfg, self.pool_slots, num_pages, page_size, max_pages,
                pool_dtype=pool_dtype, attn_force=attn_force)
        pf_prog, pf_start = fluid.Program(), fluid.Program()
        with fluid.program_guard(pf_prog, pf_start), \
                fluid.unique_name.guard():
            _, pf_tok, _ = _gpt.build_gpt_prefill_chunk(
                cfg, prefill_chunk, num_pages, page_size, max_pages,
                pool_dtype=pool_dtype, attn_force=attn_force)
        self._dec_prog, self._dec_fetch = dec_prog, dec_tok.name
        self._pf_prog, self._pf_fetch = pf_prog, pf_tok.name
        self.int8_weights = None
        if int8_weights:
            self.int8_weights = self._store_weights_int8(dec_prog, pf_prog)

        self._queue = collections.deque()   # prefill-pending, FIFO
        self._ready = collections.deque()   # prefill done, need a slot
        self._slots = [None] * self.pool_slots
        self._live_order = []               # admission order (evict LIFO)
        self._cv = threading.Condition()
        self._thread = None
        self._closed = False
        self._failed = None  # the exception that killed the scheduler
        # serializes program runs: a user-thread warmup() racing the
        # scheduler's step would interleave two runs' in-place pool writes
        self._exec_lock = threading.Lock()
        self._next_seq = 0
        self._steps = 0
        self._chunks = 0
        self._tokens = 0
        self._evictions = 0
        self.prefill_seconds = []  # host seconds of each prefill-chunk run
        self.step_seconds = []     # host seconds of each decode-step run
        if auto_start:
            self.start()

    def _store_weights_int8(self, dec_prog, pf_prog):
        """Both programs through the int8_weight_storage pass, then the
        scope's claimed weights quantized once (the fp32 tensors
        dropped).  Returns {"weights", "bytes_saved",
        "modeled_bytes_saved"}."""
        from paddle_tpu_torch import passes as _passes
        from paddle_tpu_torch.passes.int8_weights import (
            quantize_scope_weights)

        ctx = _passes.PassContext(lane="serving")
        mgr = _passes.PassManager(["int8_weight_storage"])
        modeled = [mgr.run(p, ctx)[-1]["modeled_bytes_saved"]
                   for p in (dec_prog, pf_prog)]
        claimed = [{op.output("Out")[0] for op in p.global_block().ops
                    if op.type == "dequantize_weight_storage"}
                   for p in (dec_prog, pf_prog)]
        if claimed[0] != claimed[1]:
            raise RuntimeError(
                f"int8_weights: decode and prefill programs claimed "
                f"different weight sets ({sorted(claimed[0] ^ claimed[1])}) "
                f"— the shared scope cannot satisfy both")
        info = quantize_scope_weights(self.scope, dec_prog)
        info["modeled_bytes_saved"] = modeled[0]
        return info

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None,
               tenant="default"):
        """Enqueue one greedy generation; returns a Future resolving to
        the generated token ids (list[int])."""
        prompt = list(prompt)
        if not prompt:
            raise ValueError("decode: empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(f"decode: max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_len:
            raise ValueError(
                f"decode: prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds the engine's max_len "
                f"{self.max_len} — raise max_len or split the request")
        tenant = str(tenant)
        req = DecodeRequest(prompt, max_new_tokens, eos_id, tenant)
        with self._cv:
            if self._closed:
                raise ServingOverloadError(
                    f"decode engine {self.name!r} is closed",
                    reason="closed")
            if self._failed is not None:
                raise ServingOverloadError(
                    f"decode engine {self.name!r} scheduler died: "
                    f"{self._failed!r} — close and recreate the engine",
                    reason="scheduler_failed")
            if len(self._queue) >= self._max_queue:
                raise ServingOverloadError(
                    f"decode engine {self.name!r}: queue at admission limit "
                    f"({self._max_queue}) — retry with backoff",
                    reason="overload")
            if self._tenant_quota > 0:
                live = sum(1 for r in (*self._queue, *self._ready,
                                       *(s for s in self._slots
                                         if s is not None))
                           if r.tenant == tenant)
                if live >= self._tenant_quota:
                    raise ServingOverloadError(
                        f"decode engine {self.name!r}: tenant {tenant!r} "
                        f"holds {live} live requests, at "
                        f"FLAGS_serving_tenant_quota={self._tenant_quota} "
                        f"— retry with backoff", reason="tenant_quota")
            self._queue.append(req)
            self._cv.notify_all()
        return req.future

    def generate(self, prompts, max_new_tokens, eos_id=None, timeout=None):
        """Blocking convenience: submit every prompt, wait for all.
        Returns list[list[int]] of generated ids."""
        futs = [self.submit(p, max_new_tokens, eos_id=eos_id)
                for p in prompts]
        return [f.result(timeout=timeout) for f in futs]

    def warmup(self):
        """Run both programs once outside the request path (one
        all-inactive decode step + one trash-page prefill chunk; writes
        land only on the trash page).  On a CUDA place this is where
        the executor warms up and captures each program as a CUDA graph
        (fluid/executor.py), which every later run replays — from the
        scheduler's thread too.  Returns the number of programs warmed
        (2)."""
        self._run_prefill_feed(
            tokens=[0], pos0=0, table_row=self.pool.padded_table(None),
            write_pages=np.zeros(self.prefill_chunk // self.pool.page_size,
                                 np.int32), valid=1, warm=True)
        self._run_decode_feed([], warm=True)
        return 2

    def start(self):
        with self._cv:
            if self._thread is not None or self._closed:
                return self
            self._thread = threading.Thread(
                target=self._scheduler_loop, daemon=True,
                name=f"pt-decode-{self.name}")
            self._thread.start()
        return self

    def close(self):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        with self._cv:
            leftovers = (list(self._queue) + list(self._ready)
                         + [s for s in self._slots if s is not None])
            self._queue.clear()
            self._ready.clear()
            self._slots = [None] * self.pool_slots
        for req in leftovers:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(ServingOverloadError(
                    f"decode engine {self.name!r} closed before the request "
                    f"finished", reason="closed"))

    def stats(self):
        with self._cv:
            depth, ready = len(self._queue), len(self._ready)
            active = sum(s is not None for s in self._slots)
        return {
            "engine": self.name, "pool_slots": self.pool_slots,
            "active_slots": active, "queue_depth": depth, "ready": ready,
            "failed": repr(self._failed) if self._failed else None,
            "prefill_chunk": self.prefill_chunk, "max_len": self.max_len,
            "steps": self._steps, "prefill_chunks": self._chunks,
            "tokens": self._tokens, "evictions": self._evictions,
            "kv_pool": self.pool.stats(),
            "int8_weights": self.int8_weights,
        }

    # -- scheduler ----------------------------------------------------------

    def _scheduler_loop(self):
        while True:
            with self._cv:
                while (not self._closed and not self._queue
                       and not self._ready
                       and all(s is None for s in self._slots)):
                    self._cv.wait()  # close()/submit() notify
                if self._closed:
                    return
            try:
                self._step_once()
            except BaseException as e:
                # a run failure must fail the live requests, not kill the
                # scheduler thread silently
                self._fail_all(e)
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                return

    def _fail_all(self, exc):
        with self._cv:
            self._failed = exc  # submit() rejects typed from now on
            reqs = (list(self._queue) + list(self._ready)
                    + [s for s in self._slots if s is not None])
            self._queue.clear()
            self._ready.clear()
            self._slots = [None] * self.pool_slots
        for req in reqs:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)

    def _step_once(self):
        """<=1 prefill chunk, admissions, <=1 decode step."""
        self._prefill_one_chunk()
        self._admit_ready()
        self._decode_step()

    # -- eviction -----------------------------------------------------------

    def _evict_one(self, protect):
        """Free the YOUNGEST live sequence other than ``protect``; its
        request re-queues (front) for re-prefill of prompt + generated
        prefix.  Returns False when nobody else is evictable."""
        for req in reversed(self._live_order):
            if req is protect:
                continue
            self._live_order.remove(req)
            self.pool.free_seq(req.seq_id)
            req.seq_id = None
            req.prefilled = 0
            for i, s in enumerate(self._slots):
                if s is req:
                    self._slots[i] = None
            with self._cv:
                if req in self._ready:
                    self._ready.remove(req)
                # a victim still mid-prefill is ALREADY queued
                if req not in self._queue:
                    self._queue.appendleft(req)
            self._evictions += 1
            return True
        return False

    def _ensure_pages(self, req, n_tokens):
        while True:
            try:
                return self.pool.ensure_capacity(req.seq_id, n_tokens)
            except PoolExhaustedError:
                if not self._evict_one(protect=req):
                    raise

    # -- prefill ------------------------------------------------------------

    def _prefill_one_chunk(self):
        with self._cv:
            req = self._queue[0] if self._queue else None
        if req is None:
            return
        if req.seq_id is None:
            req.seq_id = self._next_seq
            self._next_seq += 1
            self.pool.open_seq(req.seq_id)
            self._live_order.append(req)
        tokens = req.tokens_to_write()
        total = len(tokens)
        ctx_len = req.prefilled
        valid = min(self.prefill_chunk, total - ctx_len)
        self._ensure_pages(req, ctx_len + valid)
        pgs = self.pool.page_size
        table = self.pool.table(req.seq_id)
        first_lp = ctx_len // pgs
        write_pages = np.full(self.prefill_chunk // pgs, TRASH_PAGE,
                              np.int32)
        for j in range(len(write_pages)):
            lp = first_lp + j
            if lp < len(table) and lp * pgs < ctx_len + valid:
                write_pages[j] = table[lp]
        next_tok = self._run_prefill_feed(
            tokens=tokens[ctx_len:ctx_len + valid], pos0=ctx_len,
            table_row=self.pool.padded_table(req.seq_id),
            write_pages=write_pages, valid=valid)
        req.prefilled = ctx_len + valid
        if req.prefilled == total:
            if not req.generated:
                # fresh prompt: the prefill's argmax seeds the stream
                req.generated.append(int(next_tok))
                self._tokens += 1
            with self._cv:
                # remove by identity: an eviction during _ensure_pages may
                # have re-queued a victim ahead of us
                if req in self._queue:
                    self._queue.remove(req)
                self._ready.append(req)

    def _run_prefill_feed(self, tokens, pos0, table_row, write_pages, valid,
                          warm=False):
        c = self.prefill_chunk
        tok = np.zeros((1, c), np.int64)
        tok[0, :len(tokens)] = tokens
        pos = np.minimum(pos0 + np.arange(c, dtype=np.int64),
                         self.cfg.max_position - 1)[None, :]
        feed = {
            "pf_tok": tok,
            "pf_pos": pos,
            "pf_page_table": table_row[None, :].astype(np.int32),
            "pf_write_pages": write_pages.astype(np.int32),
            "pf_qstart": np.asarray([pos0], np.int32),
            "pf_last_idx": np.asarray([max(valid - 1, 0)], np.int64),
        }
        with self._exec_lock:
            t0 = time.perf_counter()
            (out,) = self._exe.run(self._pf_prog, feed=feed,
                                   fetch_list=[self._pf_fetch],
                                   scope=self.scope)
            dt = time.perf_counter() - t0
        if not warm:
            self.prefill_seconds.append(dt)
            self._chunks += 1
        return int(np.asarray(out).reshape(-1)[0])

    # -- decode -------------------------------------------------------------

    def _admit_ready(self):
        with self._cv:
            for i in range(self.pool_slots):
                if self._slots[i] is None and self._ready:
                    self._slots[i] = self._ready.popleft()

    def _decode_step(self):
        # a request satisfiable by prefill alone (max_new_tokens=1, or
        # eos as the seed token) finishes without a decode step
        for i, req in enumerate(self._slots):
            if req is not None and req.done():
                self._finish(i, req)
        for i, req in enumerate(self._slots):
            # an earlier iteration's eviction may have removed this
            # request from its slot already
            if req is not None and self._slots[i] is req:
                self._ensure_pages(req, req.written_target + 1)
        # re-read: _ensure_pages may have evicted some of the slots
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        if not active:
            return
        next_toks = self._run_decode_feed(active)
        now_done = []
        for i, req in active:
            req.generated.append(int(next_toks[i]))
            self._tokens += 1
            if req.done():
                now_done.append((i, req))
        for i, req in now_done:
            self._finish(i, req)

    def _run_decode_feed(self, active, warm=False):
        ps, pgs = self.pool_slots, self.pool.page_size
        tok = np.zeros((ps, 1), np.int64)
        pos = np.zeros((ps, 1), np.int64)
        table = np.tile(self.pool.padded_table(None), (ps, 1))
        wpage = np.zeros(ps, np.int32)
        woff = np.zeros(ps, np.int32)
        for i, req in active:
            p = req.written_target  # the pending token's position
            tok[i, 0] = req.generated[-1]
            pos[i, 0] = p
            table[i] = self.pool.padded_table(req.seq_id)
            wpage[i] = self.pool.table(req.seq_id)[p // pgs]
            woff[i] = p % pgs
        feed = {"dec_tok": tok, "dec_pos": pos,
                "dec_page_table": table.astype(np.int32),
                "dec_write_page": wpage, "dec_write_off": woff}
        with self._exec_lock:
            t0 = time.perf_counter()
            (out,) = self._exe.run(self._dec_prog, feed=feed,
                                   fetch_list=[self._dec_fetch],
                                   scope=self.scope)
            dt = time.perf_counter() - t0
        if not warm:
            self.step_seconds.append(dt)
            self._steps += 1
        return np.asarray(out).reshape(-1)

    def _finish(self, slot, req):
        self._slots[slot] = None
        if req in self._live_order:
            self._live_order.remove(req)
        self.pool.free_seq(req.seq_id)
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(list(req.generated))
