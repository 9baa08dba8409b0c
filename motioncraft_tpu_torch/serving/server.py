"""Dynamic request batching over batch and sequence buckets (PyTorch port of
motioncraft_tpu/serving/server.py).

- Requests (a text, a motion length, optionally a frame-aligned condition:
  raw 16 kHz audio for S2G, music features for M2D) enter a queue.
  Long-form requests (``submit_long``) of any length are generated window by
  window with RePaint-outpainted overlaps, and concurrent long requests run
  in lockstep, one sampling call a window for the whole group
  (apis/windowed.py).
- A dispatcher thread groups requests up to the largest batch bucket,
  waiting at most ``max_wait_ms`` after the first arrival.
- A group is padded to the smallest batch bucket that holds it, with copies
  of its last request, before it is sampled: MoE capacity depends on the
  token count, so every dispatch of a bucket routes as the bucket does.
  Sequence buckets split a group by motion length, so short requests run a
  short sampling call.
- One ``MotionDiffusion.sample`` call (CFG DDIM, f32 or bf16 denoiser
  compute) serves a group; the outputs are cut to each request's length,
  de-normalised when statistics are given, and each request's future is
  fulfilled.  An exception fails every future of its group.

Determinism: dispatch ``i`` draws from a ``torch.Generator`` seeded with
``dispatch_seed(seed, i)`` (numpy's ``SeedSequence([seed, i])``, in place of
the JAX package's ``fold_in(PRNGKey(seed), i)``), so a given group at a given
dispatch index gives the same output; a request alone is not bit-stable
across groupings (the group shares one noise tensor).  The streams are not
JAX's (ROADMAP, "Random streams").

A long-form request resolves to exactly ``total_frames`` frames, as
``submit_long`` promises: it samples enough windows to cover them
(``covered_frames``) and cuts the last one.  The JAX package's server runs
the evaluation protocol's window count, ``(n - pre) // (window - pre)``, and
returns fewer frames when they do not fill a whole window (388 of 400 at
196-frame windows overlapping by 4).

Serving over several cards (``mesh``, parallel/mesh.py; the JAX
package's multi-chip serving): one process a rank, the model on every rank
(replicated; a model sharded over an expert or tensor axis samples too).
Rank 0 runs the dispatcher (and, in tools/torch_serve.py, the HTTP front)
and broadcasts each sampling call's batch and generator state; every rank
samples its block of the bucket's rows (``apis/test.py:mesh_sample``: the
draws at the global shape, the MoEs routed over the whole dispatch) and
rank 0 gathers the rows, so a dispatch gives what the one-card server
gives.  The other ranks run ``follow`` until rank 0 stops.  A follower
waits in a broadcast, a collective that fails once the process group's
timeout passes, so from ``start`` on rank 0 broadcasts a keep-alive when
it has broadcast nothing for ``keepalive_s``: an idle server lives on.  A batch bucket
that the mesh's row-ranks do not divide raises ``ValueError``, as the JAX
package's does.  Long-form dispatches run on rank 0 alone, whole, as the
JAX package runs its windowed sampler outside the mesh (a sharded model
raises there).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..apis.factory import make_text_batch
from ..apis.test import mesh_sample
from ..apis.windowed import denormalize, windowed_sample, windowed_sample_batch
from ..diffusion import RepaintConfig, generator_randn


@dataclass
class _Pending:
    text: str
    length: int
    # frame-aligned condition: raw 16 kHz audio [length * 533, 2] for S2G,
    # music features [length, 163] for M2D
    condition: Optional[np.ndarray] = None
    # long-form: generated window by window; `length` is then the total
    long: bool = False
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.monotonic)

    def cond_sig(self):
        """Requests batch together only when their conditions agree in
        per-frame rate and trailing shape."""
        if self.condition is None:
            return None
        rate = self.condition.shape[0] // max(1, self.length)
        return (rate,) + tuple(self.condition.shape[1:])


_STOP = object()


def covered_frames(total_frames: int, window: int, pre_frames: int) -> int:
    """The frames of the fewest windows (``window`` frames overlapping by
    ``pre_frames``) that cover ``total_frames``."""
    stride = window - pre_frames
    return pre_frames + max(1, -(-(total_frames - pre_frames) // stride)) * stride


def dispatch_seed(seed: int, index: int) -> int:
    """The seed of dispatch ``index``'s generator: a 63-bit hash of
    (seed, index) by numpy's SeedSequence."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class MotionGenServer:
    """Dynamic-batching motion generation server over ``arch.sample``.

    Parameters
    ----------
    arch: a built ``MotionDiffusion`` with its weights (bf16-cast by
        ``apis.bf16_cast_`` for bf16 serving; int8-quantized by
        ``apis.int8_quantize_`` for int8 serving), in ``eval()`` mode.
    batch_buckets: ascending batch sizes; a group of n requests is padded to
        the smallest bucket >= n.
    seq_buckets: ascending motion lengths ending at ``max_seq_len``; a
        request runs at the smallest one >= its length.
    max_wait_ms: how long the dispatcher holds an underfull group open after
        its first request.
    mean, std: normalisation statistics; outputs are de-normalised with them.
    compute_dtype: the denoiser's dtype (torch.bfloat16 on a bf16-cast
        model).
    window, pre_frames, repaint: long-form generation (window defaults to
        ``max_seq_len``; RePaint over ``pre_frames`` with the blend).
    step_cache: a ``StepCacheConfig`` for every sampling call (layer-residual
        reuse, diffusion/stepcache.py), or None (exact).
    mesh: a ``parallel.mesh.DataMesh`` to serve over (module docstring);
        every rank builds the server, rank 0 serves and the others
        ``follow``.
    keepalive_s: on a mesh, the longest rank 0 stays silent once started;
        well inside the process group's timeout (parallel/mesh.py
        ``DEFAULT_TIMEOUT_S``).
    """

    def __init__(self, arch, *, max_seq_len: int = 196, input_feats: int = 322,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 20.0, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 mesh=None, window: Optional[int] = None, pre_frames: int = 4,
                 repaint: Optional[RepaintConfig] = None, step_cache=None,
                 keepalive_s: float = 60.0):
        if list(batch_buckets) != sorted(set(int(b) for b in batch_buckets)):
            raise ValueError("batch_buckets must be ascending and unique")
        self._arch = arch
        self._max_seq_len = int(max_seq_len)
        self._input_feats = int(input_feats)
        self._buckets = [int(b) for b in batch_buckets]
        self._seq_buckets = (sorted(set(int(t) for t in seq_buckets)) if seq_buckets
                             else [self._max_seq_len])
        if self._seq_buckets[-1] != self._max_seq_len:
            raise ValueError("seq_buckets must end at max_seq_len")
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._seed = int(seed)
        if (mean is None) != (std is None):
            raise ValueError("mean and std must be given together")
        self._mean = None if mean is None else np.asarray(mean, np.float32)
        self._std = None if std is None else np.asarray(std, np.float32)
        self._window = int(window) if window else self._max_seq_len
        self._pre_frames = int(pre_frames)
        self._repaint = repaint
        self._compute_dtype = compute_dtype
        self._step_cache = step_cache
        self._mesh = mesh
        if mesh is not None:
            bad = [b for b in self._buckets if b % mesh.world]
            if bad:
                raise ValueError(f"batch_buckets {bad} not divisible by the mesh's "
                                 f"data-parallel size {mesh.world}: each rank samples "
                                 "an equal block of a bucket's rows, so a bucket must be "
                                 "a multiple of the row-ranks")
        self._followers_stopped = False
        # rank 0's broadcasts: one at a time (a sampling call's collectives
        # included), the keep-alive thread's too
        self._comm_lock = threading.Lock()
        self._keepalive_s = float(keepalive_s)
        self._last_send = time.monotonic()
        self._quiet = threading.Event()
        self._keepalive: Optional[threading.Thread] = None

        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._dispatches = 0
        self._long_dispatches = 0
        self._requests = 0
        self._request_rows = 0  # sum of group sizes (occupancy numerator)
        self._padded_rows = 0
        self._latencies: list = []  # bounded; seconds from enqueue to fulfilment

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
            if self._mesh is not None and self._mesh.lead and self._keepalive is None:
                self._keepalive = threading.Thread(target=self._keep_alive, daemon=True)
                self._keepalive.start()
        return self

    def _keep_alive(self):
        """Rank 0's keep-alive: an ``idle`` broadcast whenever nothing was
        broadcast for ``keepalive_s``, so that no follower's wait outlasts
        the process group's timeout."""
        while not self._quiet.wait(self._keepalive_s / 4):
            with self._comm_lock:
                if (not self._followers_stopped
                        and time.monotonic() - self._last_send >= self._keepalive_s):
                    self._send(("idle",))

    def stop(self, timeout: float = 30.0):
        t = self._thread
        if t is not None and t.is_alive():
            self._q.put(_STOP)
            t.join(timeout)
        self._quiet.set()
        if self._keepalive is not None:
            self._keepalive.join(timeout)
        if self._mesh is not None and self._mesh.lead and not self._followers_stopped:
            with self._comm_lock:
                self._followers_stopped = True
                self._send(("stop",))
        # a request enqueued while the dispatcher was exiting would never
        # resolve: fail it instead of stranding its caller
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP and not item.future.done():
                item.future.set_exception(RuntimeError("server stopped before dispatch"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def dispatch_generator(self, index: int) -> torch.Generator:
        """The generator of dispatch ``index`` (on the model's device)."""
        return torch.Generator(device=self._arch.device).manual_seed(
            dispatch_seed(self._seed, index))

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Sample once at every (batch, sequence) bucket pair in the
        server's dtype before traffic: the first call builds the kernels
        and sets up the libraries, which a request should not wait for."""
        generator = torch.Generator(device=self._arch.device).manual_seed(self._seed)
        with torch.inference_mode():
            for b in buckets or self._buckets:
                for t in self._seq_buckets:
                    self._sample(make_text_batch(["warmup"] * b, t, self._input_feats),
                                 generator)
            if self._arch.device.type == "cuda":
                torch.cuda.synchronize(self._arch.device)
        return self

    # -- client API --------------------------------------------------------

    @staticmethod
    def _check_condition(condition, length):
        if condition is None:
            return None
        condition = np.asarray(condition, np.float32)
        if condition.ndim < 1 or condition.shape[0] % max(1, length):
            raise ValueError(f"condition length {condition.shape[0]} is not a whole "
                             f"per-frame rate for {length} frames")
        return condition

    def submit(self, text: str, length: Optional[int] = None,
               condition: Optional[np.ndarray] = None) -> Future:
        """Enqueue one request; resolves to a [length, input_feats] f32
        array (de-normalised when statistics are given).  ``condition``
        (conditioned models) is frame-aligned: its leading dimension a whole
        multiple of ``length``."""
        length = self._max_seq_len if length is None else int(length)
        if not 0 < length <= self._max_seq_len:
            raise ValueError(f"length {length} outside (0, {self._max_seq_len}]")
        self.start()
        req = _Pending(str(text), length, condition=self._check_condition(condition, length))
        self._q.put(req)
        return req.future

    def submit_long(self, text: str, total_frames: int,
                    condition: Optional[np.ndarray] = None) -> Future:
        """Enqueue a long-form request of ``total_frames`` (any length),
        generated window by window; long requests of one group run in
        lockstep.  Resolves to [total_frames, input_feats]."""
        total_frames = int(total_frames)
        if total_frames <= 0:
            raise ValueError(f"total_frames {total_frames} must be > 0")
        self.start()
        req = _Pending(str(text), total_frames, long=True,
                       condition=self._check_condition(condition, total_frames))
        self._q.put(req)
        return req.future

    def generate(self, texts: Sequence[str], lengths: Optional[Sequence[int]] = None,
                 timeout: Optional[float] = None) -> list:
        """Submit all, wait for all (each at most ``timeout`` seconds)."""
        lengths = [None] * len(texts) if lengths is None else list(lengths)
        if len(lengths) != len(texts):
            raise ValueError(f"{len(texts)} texts but {len(lengths)} lengths")
        futures = [self.submit(t, n) for t, n in zip(texts, lengths)]
        return [f.result(timeout) for f in futures]

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            n = len(lat)
            return {
                "requests": self._requests,
                "dispatches": self._dispatches,
                "long_dispatches": self._long_dispatches,
                "mean_occupancy": (self._request_rows / self._dispatches
                                   if self._dispatches else 0.0),
                "padding_fraction": (self._padded_rows
                                     / max(1, self._request_rows + self._padded_rows)),
                # the percentiles cover the most recent window only
                "latency_p50_s": lat[n // 2] if n else None,
                "latency_p95_s": lat[min(n - 1, int(n * 0.95))] if n else None,
                "latency_window": n,
            }

    # -- dispatcher --------------------------------------------------------

    def _loop(self):
        # grad mode is per thread: without this every dispatch would record
        # an autograd graph
        with torch.inference_mode():
            max_bucket = self._buckets[-1]
            while True:
                first = self._q.get()
                if first is _STOP:
                    return
                group = [first]
                deadline = time.monotonic() + self._max_wait_s
                stop_after = False
                while len(group) < max_bucket:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        item = self._q.get(timeout=rem)
                    except queue.Empty:
                        break
                    if item is _STOP:
                        stop_after = True
                        break
                    group.append(item)
                self._dispatch(group)
                if stop_after:
                    return

    def _sample(self, batch, generator):
        if self._mesh is None:
            return self._arch.sample(batch, generator=generator,
                                     compute_dtype=self._compute_dtype,
                                     step_cache=self._step_cache)
        with self._comm_lock:
            self._send(("sample", batch, generator.get_state()))
            return self._mesh_sample(batch, generator)

    def _mesh_sample(self, batch, generator):
        return mesh_sample(self._arch, batch, self._mesh, generator=generator,
                           compute_dtype=self._compute_dtype, step_cache=self._step_cache)

    def _send(self, message):
        import torch.distributed as dist

        dist.broadcast_object_list([message], src=0, device=self._mesh.host_device)
        self._last_send = time.monotonic()

    def _receive(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, device=self._mesh.host_device)
        return box[0]

    def follow(self):
        """A mesh server's rank other than 0: sample this rank's rows of
        every call that rank 0 broadcasts, until rank 0 stops."""
        if self._mesh is None:
            raise ValueError("follow() serves a rank of a mesh server")
        with torch.inference_mode():
            while True:
                message = self._receive()
                if message[0] == "stop":
                    return
                if message[0] == "idle":
                    continue
                _, batch, state = message
                generator = torch.Generator(device=self._arch.device)
                generator.set_state(state)
                self._mesh_sample(batch, generator)

    def _dispatch(self, group):
        """Split a group by (long?, sequence bucket, condition signature),
        one dispatch each."""
        subgroups: dict = {}
        for g in group:
            if g.long:
                key = ("long", g.cond_sig())
            else:
                tb = next(t for t in self._seq_buckets if t >= g.length)
                key = (tb, g.cond_sig())
            subgroups.setdefault(key, []).append(g)
        for key in sorted(subgroups, key=str):
            if key[0] == "long":
                self._dispatch_long(subgroups[key])
            else:
                self._dispatch_bucket(subgroups[key], key[0])

    def _count(self, group, pad, long=False):
        """Book a dispatch; returns its generator."""
        with self._lock:
            index = self._dispatches
            self._dispatches += 1
            self._long_dispatches += int(long)
            self._requests += len(group)
            self._request_rows += len(group)
            self._padded_rows += pad
        return self.dispatch_generator(index)

    def _fulfil(self, group, outs):
        if self._std is not None:
            outs = [denormalize(o, self._mean, self._std) for o in outs]
        now = time.monotonic()
        with self._lock:
            self._latencies.extend(now - g.t_enqueue for g in group)
            del self._latencies[:-4096]
        for g, o in zip(group, outs):
            g.future.set_result(np.asarray(o, np.float32))

    def _dispatch_bucket(self, group, t_bucket):
        try:
            bucket = next(b for b in self._buckets if b >= len(group))
            pad = bucket - len(group)
            rows = group + [group[-1]] * pad
            lengths = np.asarray([g.length for g in rows], np.int32)[:, None]
            batch = make_text_batch([g.text for g in rows], t_bucket, self._input_feats,
                                    lengths=lengths)
            if group[0].condition is not None:
                # each condition zero-padded to the bucket's frames x the
                # group's shared per-frame rate
                rate = group[0].cond_sig()[0]
                c = np.zeros((bucket, t_bucket * rate) + group[0].condition.shape[1:],
                             np.float32)
                for i, g in enumerate(rows):
                    c[i, :g.condition.shape[0]] = g.condition
                batch["c"] = c
            generator = self._count(group, pad)
            out = self._sample(batch, generator).float().cpu().numpy()
            self._fulfil(group, [out[i, :g.length] for i, g in enumerate(group)])
        except Exception as e:  # noqa: BLE001 -- the dispatcher keeps serving
            for g in group:
                if not g.future.done():
                    g.future.set_exception(e)

    def _dispatch_long(self, group):
        """Window w of every request of the group in one sampling call
        (windowed_sample_batch; one request: windowed_sample), each window
        outpainting its overlap from the previous one.  Shorter requests
        ride padded windows whose outputs are dropped."""
        try:
            if self._mesh is not None and self._mesh.model_sharded:
                raise NotImplementedError("long-form requests of a model sharded over an "
                                          "expert or tensor axis: they run on rank 0 alone")
            bucket = next((b for b in self._buckets if b >= len(group)), len(group))
            pad = bucket - len(group)
            reqs = group + [group[-1]] * pad
            window, pre = self._window, self._pre_frames

            def make_maker(g):
                rate = None if g.condition is None else g.cond_sig()[0]

                def maker(start, end):
                    b = make_text_batch([g.text], window, self._input_feats)
                    if g.condition is not None:
                        c = np.zeros((window * rate,) + g.condition.shape[1:], np.float32)
                        seg = g.condition[start * rate:end * rate]
                        c[:seg.shape[0]] = seg
                        b["c"] = c[None]
                    return b
                return maker

            makers = [make_maker(g) for g in reqs]
            generator = self._count(group, pad, long=True)
            kw = dict(window=window, pre_frames=pre,
                      randn=generator_randn(generator, self._arch.device), use_repaint=True,
                      repaint=self._repaint or RepaintConfig(overlap_len=pre, add_blend=True),
                      compute_dtype=self._compute_dtype, step_cache=self._step_cache)
            covered = [covered_frames(g.length, window, pre) for g in reqs]
            if len(makers) == 1:
                outs = [windowed_sample(self._arch, makers[0], total_frames=covered[0], **kw)]
            else:
                outs = windowed_sample_batch(self._arch, makers, covered, **kw)
            self._fulfil(group, [o[:g.length] for g, o in zip(group, outs)])
        except Exception as e:  # noqa: BLE001 -- the dispatcher keeps serving
            for g in group:
                if not g.future.done():
                    g.future.set_exception(e)
