"""The baseline families at tiny widths, each as a pair of the JAX package's
architecture and the port's on one seeded tree, for the tests that hold the
port's low-precision inference of the baselines against the JAX package's
(tests/test_torch_baselines_bf16.py, tests/test_torch_baselines_int8.py).

A family is built from the configs of its own parity test (MotionDiffuse,
MCM and MDM at DDPM-20 from test_torch_baselines.py, FineMoGen at DDIM-4
from test_torch_finemogen.py, ReMoDiffuse and MoMatMoGen at DDIM-5 with an
encoded retrieval from test_torch_remodiffuse.py, the MCM ControlNet on
music features at DDIM-4 from test_torch_mcm_controlnet.py).  ``Pair``
holds what a comparison needs: both architectures, the f32 variables, the
batch, the draws of a sample, and the extra denoiser inputs of each side
(the retrieval, the encoded condition), made for a compute dtype.

``record_k5`` records the dtypes (q, k, v, out) of every call of kernel K5
on both sides: on the JAX side the default dispatch ``linear_attention``
(the Efficient attentions) and ``linear_attention_core`` (the
semantics-modulated ones, on their softmaxes, which keep their operands'
dtypes), on the port's side ``fused_linear_attention`` as the attentions
call it.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
import test_torch_baselines as tb
import test_torch_finemogen as tf
import test_torch_mcm_controlnet as tm
import test_torch_remodiffuse as tr
from motioncraft_tpu.apis.factory import bf16_cast_variables, int8_quantize_variables
from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.models import attentions as port_att
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_variables
from torch_port_util import Replay, jax_ddpm_draws, jax_sample_draws, seeded_params, t

FAMILIES = ("motiondiffuse", "mcm", "mdm", "finemogen", "remodiffuse", "momatmogen",
            "mcm_controlnet")
BF = jnp.bfloat16


class Pair:
    """One family on both sides: ``arch_j`` / ``variables`` (numpy, f32) and
    ``arch_t`` (f32, loaded), ``batch``, ``steps`` of its sampler."""

    def __init__(self, name, arch_j, variables, arch_t, batch, steps, ddpm,
                 retrieval=None, condition=False):
        self.name, self.arch_j, self.variables, self.arch_t = name, arch_j, variables, arch_t
        self.batch, self.steps, self.ddpm = batch, steps, ddpm
        self.retrieval, self.condition = retrieval, condition

    def jax_vars(self, dtype=None, int8=None):
        """The variables as JAX arrays: cast to bf16 with ``dtype``, then
        int8 (``"w8a8"`` / ``"w8"``) at ``min_elems=1``, as tools/test.py
        orders them."""
        v = jax.tree_util.tree_map(jnp.asarray, self.variables)
        if dtype is not None:
            v = bf16_cast_variables(v)
        if int8 is not None:
            v = int8_quantize_variables(v, min_elems=1, weight_only=int8 == "w8")
        return v

    def port(self, dtype=None, int8=None):
        """A fresh port architecture with the variables, cast and quantized
        as ``jax_vars``."""
        from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_

        arch = build_torch(self.cfg(), device="cpu")
        arch.model.load_state_dict(from_jax_variables(self.variables), strict=True)
        if dtype is not None:
            bf16_cast_(arch)
        if int8 is not None:
            int8_quantize_(arch, weight_only=int8 == "w8", min_elems=1)
        return arch

    def extra(self, v, arch_t, dtype=None):
        """(JAX extra denoiser kwargs, the port's): ReMoDiffuse's encoded
        retrieval (f32 on both sides, as the JAX package encodes it from the
        bank's f32 rows on the cast weights) or the ControlNet's encoded
        condition (encoded in f32 and cast to the compute dtype, as sampling
        encodes it)."""
        if self.retrieval is not None:
            rows = self.retrieval
            re_j = self.arch_j.model.apply(v, *rows, tr.R, method="encode_retrieval")
            with torch.no_grad():
                re_t = arch_t.model.encode_retrieval(*(t(a) for a in rows), tr.R)
            return {"re_dict": re_j}, {"re_dict": re_t}
        if self.condition:
            c = self.batch["c"]
            c_j = self.arch_j.model.apply(v, jnp.asarray(c), tm.T, method="encode_condition")
            with torch.no_grad():
                c_t = arch_t.model.encode_condition(t(c), tm.T)
            if dtype is not None:
                c_j, c_t = c_j.astype(BF), c_t.to(torch.bfloat16)
            return {"c_enc": c_j}, {"c_enc": c_t}
        return {}, {}

    def draws(self, rng):
        shape = self.batch["motion"].shape
        if self.ddpm:
            return Replay(jax_ddpm_draws(self.steps, rng, shape))
        return Replay(jax_sample_draws(self.steps, None, rng, shape))

    def jax_forward(self, v, x, ts, extra, dtype=None, capture=False):
        """The JAX test forward of ``x`` at ``ts``, jitted, in ``dtype``
        (the text condition cast as sampling casts it); with ``capture``,
        (output, {port module name: each MoE gate's logits}, the output
        module's rows before the CFG mix)."""
        batch = self.batch
        enc = self.arch_j.encode_text(v, batch["text_ids"])
        xp, xf = enc if isinstance(enc, tuple) else (None, enc)
        xin = jnp.asarray(x, dtype or jnp.float32)
        if dtype is not None:
            xf = xf.astype(dtype)
        kw = {} if xp is None else {"xf_proj": xp}
        # the batch goes in as arguments, traced as the JAX CLIs trace it (a
        # numpy mask closed over would promote under numpy's rules)
        if capture:
            kw.update(capture_intermediates=True, mutable=["intermediates"])
        out = jax.jit(lambda v_, x_, m, ml, xf_, e_: self.arch_j.model.apply(
            v_, x_, jnp.asarray(ts), motion_mask=m, motion_length=ml, xf_out=xf_,
            mode="test", **kw, **e_))(
            v, xin, batch["motion_mask"], batch["motion_length"], xf, extra)
        if not capture:
            return out
        out, state = out
        logits = {}
        for path, a in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
            keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
            if keys[-3:-1] == ["gate", "__call__"]:
                logits[".".join(keys[:-2])] = np.asarray(a)
        rows = state["intermediates"]["out"]["__call__"][0]
        return out, logits, rows

    def port_forward(self, arch_t, x, ts, extra, dtype=None):
        batch = self.batch
        with torch.no_grad():
            enc = arch_t.encode_text(batch["text_ids"])
            xp, xf = enc if isinstance(enc, tuple) else (None, enc)
            kw = dict(extra)
            if xp is not None:
                kw["xf_proj"] = xp.to(dtype or torch.float32)
            if dtype is not None:
                xf = xf.to(dtype)
            if getattr(arch_t.model, "precompute_text_feats", None) is not None:
                kw["text_feats"] = arch_t.model.precompute_text_feats(xf)
            return arch_t.model(t(x).to(dtype or torch.float32), t(ts, torch.long),
                                motion_mask=t(batch["motion_mask"]),
                                motion_length=t(batch["motion_length"]), xf_out=xf, **kw)

    def jax_sample(self, v, rng, extra, dtype=None):
        kw = {} if not self.retrieval else {"extra_model_kwargs": {"re_dict": extra["re_dict"]}}
        return jax.jit(lambda v_, b, r: self.arch_j.sample(v_, b, r, compute_dtype=dtype,
                                                           **kw))(v, self.batch, rng)

    def port_sample(self, arch_t, rng, extra, dtype=None):
        kw = {} if not self.retrieval else {"extra_model_kwargs": {"re_dict": extra["re_dict"]}}
        draws = self.draws(rng)
        out = arch_t.sample(self.batch, randn=draws, compute_dtype=dtype, **kw)
        assert draws.done()
        return out


def _seeded_pair(name, cfg, batch, seed, steps, ddpm, **kw):
    arch_j = build_jax(cfg())
    variables = jax.tree_util.tree_map(np.asarray, arch_j.init(jax.random.PRNGKey(0), batch))
    variables = {"params": seeded_params(variables["params"], seed)}
    arch_t = build_torch(cfg(), device="cpu")
    arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    pair = Pair(name, arch_j, variables, arch_t, batch, steps, ddpm, **kw)
    pair.cfg = cfg
    return pair


@functools.lru_cache(maxsize=None)
def family(name):
    """The ``Pair`` of one of ``FAMILIES`` (built once a process)."""
    if name in ("motiondiffuse", "mcm", "mdm"):
        return _seeded_pair(name, tb.FAMILIES[name], tb._batch(), 1, tb.STEPS, True)
    if name == "finemogen":
        # the JAX package samples FineMoGen with its text hoist off
        arch_j = build_jax(tf.finemogen_cfg(text_hoist=False))
        batch = tf._batch()
        variables = jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda: arch_j.init(jax.random.PRNGKey(0), batch))())
        variables = {"params": seeded_params(variables["params"], 1)}
        arch_t = build_torch(tf.finemogen_cfg(), device="cpu")
        arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
        pair = Pair(name, arch_j, variables, arch_t, batch, tf.STEPS, False)
        pair.cfg = tf.finemogen_cfg
        return pair
    if name in ("remodiffuse", "momatmogen"):
        dual = name == "momatmogen"
        arch_j, params, arch_t = tr._seeded(dual)
        pair = Pair(name, arch_j, {"params": params}, arch_t, tr._batch(dual), tr.STEPS,
                    False, retrieval=tr._retrieved())
        pair.cfg = functools.partial(tr.arch_cfg, dual)
        return pair
    if name == "mcm_controlnet":
        cfg = functools.partial(tm.arch_cfg, "music")
        batch = tm._batch("music")
        arch_j = build_jax(cfg())
        variables = tm.seeded_variables(arch_j.init(jax.random.PRNGKey(0), batch), 1)
        arch_t = build_torch(cfg(), device="cpu")
        arch_t.model.load_state_dict(from_jax_variables(variables), strict=True)
        pair = Pair(name, arch_j, variables, arch_t, batch, 4, False, condition=True)
        pair.cfg = cfg
        return pair
    raise KeyError(name)


@contextlib.contextmanager
def pinned_gates(model, logits):
    """Every MoE gate of the port's ``model`` returns the JAX run's logits
    (``jax_forward(capture=True)``): bf16 moves near-tied expert picks
    between the two frameworks, as tests/test_torch_bf16.py pins them.
    Yields the names of the gates that ran."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate

    seen = []

    def pin(name):
        def hook(mod, inp, out):
            seen.append(name)
            return torch.from_numpy(logits[name]).to(out.dtype)
        return hook

    handles = [m.register_forward_hook(pin(n)) for n, m in model.named_modules()
               if isinstance(m, CosineTopGate)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def record_k5():
    """Yields (JAX calls, port calls): each K5 call's (q, k, v, out) dtype
    names, in call order."""
    jax_calls, port_calls = [], []
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    j_la, j_core, p_la = (jax_att.linear_attention, jax_att.linear_attention_core,
                          port_att.fused_linear_attention)

    def jax_rec(fn):
        def call(q, k, v, *a, **kw):
            out = fn(q, k, v, *a, **kw)
            jax_calls.append(tuple(x.dtype.name for x in (q, k, v, out)))
            return out
        return call

    def port_rec(q, k, v):
        out = p_la(q, k, v)
        port_calls.append(tuple(names[x.dtype] for x in (q, k, v, out)))
        return out

    jax_att.linear_attention, jax_att.linear_attention_core = jax_rec(j_la), jax_rec(j_core)
    port_att.fused_linear_attention = port_rec
    try:
        yield jax_calls, port_calls
    finally:
        jax_att.linear_attention, jax_att.linear_attention_core = j_la, j_core
        port_att.fused_linear_attention = p_la
