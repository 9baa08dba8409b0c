"""bf16 inference of the baselines in the port against the JAX package's,
on the CPU, family by family (tests/torch_baseline_families.py: MotionDiffuse,
MCM, MDM, FineMoGen, ReMoDiffuse, MoMatMoGen and the MCM ControlNet at
tiny widths, on one seeded tree): ``bf16_cast_variables`` and
``compute_dtype=bfloat16`` on the JAX side, ``bf16_cast_`` and
``compute_dtype=torch.bfloat16`` on the port's.

- One test forward in bf16 (FineMoGen's MoE gates pinned to the JAX run's
  logits, as tests/test_torch_bf16.py pins the flagship's): the dtypes of every K5 call, (q, k, v, out),
  in call order, equal on both sides (jitted, as the JAX CLIs sample; the
  output dtype of a call decides whether the layers after it run in bf16 or
  f32), and the output within MODEL_REL = 5e-2 x max(1, max |JAX|), the
  bound of tests/test_torch_bf16.py: the two frameworks round bf16 at other
  places (XLA's bf16 softmaxes and einsums against K5's plain bf16
  version, which rounds as the Pallas kernel does).
- The whole ``sample`` in bf16 (DDPM-20 or DDIM) on the JAX run's draws,
  within MODEL_REL.
- FineMoGen's SAMI alone in bf16 (its MoE gates pinned), within MODEL_REL.
- FineMoGen's DDIM sample with ``StepCacheConfig(reuse_every=2)`` against
  the JAX package's, in f32 within 1e-4 x scale (tests/test_torch_sample.py's
  bound) and in bf16 within MODEL_REL; its all-compute flags give the
  uncached sample bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.diffusion import StepCacheConfig as JaxStepCache
from motioncraft_tpu_torch.diffusion import StepCacheConfig
from torch_baseline_families import BF, FAMILIES, family, pinned_gates, record_k5
from torch_port_util import assert_close_scaled

MODEL_REL = 5e-2
REL = 1e-4


def _x(pair, seed=3):
    return np.random.RandomState(seed).randn(*pair.batch["motion"].shape).astype(np.float32)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_forward_matches_jax(name):
    pair = family(name)
    v = pair.jax_vars(dtype=BF)
    arch_t = pair.port(dtype=torch.bfloat16)
    ex_j, ex_t = pair.extra(v, arch_t, dtype=BF)
    x, ts = _x(pair), np.array([999, 321], np.int32)
    moe = name == "finemogen"
    with record_k5() as (jax_calls, port_calls):
        want = pair.jax_forward(v, x, ts, ex_j, dtype=BF, capture=moe)
        if moe:  # the port's gates fed the JAX logits
            want, logits, rows_j = want
            rows_t = []
            hook = arch_t.model.out.register_forward_hook(lambda m, i, o: rows_t.append(o))
            with pinned_gates(arch_t.model, logits) as seen:
                got = pair.port_forward(arch_t, x, ts, ex_t, dtype=torch.bfloat16)
            hook.remove()
            assert sorted(seen) == sorted(logits) and len(logits) == 4
            # the CFG-doubled rows before the mix
            assert_close_scaled(rows_t[0].float().numpy(), np.asarray(rows_j, np.float32),
                                MODEL_REL, f"{name} bf16 rows before the CFG mix")
        else:
            got = pair.port_forward(arch_t, x, ts, ex_t, dtype=torch.bfloat16)
    want = np.asarray(want, np.float32)
    assert port_calls == jax_calls, (port_calls, jax_calls)
    assert (len(jax_calls) > 0) == (name not in ("mdm", "finemogen"))  # no K5 in those
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got.float().numpy(), want, MODEL_REL * _cfg_gain(pair),
                        f"{name} bf16 forward")


def _cfg_gain(pair):
    """How far a guided family's mix moves a difference of its rows:
    FineMoGen's ``uncond + s (cond - uncond)`` multiplies the rows' bf16
    roundings by |s| + |1 - s| (12 at s = 6.5); the other families' mixes
    weigh rows that differ as little (1 for MotionDiffuse and MCM, which
    have no guidance; MDM's guide_scale and ReMoDiffuse's four weights at
    these configs stay within the bound as they are)."""
    if pair.name != "finemogen":
        return 1.0
    s = pair.cfg()["model"]["scale_func_cfg"]["scale"]
    return abs(s) + abs(1 - s)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_sample_matches_jax(name):
    pair = family(name)
    v = pair.jax_vars(dtype=BF)
    arch_t = pair.port(dtype=torch.bfloat16)
    ex_j, ex_t = pair.extra(v, arch_t)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(pair.jax_sample(v, rng, ex_j, dtype=BF))
    got = pair.port_sample(arch_t, rng, ex_t, dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got.numpy(), want, MODEL_REL, f"{name} bf16 sample")


@pytest.mark.parametrize("NI,B", [(1, 2), (2, 4)])
def test_sami_bf16_matches_jax(NI, B):
    """FineMoGen's SAMI alone in bf16 (its template FFNs, Gaussian time
    kernel and Taylor basis; with NI = 2 each pair of rows one sequence of
    intervals): flax on ``bf16_cast_variables`` against the port on
    ``bf16_cast_``-rounded weights, bf16 inputs, the MoE gates pinned to the
    JAX run's logits, within MODEL_REL x max(1, max |JAX|).  Each side
    rounds its elementwise chains at its own places (XLA fuses them)."""
    import test_torch_finemogen as tf
    from motioncraft_tpu.apis.factory import bf16_cast_variables
    from motioncraft_tpu.models import attentions as jax_att
    from motioncraft_tpu_torch.models import attentions as port_att
    from motioncraft_tpu_torch.utils.convert import from_jax_params
    from torch_port_util import seeded_params

    rng = np.random.RandomState(5)
    T, H, L = tf.T, tf.H, tf.LAT
    x = rng.randn(B, T, H * L).astype(np.float32)
    xf = rng.randn(B, 77, 16).astype(np.float32)
    emb = rng.randn(B, tf.TE).astype(np.float32)
    lengths = np.array([[T], [9], [12], [5]][:B], np.int32)
    mask = (np.arange(T)[None] < lengths).astype(np.float32)[..., None]
    cond = np.array([1, 1, 0, 0][:B], np.float32).reshape(B, 1, 1)
    flax_m = jax_att.SAMI(**tf.SAMI_KW)
    kw = dict(xf=xf, emb=emb, src_mask=mask, cond_type=cond, motion_length=lengths)
    variables = jax.jit(lambda: flax_m.init(jax.random.PRNGKey(0), x, **kw))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 2)
    vb = bf16_cast_variables({"params": jax.tree_util.tree_map(jnp.asarray, params)})
    bkw = {k: jnp.asarray(v, BF) for k, v in kw.items() if k != "motion_length"}
    want, state = jax.jit(lambda v: flax_m.apply(
        v, jnp.asarray(x, BF), motion_length=lengths, num_intervals=NI, **bkw,
        capture_intermediates=True, mutable=["intermediates"]))(vb)
    logits = {}
    for path, a in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-3:-1] == ["gate", "__call__"]:
            logits[".".join(keys[:-2])] = np.asarray(a)
    port = port_att.SAMI(**tf.SAMI_KW).eval()
    port.load_state_dict(from_jax_params(params), strict=True)
    port.to(torch.bfloat16)
    for name, m in port.named_modules():  # flax promotes the gate's projector
        if name.rpartition(".")[2] == "cosine_projector":
            m.to(torch.float32)
    bf = lambda a: torch.tensor(np.asarray(jnp.asarray(a, BF).astype(jnp.float32))).to(
        torch.bfloat16)  # noqa: E731
    with pinned_gates(port, logits) as seen, torch.no_grad():
        got = port(bf(x), xf=bf(xf), emb=bf(emb), src_mask=bf(mask), cond_type=bf(cond),
                   motion_length=torch.from_numpy(lengths), num_intervals=NI)
    assert sorted(seen) == sorted(logits) and len(logits) == 2
    assert want.dtype == BF and got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert np.abs(want - x).max() > 1e-2  # the attention's residual is not zero
    assert_close_scaled(got.float().numpy(), want, MODEL_REL, f"SAMI bf16 NI={NI} B={B}")


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_finemogen_step_cache_matches_jax(dtype):
    """Every 2nd DDIM step of each layer replays its cached residual over
    the CFG-doubled batch (warmup and tail 1, so that DDIM-4 reuses step
    1); both packages reuse the same (step, layer) pairs (the same flags of
    the same schedule)."""
    pair = family("finemogen")
    jdt, tdt = (BF, torch.bfloat16) if dtype else (None, None)
    v = pair.jax_vars(dtype=jdt)
    arch_t = pair.port(dtype=tdt)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda v_, b, r: pair.arch_j.sample(
        v_, b, r, compute_dtype=jdt,
        step_cache=JaxStepCache(reuse_every=2, warmup=1, tail=1)))(
        v, pair.batch, rng))
    cache = StepCacheConfig(reuse_every=2, warmup=1, tail=1)
    assert arch_t.model.supports_step_cache
    draws = pair.draws(rng)
    got = arch_t.sample(pair.batch, randn=draws, compute_dtype=tdt, step_cache=cache)
    assert draws.done() and np.abs(want).max() > 1e-2
    assert_close_scaled(got.numpy(), want, MODEL_REL if dtype else REL,
                        f"FineMoGen step cache {dtype or 'f32'}")
    # all-compute flags are the uncached stack, bit for bit
    flags = np.zeros((pair.steps, arch_t.model.num_layers), bool)
    plain = arch_t.sample(pair.batch, randn=pair.draws(rng), compute_dtype=tdt)
    full = arch_t.sample(pair.batch, randn=pair.draws(rng), compute_dtype=tdt,
                         step_cache=StepCacheConfig(flags=flags))
    assert torch.equal(plain, full)
    assert not torch.equal(plain, got)
