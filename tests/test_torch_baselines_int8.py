"""int8 inference of the baselines in the port against the JAX package's, on
the CPU, family by family (tests/torch_baseline_families.py), W8A8 and W8:
``int8_quantize_variables(min_elems=1)`` on the JAX side,
``int8_quantize_(min_elems=1)`` on the port's, both in f32 and, for the
composition, after the bf16 cast.

- The quantized leaves: the same flax paths on both sides (MotionDiffuse 32,
  MCM 24, MDM 2: its time MLP alone, since its encoder layers lie outside
  the audited scopes), and the JAX tree's int8 weights and scales equal the
  port's quantization bit for bit.
- One test forward: W8 within REL = 1e-4 x max(1, max |JAX|) (the f32 sums
  in another order, as tests/test_torch_quant.py holds the flagship's), W8A8
  within W8A8_REL = 2e-3 (an activation one f32 ulp apart can land on the
  other side of a rounding boundary of its int8 code: one code, 1/127 of its
  row's largest entry, in the next product).
- The whole ``sample`` on the JAX run's draws: W8 within REL, W8A8 within
  MODEL_REL = 5e-2 (those one-code steps add up over a chain, as in
  tests/test_torch_quant.py); bf16 + W8A8 (MCM: K5's bf16 instantiation
  on int8 projections; FineMoGen: K1/K2 bf16 beside W8A8 MoEs) within
  MODEL_REL.
"""

import jax
import numpy as np
import pytest
import torch

from motioncraft_tpu_torch.ops.quant import count_quantized
from torch_baseline_families import BF, FAMILIES, family
from torch_port_util import assert_close_scaled

REL = 1e-4
W8A8_REL = 2e-3
MODEL_REL = 5e-2
MODES = ("w8a8", "w8")
LEAVES = {"motiondiffuse": 32, "mcm": 24, "mdm": 2}


def _flat(tree, path=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.mark.parametrize("name", FAMILIES)
def test_int8_quantizes_the_jax_leaves(name):
    from motioncraft_tpu_torch.utils.convert import to_jax_variables

    pair = family(name)
    v = pair.jax_vars(int8="w8a8")
    want = {p: np.asarray(a) for p, a in _flat(v["params"]) if a.dtype == np.int8}
    arch_t = pair.port(int8="w8a8")
    n, _ = count_quantized(arch_t.model)
    assert n == len(want) == LEAVES.get(name, len(want)) and n > 0
    got = to_jax_variables(arch_t.model.state_dict())
    got_int8 = {p: np.asarray(a) for p, a in _flat(got["params"]) if a.dtype == np.int8}
    assert sorted(got_int8) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got_int8[p], want[p], err_msg=p)
    scales = dict(_flat(v["quant"]))
    got_scales = dict(_flat(got["quant"]))
    assert sorted(got_scales) == sorted(scales)
    for p in scales:
        np.testing.assert_array_equal(np.asarray(got_scales[p]), np.asarray(scales[p]),
                                      err_msg=p)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FAMILIES)
def test_int8_forward_matches_jax(name, mode):
    pair = family(name)
    v = pair.jax_vars(int8=mode)
    arch_t = pair.port(int8=mode)
    ex_j, ex_t = pair.extra(v, arch_t)
    x = np.random.RandomState(3).randn(*pair.batch["motion"].shape).astype(np.float32)
    ts = np.array([999, 321], np.int32)
    want = np.asarray(pair.jax_forward(v, x, ts, ex_j))
    got = pair.port_forward(arch_t, x, ts, ex_t)
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got.numpy(), want, REL if mode == "w8" else W8A8_REL,
                        f"{name} {mode} forward")


@pytest.mark.parametrize("name,mode", [(n, m) for n in FAMILIES for m in MODES]
                         + [("mcm", "bf16_w8a8"), ("finemogen", "bf16_w8a8")])
def test_int8_sample_matches_jax(name, mode):
    pair = family(name)
    bf16 = mode.startswith("bf16")
    int8 = mode.removeprefix("bf16_")
    v = pair.jax_vars(dtype=BF if bf16 else None, int8=int8)
    arch_t = pair.port(dtype=torch.bfloat16 if bf16 else None, int8=int8)
    ex_j, ex_t = pair.extra(v, arch_t)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(pair.jax_sample(v, rng, ex_j, dtype=BF if bf16 else None))
    got = pair.port_sample(arch_t, rng, ex_t, dtype=torch.bfloat16 if bf16 else None)
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 1e-2
    assert_close_scaled(got.numpy(), want, REL if mode == "w8" else MODEL_REL,
                        f"{name} {mode} sample")
