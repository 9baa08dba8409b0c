"""The port's kernels K1-K4 against the Pallas kernels they replace.

On the CPU the same numpy inputs go through the Pallas kernel in interpret
mode, its jnp ``*_reference``, and the port's wrapper (which takes the plain
PyTorch version for a CPU tensor).  K4 must be bit-exact, sentinel ids
included, because the MoE capacity drops depend on the ranks.  K1-K3 agree to
1e-5 x max |reference|: the Pallas kernels use an Abramowitz-Stegun erf
(error <= 1.5e-7) and the sums run in another order.

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.ops.pallas_moe import _positions_pallas, _positions_xla
from motioncraft_tpu.ops.pallas_moe_ffn import grouped_ffn as jax_grouped_ffn
from motioncraft_tpu.ops.pallas_moe_ffn import grouped_ffn_reference
from motioncraft_tpu.ops.pallas_sffn import head_ffn as jax_head_ffn
from motioncraft_tpu.ops.pallas_sffn import head_ffn_reference
from motioncraft_tpu.ops.pallas_stma_attention import (
    stma_linear_attention as jax_stma, stma_linear_attention_reference)
from motioncraft_tpu_torch.ops import (KERNELS, grouped_ffn, head_ffn,
                                       launch_counts, moe_positions_counts,
                                       reset_launch_counts, stma_linear_attention)
from motioncraft_tpu_torch.ops.moe_ffn import BLOCK

REL = 1e-5


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=REL * float(np.abs(np.asarray(want)).max()))


def positions_case(M, E, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, E, (M,)).astype(np.int32)
    idx[rng.rand(M) < 0.05] = E + rng.randint(0, 3)  # sentinel ids >= E
    return idx


def grouped_case(E, D, HID, block_expert, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (np.asarray(block_expert, np.int32), f(len(block_expert) * BLOCK, D),
            f(E, D, HID) * 0.05, f(E, HID) * 0.1, f(E, HID, D) * 0.05)


def head_case(n, H, d, f_, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (f(n, H * d), f(H, d, f_) * 0.05, f(H, f_) * 0.1, f(H, f_, d) * 0.05,
            f(H, d) * 0.1)


def stma_case(B, T, H, d, TXT, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, T // 2:] = 0
    mask[-1, 4:] = 0
    tcond = (np.arange(B) < B // 2).astype(np.float32).reshape(B, 1, 1)
    return (rng.randn(B, T, H, 4 * d).astype(np.float32),
            rng.randn(B, TXT, 2 * d).astype(np.float32), mask, tcond)


@pytest.mark.parametrize("M,E,R", [(10000, 16, 2048), (1000, 4, 256), (1, 16, 256)])
def test_k4_positions_bit_exact(M, E, R):
    idx = positions_case(M, E, seed=M)
    pallas = np.asarray(_positions_pallas(jnp.asarray(idx), E, block_rows=R, interpret=True))
    xla_pos, xla_counts = (np.asarray(a) for a in _positions_xla(jnp.asarray(idx), E))
    pos, counts = moe_positions_counts(torch.from_numpy(idx), E)
    assert pos.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(pallas, xla_pos)
    np.testing.assert_array_equal(pos.numpy(), xla_pos)
    np.testing.assert_array_equal(counts.numpy(), xla_counts)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(idx[idx < E], minlength=E))


@pytest.mark.parametrize("E,D,HID,block_expert", [(4, 128, 256, [0, 1, 1, 3]),
                                                  (2, 128, 128, [1, 0])])
def test_k1_grouped_ffn(E, D, HID, block_expert):
    args = grouped_case(E, D, HID, block_expert)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jax_grouped_ffn(*jargs, interpret=True)
    ref = grouped_ffn_reference(args[0], *jargs[1:])
    got = grouped_ffn(*(torch.from_numpy(a) for a in args))
    close(pallas, ref)
    close(got.numpy(), ref)


@pytest.mark.parametrize("n", [512, 700])
def test_k2_head_ffn(n):
    args = head_case(n, 3, 128, 256)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jax_head_ffn(*jargs, interpret=True)
    ref = head_ffn_reference(*jargs)
    got = head_ffn(*(torch.from_numpy(a) for a in args))
    close(pallas, ref)
    close(got.numpy(), ref)


@pytest.mark.parametrize("B,T,H,d,TXT", [(4, 21, 3, 128, 7), (2, 9, 2, 128, 77)])
def test_k3_stma_attention(B, T, H, d, TXT):
    args = stma_case(B, T, H, d, TXT)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jax_stma(*jargs, interpret=True)
    ref = stma_linear_attention_reference(*jargs)
    got = stma_linear_attention(*(torch.from_numpy(a) for a in args))
    close(pallas, ref)
    close(got.numpy(), ref)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    reset_launch_counts()
    grouped_ffn(*(torch.from_numpy(a) for a in grouped_case(2, 32, 32, [0, 1])))
    assert launch_counts() == {name: 0 for name in KERNELS}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_other_devices_raise(name):
    wrapper, _ = KERNELS[name]
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    args = {"moe_positions": (meta(8).int(), 4),
            "grouped_ffn": (meta(1).int(), meta(BLOCK, 32), meta(1, 32, 32),
                            meta(1, 32), meta(1, 32, 32)),
            "head_ffn": (meta(4, 64), meta(2, 32, 32), meta(2, 32), meta(2, 32, 32),
                         meta(2, 32)),
            "stma_linear_attention": (meta(1, 2, 2, 128), meta(1, 3, 64),
                                      meta(1, 2, 1), meta(1, 1, 1))}[name]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*args)
