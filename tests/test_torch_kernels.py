"""The port's kernels K1-K6 against the Pallas kernels they replace.

On the CPU the same numpy inputs go through the Pallas kernel in interpret
mode, its jnp ``*_reference``, and the port's wrapper (which takes the plain
PyTorch version for a CPU tensor).  K4 must be bit-exact, sentinel ids
included, because the MoE capacity drops depend on the ranks; its route mode
is held against the JAX package's routing composed from its own functions
(integer outputs exact, gates within 1e-6: a 16-term softmax summed in
another order).  K1-K3, K5 and
K6 agree to 1e-5 x max |reference|: the Pallas kernels use an
Abramowitz-Stegun erf (error <= 1.5e-7) and the sums run in another order.
K6's bf16 instantiation (bf16 training): the Pallas kernel in interpret mode
on bf16 operands, ``_ffn_reference`` on them (what the JAX package's CPU
step computes) and the port's plain version on the same bf16 tensors agree
to 1e-2 x max |reference|: each rounds the hidden and the output to bf16
(ulp 3.9e-3 relative), the reference also after each product and bias.
K5 and K6 are also held backward: ``jax.grad`` through their custom VJP
against torch autograd, to the same tolerance; and the port's
backward-by-recompute (ops/recompute.py) is driven here with the plain
version as its forward.

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.ops import pallas_attention, pallas_ffn
from motioncraft_tpu.ops.linear_attention import masked_linear_attention
from motioncraft_tpu.ops.pallas_moe import _positions_pallas, _positions_xla
from motioncraft_tpu.ops.pallas_moe_ffn import grouped_ffn as jax_grouped_ffn
from motioncraft_tpu.ops.pallas_moe_ffn import grouped_ffn_reference
from motioncraft_tpu.ops.pallas_sffn import head_ffn as jax_head_ffn
from motioncraft_tpu.ops.pallas_sffn import head_ffn_reference
from motioncraft_tpu.ops.pallas_stma_attention import (
    stma_linear_attention as jax_stma, stma_linear_attention_reference)
from motioncraft_tpu_torch.ops import (COUNTED, KERNELS, expert_ffn_plain, fused_expert_ffn,
                                       fused_expert_ffn_bf16, fused_linear_attention,
                                       fused_linear_attention_plain,
                                       grouped_ffn, head_ffn, int_mm, launch_counts,
                                       moe_positions_counts, moe_route, reset_launch_counts,
                                       stma_linear_attention)
from motioncraft_tpu_torch.ops.moe_ffn import BLOCK
from motioncraft_tpu_torch.ops.recompute import with_recomputed_grad
from torch_port_util import grad_mode_on  # noqa: F401
from torch_port_util import check_route_invariants, route_logits, tutel_capacity

REL = 1e-5
BF16_REL = 1e-2  # two bf16 roundings of the hidden and the output, in other places
GATE_ATOL = 1e-6  # gates: a softmax over E terms summed in another order


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


def linear_attention_case(B, T, N, H, d, seed=0):
    rng = np.random.RandomState(seed)
    key = rng.randn(B, N, H, d).astype(np.float32)
    key[-1, N // 2:] -= 1e6  # masked keys, as callers mask them
    return (rng.randn(B, T, H, d).astype(np.float32), key,
            rng.randn(B, N, H, d).astype(np.float32))


def expert_ffn_case(E, C, D, F, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    xe = f(E, C, D)
    xe[:, C - C // 3:] = 0  # empty slots
    return xe, f(E, D, F) * D ** -0.5, f(E, F) * 0.1, f(E, F, D) * F ** -0.5, f(E, D) * 0.1


def jax_and_torch_grads(jax_fn, torch_fn, args, seed=7):
    """Gradients of sum(out * w) for one random w: jax.grad vs autograd."""
    out_shape = np.shape(jax.eval_shape(jax_fn, *args))
    w = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)
    argnums = tuple(range(len(args)))
    want = jax.grad(lambda *a: (jax_fn(*a) * w).sum(), argnums=argnums)(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad((torch_fn(*leaves) * torch.from_numpy(w)).sum(), leaves)
    return got, want


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


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_route(logits, K, capacity, block):
    """The JAX package's rank-compact routing (motioncraft_tpu/models/moe.py,
    eval, fused FFN), composed from its own functions, jitted as the package
    runs it; with the k-major expert ids for K4's Pallas kernel."""
    N, E = logits.shape
    scores = jax.nn.softmax(logits, axis=1)
    topk_scores, topk_idx = jax.lax.top_k(scores, K)
    gates = topk_scores / (topk_scores.sum(axis=1, keepdims=True) + 1e-9)
    flat_idx = topk_idx.T.reshape(-1)
    pos_flat, counts = _positions_xla(flat_idx, E)
    positions = pos_flat.reshape(K, N).T
    valid = positions < capacity
    gates = gates * valid.astype(gates.dtype)
    fill_aligned = (jnp.minimum(counts, capacity) + block - 1) // block * block
    M = (N * K + block - 1) // block * block + E * block
    offset = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(fill_aligned)[:-1]])
    rank = offset[topk_idx] + positions
    oob = M + 1 + jnp.arange(N * K, dtype=jnp.int32)
    token_ids = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, K)).reshape(-1)
    token_for_rank = jnp.zeros((M + 1,), jnp.int32).at[
        jnp.where(valid.reshape(-1), rank.reshape(-1), oob)].set(
            token_ids, unique_indices=True, mode="drop")
    block_expert = jnp.clip(jnp.searchsorted(jnp.cumsum(fill_aligned),
                                             jnp.arange(M // block, dtype=jnp.int32) * block,
                                             side="right"), 0, E - 1)
    ge = jnp.einsum("nk,nke->ne", gates, jax.nn.one_hot(topk_idx, E, dtype=gates.dtype))
    return {"gates": gates, "r": jnp.where(valid, rank, M),
            "token_for_rank": token_for_rank[:M], "block_expert": block_expert, "ge": ge,
            "counts": counts, "flat_idx": flat_idx, "pos_flat": pos_flat}


@pytest.mark.parametrize("kind", ["balanced", "skewed", "ties"])
@pytest.mark.parametrize("N", [1, 7, 600, 5000])
@pytest.mark.parametrize("E,K", [(4, 1), (4, 2), (16, 1), (16, 2)])
def test_k4_route_matches_jax_routing(E, K, N, kind):
    """moe_route on the CPU (its plain version) against the JAX package's
    routing on the same logits: integer outputs exact, gates within
    GATE_ATOL; skewed logits overflow an expert's capacity (drops), integer
    logits tie (the lower expert index first, as lax.top_k takes it)."""
    logits = route_logits(N, E, kind, seed=N + 10 * E + K)
    capacity = tutel_capacity(N, E, K)
    got = moe_route(torch.from_numpy(logits), K, capacity, BLOCK)
    want = jax_route(jnp.asarray(logits), K, capacity, BLOCK)
    np.testing.assert_array_equal(  # K4's ranks, as the Pallas kernel gives them
        _positions_pallas(want["flat_idx"], E, block_rows=1024, interpret=True),
        want["pos_flat"])
    for name, value in got._asdict().items():
        ref = np.asarray(want[name])
        assert value.shape == ref.shape, name
        if value.dtype == torch.float32:
            np.testing.assert_allclose(value.numpy(), ref, rtol=0, atol=GATE_ATOL, err_msg=name)
        else:
            assert value.dtype == torch.int32, name
            np.testing.assert_array_equal(value.numpy(), ref, err_msg=name)
    check_route_invariants(got, capacity)
    if kind == "skewed" and N >= 7:  # drops
        assert int(got.counts.max()) > capacity
        assert bool((got.r == got.token_for_rank.numel()).any())


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


@pytest.mark.parametrize("B,T,N,H,d", [(3, 21, 30, 3, 16), (2, 9, 86, 2, 64),
                                       (2, 13, 20, 2, 128)])
def test_k5_linear_attention(B, T, N, H, d):
    args = linear_attention_case(B, T, N, H, d)
    jargs = [jnp.asarray(a) for a in args]
    pallas = pallas_attention.fused_linear_attention(*jargs, True)
    ref = masked_linear_attention(*jargs)
    got = fused_linear_attention(*(torch.from_numpy(a) for a in args))
    close(pallas, ref)
    close(got.numpy(), ref)
    grads, want = jax_and_torch_grads(
        lambda q, k, v: pallas_attention.fused_linear_attention(q, k, v, True),
        fused_linear_attention, args)
    for g, w in zip(grads, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("E,C,D,F", [(3, 37, 128, 512), (2, 70, 256, 1024)])
def test_k6_expert_ffn(E, C, D, F):
    args = expert_ffn_case(E, C, D, F)
    jargs = [jnp.asarray(a) for a in args]
    pallas = pallas_ffn.fused_expert_ffn(*jargs, True)
    ref = pallas_ffn._ffn_reference(*jargs)
    got = fused_expert_ffn(*(torch.from_numpy(a) for a in args))
    close(pallas, ref)
    close(got.numpy(), ref)
    grads, want = jax_and_torch_grads(
        lambda *a: pallas_ffn.fused_expert_ffn(*a, True), fused_expert_ffn, args)
    for g, w in zip(grads, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("E,C,D,F", [(3, 37, 128, 512), (2, 70, 256, 1024)])
def test_k6_bf16_expert_ffn(E, C, D, F):
    """bf16 operands: Pallas (interpret) == _ffn_reference == the port's
    plain version, each in bf16; the port's gradient is the plain one's."""
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in expert_ffn_case(E, C, D, F)]
    targs = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
             for a in jargs]
    pallas = pallas_ffn.fused_expert_ffn(*jargs, True)
    ref = pallas_ffn._ffn_reference(*jargs)
    got = fused_expert_ffn_bf16(*targs)
    assert pallas.dtype == ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert torch.equal(got, fused_expert_ffn(*targs))  # the f32 wrapper hands it on
    scale = BF16_REL * float(np.abs(np.asarray(ref, np.float32)).max())
    np.testing.assert_allclose(np.asarray(pallas, np.float32), np.asarray(ref, np.float32),
                               rtol=0, atol=scale)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=scale)


@pytest.mark.parametrize("plain,case", [
    (fused_linear_attention_plain, lambda: linear_attention_case(2, 7, 11, 3, 16)),
    (expert_ffn_plain, lambda: expert_ffn_case(2, 9, 32, 64))])
def test_backward_by_recompute(plain, case):
    """The autograd.Function the CUDA wrappers use, with the plain version as
    its forward too: the same gradients as native autograd, for the inputs
    that need one (the last input here does not)."""
    args = case()
    leaves = [torch.from_numpy(a).requires_grad_(i < len(args) - 1)
              for i, a in enumerate(args)]
    w = torch.from_numpy(np.random.RandomState(3).randn(
        *plain(*leaves).shape).astype(np.float32))
    got = torch.autograd.grad((with_recomputed_grad(plain, plain, *leaves) * w).sum(),
                              leaves[:-1])
    want = torch.autograd.grad((plain(*leaves) * w).sum(), leaves[:-1])
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    reset_launch_counts()
    grouped_ffn(*(torch.from_numpy(a) for a in grouped_case(2, 32, 32, [0, 1])))
    fused_linear_attention(*(torch.from_numpy(a) for a in linear_attention_case(1, 3, 4, 1, 16)))
    fused_expert_ffn(*(torch.from_numpy(a) for a in expert_ffn_case(1, 3, 32, 32)))
    fused_expert_ffn_bf16(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in expert_ffn_case(1, 3, 32, 32)))
    int_mm(torch.ones(3, 5, dtype=torch.int8), torch.ones(5, 7, dtype=torch.int8))
    assert launch_counts() == {name: 0 for name in COUNTED}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_other_devices_raise(name):
    wrapper, _ = KERNELS[name]
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    args = {"moe_positions": (meta(8).int(), 4), "moe_route": (meta(8, 4), 2, 4, BLOCK),
            "grouped_ffn": (meta(1).int(), meta(BLOCK, 32), meta(1, 32, 32),
                            meta(1, 32), meta(1, 32, 32)),
            "head_ffn": (meta(4, 64), meta(2, 32, 32), meta(2, 32), meta(2, 32, 32),
                         meta(2, 32)),
            "stma_linear_attention": (meta(1, 2, 2, 128), meta(1, 3, 64),
                                      meta(1, 2, 1), meta(1, 1, 1)),
            "fused_linear_attention": (meta(1, 2, 2, 16), meta(1, 3, 2, 16),
                                       meta(1, 3, 2, 16)),
            "fused_expert_ffn": (meta(2, 5, 32), meta(2, 32, 64), meta(2, 64),
                                 meta(2, 64, 32), meta(2, 32))}[name.removesuffix("_bf16")]
    if name.endswith("_bf16"):  # the bf16 instantiations, on bf16 operands
        args = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*args)
