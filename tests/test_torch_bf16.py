"""bf16 inference of the port against the JAX package's, on the CPU.

- Each kernel: the Pallas kernel in interpret mode on bf16 operands against
  the port's plain bf16 version (the one its CUDA wrapper is held against on
  the card), for K1, K2 and K3.  Tolerance 1e-2 x max |JAX output|: both
  round the output (and K1's and K2's hidden) to bf16, whose ulp is 3.9e-3
  relative, and the f32 sums feeding a rounding differ in order.
- The weights: ``bf16_cast_`` rounds every floating parameter and buffer as
  ``bf16_cast_variables`` casts every floating leaf (bit for bit), bf16
  tensors but in the modules flax promotes to f32, which hold the rounded
  values in f32; LayerNorm on bf16 computes in f32 and rounds its output,
  as flax's does.
- The whole denoiser: ``bf16_cast_variables`` + a bf16 forward of the JAX
  package against ``bf16_cast_`` + a bf16 forward of the port on
  configs/tests/tiny_t2m.py, the port's MoE gate logits pinned to the JAX
  run's (flax ``capture_intermediates``); the choices that would differ
  without the pin are counted and reported.  And one short DDIM sample
  (``compute_dtype``), the JAX run's draws handed to the port.  Tolerance
  5e-2 x max(1, max |JAX output|): the two frameworks round bf16 at other
  places (XLA's bf16 softmax and einsums, the JAX package's slot-buffer MoE
  on the CPU against the port's grouped one), and on this model bf16 itself
  moves either side's sample by about 3% of its scale from f32.
- The ControlNet's condition encoder under bf16 weights runs in f32 on the
  rounded weights, as flax promotes it.  Tolerance one bf16 ulp (2^-8) x
  scale: flax's BatchNorm computes rsqrt(var + eps) x scale in the
  statistics' dtype, bf16, where the port widens them first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import bf16_cast_variables, make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.models.blocks import LayerNorm as FlaxLayerNorm
from motioncraft_tpu.ops.pallas_moe_ffn import grouped_ffn as jax_grouped_ffn
from motioncraft_tpu.ops.pallas_sffn import head_ffn as jax_head_ffn
from motioncraft_tpu.ops.pallas_stma_attention import stma_linear_attention as jax_stma
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu_torch.apis.factory import PROMOTED_MODULES, bf16_cast_
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg as torch_tiny_cfg
from motioncraft_tpu_torch.models.blocks import LayerNorm
from motioncraft_tpu_torch.models.moe import CosineTopGate
from motioncraft_tpu_torch.ops import grouped_ffn, head_ffn, stma_linear_attention
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils.convert import from_jax_params, from_jax_variables
from torch_port_util import assert_close_scaled, seeded_batch_stats, seeded_params, t
from test_torch_kernels import grouped_case, head_case, stma_case

KERNEL_REL = 1e-2
MODEL_REL = 5e-2
BF = jnp.bfloat16


def bf16(a):
    """numpy f32 -> (JAX bf16 array, torch bf16 tensor) of the same values."""
    j = jnp.asarray(a, BF)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def as_f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("E,D,HID,be", [(3, 32, 64, [2, 0, 1]), (2, 64, 96, [1, 1]),
                                        (2, 128, 512, [0, 1])])
def test_k1_bf16_matches_pallas(E, D, HID, be):
    args = grouped_case(E, D, HID, be, seed=D)
    (xs_j, xs_t), (w1_j, w1_t), (b1_j, b1_t), (w2_j, w2_t) = (bf16(a) for a in args[1:])
    # the JAX MoE hands the kernel b1 widened to f32 (models/moe.py)
    want = jax_grouped_ffn(jnp.asarray(args[0]), xs_j, w1_j, b1_j.astype(jnp.float32), w2_j,
                           interpret=True)
    got = grouped_ffn(t(args[0]), xs_t, w1_t, b1_t, w2_t)
    assert want.dtype == BF and got.dtype == torch.bfloat16
    assert_close_scaled(as_f32(got), as_f32(want), KERNEL_REL, "K1 bf16")


@pytest.mark.parametrize("n,H,d,f", [(600, 3, 32, 64), (70, 2, 64, 96), (513, 2, 128, 512)])
def test_k2_bf16_matches_pallas(n, H, d, f):
    args = [bf16(a) for a in head_case(n, H, d, f, seed=n)]
    want = jax_head_ffn(*(a[0] for a in args), interpret=True)
    got = head_ffn(*(a[1] for a in args))
    assert want.dtype == BF and got.dtype == torch.bfloat16
    assert_close_scaled(as_f32(got), as_f32(want), KERNEL_REL, "K2 bf16")


@pytest.mark.parametrize("B,T,H,d,TXT", [(2, 20, 3, 16, 7), (3, 33, 2, 32, 77),
                                         (2, 50, 2, 128, 77)])
def test_k3_bf16_matches_pallas(B, T, H, d, TXT):
    args = [bf16(a) for a in stma_case(B, T, H, d, TXT, seed=T)]
    want = jax_stma(*(a[0] for a in args), interpret=True)
    got = stma_linear_attention(*(a[1] for a in args))
    assert want.dtype == BF and got.dtype == torch.bfloat16
    assert_close_scaled(as_f32(got), as_f32(want), KERNEL_REL, "K3 bf16")


def test_layernorm_bf16_is_flax_s():
    """Statistics and affine in f32, the output rounded to bf16: at most
    one bf16 ulp apart (the two sum in another order)."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 96).astype(np.float32) * 3 + 1
    scale, bias = rng.randn(96).astype(np.float32), rng.randn(96).astype(np.float32)
    xj, xt = bf16(x)
    want = FlaxLayerNorm().apply({"params": {"scale": jnp.asarray(scale, BF),
                                             "bias": jnp.asarray(bias, BF)}}, xj)
    ln = LayerNorm(96)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = ln.to(torch.bfloat16)(xt)
    assert want.dtype == BF and got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.abs(as_f32(want))
    assert (np.abs(as_f32(got) - as_f32(want)) <= ulp + 1e-30).all()


@pytest.fixture(scope="module")
def pair():
    """The tiny T2M config on both sides with one seeded tree, both cast to
    bf16."""
    cfg = tiny_t2m_cfg()
    arch_j = build_jax(cfg)
    batch = make_text_batch(["a person walks forward", "someone waves hello"],
                            max_seq_len=16, lengths=np.array([[16], [11]], np.int32))
    variables = arch_j.init(jax.random.PRNGKey(0), batch)
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 1)
    vb = bf16_cast_variables({"params": jax.tree_util.tree_map(jnp.asarray, params)})
    arch_t = build_torch(torch_tiny_cfg(), device="cpu")
    arch_t.model.load_state_dict(from_jax_params(params), strict=True)
    bf16_cast_(arch_t)
    return arch_j, vb, arch_t, batch


def test_bf16_cast_is_bf16_cast_variables(pair):
    _, vb, arch_t, _ = pair
    want = from_jax_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), vb["params"]))
    got = arch_t.model.state_dict()
    assert set(got) == set(want)
    promoted = 0
    for k, v in got.items():
        if set(k.split(".")) & set(PROMOTED_MODULES):
            promoted += 1
            assert v.dtype == torch.float32, k
        else:
            assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(), want[k].numpy(), err_msg=k)
    assert promoted > 0


def _jax_gate_logits(intermediates):
    """{port module name: the JAX run's gate logits} from flax's captured
    intermediates (each gate's ``__call__`` output)."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(intermediates)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-3:-1] == ["gate", "__call__"]:
            out[".".join(keys[:-2])] = np.asarray(a)
    return out


def test_forward_bf16_matches_jax(pair):
    """One CFG test forward in bf16, the port's gates fed the JAX logits."""
    arch_j, vb, arch_t, batch = pair
    x = np.random.RandomState(3).randn(*batch["motion"].shape).astype(np.float32)
    ts = np.full((2,), 499, np.int32)
    xf = arch_j.encode_text(vb, batch["text_ids"])
    assert xf.dtype == BF
    want, state = jax.jit(lambda v, x_, m, ml, xf_: arch_j.model.apply(
        v, x_, ts, motion_mask=m, motion_length=ml, xf_out=xf_, mode="test",
        capture_intermediates=True, mutable=["intermediates"]))(
        vb, jnp.asarray(x, BF), batch["motion_mask"], batch["motion_length"], xf)
    logits = _jax_gate_logits(state["intermediates"])
    assert len(logits) == 4  # text and motion MoE of each of the two layers
    seen, flips = [], [0, 0]

    def pin(name):
        def hook(mod, inp, out):
            want_lg = torch.from_numpy(logits[name])
            assert out.dtype == torch.float32  # f32 gate logits under bf16
            top = [torch.sort(v, dim=1, descending=True, stable=True).indices[:, :2]
                   .sort(dim=1).values for v in (out, want_lg)]
            flips[0] += int((top[0] != top[1]).sum())
            flips[1] += top[0].numel()
            seen.append(name)
            return want_lg
        return hook

    handles = [m.register_forward_hook(pin(n)) for n, m in arch_t.model.named_modules()
               if isinstance(m, CosineTopGate)]
    try:
        with torch.no_grad():
            xf_t = arch_t.encode_text(batch["text_ids"])
            got = arch_t.model(t(x).to(torch.bfloat16), t(ts, torch.long),
                               motion_mask=t(batch["motion_mask"]),
                               motion_length=t(batch["motion_length"]), xf_out=xf_t,
                               text_feats=arch_t.model.precompute_text_feats(xf_t))
    finally:
        for h in handles:
            h.remove()
    assert sorted(seen) == sorted(logits)
    print(f"expert choices that differ before pinning: {flips[0]} of {flips[1]}")
    assert xf_t.dtype == torch.bfloat16
    assert_close_scaled(as_f32(xf_t), as_f32(xf), MODEL_REL, "encode_text bf16")
    assert want.dtype == jnp.float32 and got.dtype == torch.float32  # CFG mix in f32
    assert np.abs(np.asarray(want)).max() > 1e-3
    assert_close_scaled(got.numpy(), np.asarray(want), MODEL_REL, "forward bf16")


def test_sample_bf16_matches_jax(pair):
    """DDIM over the tiny respace ('4') with the denoiser in bf16: the JAX
    run's initial noise handed to the port (eta 0 draws nothing else)."""
    arch_j, vb, arch_t, batch = pair
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda v, b, r: arch_j.sample(v, b, r, compute_dtype=BF))(
        vb, batch, rng))
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0], batch["motion"].shape,
                                         jnp.float32))
    got = arch_t.sample(batch, noise=t(noise), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and arch_t.diffusion_test.num_timesteps == 4
    assert_close_scaled(got.numpy(), want, MODEL_REL, "sample bf16")
    with pytest.raises(ValueError, match="bf16_cast_"):
        arch_t.sample(batch, noise=t(noise))  # f32 compute on bf16 weights


def test_condition_encoder_promotes_to_f32():
    """The S2G ControlNet's WavEncoder and input projection on bf16-cast
    weights and an f32 condition: f32 out, equal to JAX's encode_condition
    on bf16_cast_variables (both widen the bf16 weights)."""
    from motioncraft_tpu_torch.apis.factory import flagship_t2m_cfg

    base = flagship_t2m_cfg(num_layers=2, latent_dim=8, max_seq_len=16, text_latent_dim=16,
                            ff_size=16, time_embed_dim=32, clip_width=32, clip_layers=1,
                            num_experts=4, respace="4")
    cfg = dict(base, model=dict(
        type="ControlT2MHalf", base_model=base["model"], copy_blocks_num=1,
        control_cond_feats=2,
        condition_encode_cfg=dict(dataset_name="beats2", condition_pre_encode=True,
                                  condition_pre_encode_type="wav", condition_latent_dim=16,
                                  control_cond_feats=2, condition_cfg=True)))
    arch_j = build_jax(cfg)
    c = np.random.RandomState(2).randn(1, 16 * 533, 2).astype(np.float32)
    batch = make_text_batch(["someone speaks"], max_seq_len=16)
    variables = arch_j.init(jax.random.PRNGKey(0), dict(batch, c=c))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    params, stats = seeded_params(tree["params"], 2), seeded_batch_stats(tree["batch_stats"], 3)
    vb = bf16_cast_variables({"params": params, "batch_stats": stats})
    want = np.asarray(arch_j.model.apply(vb, jnp.asarray(c), 16, method="encode_condition"))
    arch_t = build_torch(cfg, device="cpu")
    arch_t.model.load_state_dict(from_jax_variables({"params": params, "batch_stats": stats}),
                                 strict=True)
    bf16_cast_(arch_t)
    with torch.no_grad():
        got = arch_t.model.encode_condition(t(c), 16)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-3
    assert_close_scaled(got.numpy(), want, 2.0 ** -8, "encode_condition under bf16 weights")
