"""The rest of S2G against the JAX package, on the CPU: the Wav2Vec2 tower
(models/wav2vec.py), the ControlNet's ``condition_pre_encode_type=
'wav2vec'``, the wav2vec2 / VAESKConv converters and the wav2vec2 loader,
the S2G embedding model (eval/s2g_fid.py: VAESKConv and its FID) and the
gesture metrics SRGR and L1div.reset.

- Wav2Vec2Module at the JAX package's test size (tests/test_wav2vec.py's
  TINY: 3 convolutions of 16 channels, 2 layers of width 32) on one seeded
  flax tree (the JAX converter's, of a fabricated HuggingFace state dict)
  carried over by ``from_jax_params``, with and without the interpolation
  to the motion frame count; ``linear_interpolate``.
- A ControlT2MHalf over ``tiny_t2m_cfg()`` with the wav2vec pre-encoder
  (the JAX package's own wiring recipe, tests/test_wav2vec.py) on the
  port's seeded fabricated weights (carried to JAX by ``to_jax_params``),
  one denoiser call (``forward_test``) on seeded audio with the condition
  on, and ``encode_condition``.
- ``convert_wav2vec2`` (with the positional convolution's weight norm in
  both its key layouts) and ``convert_vaeskconv`` on fabricated torch state
  dicts: the same arrays as the JAX converters give; ``load_wav2vec2_params``
  on a checkpoint file that the test writes from that state dict: the port
  loaded through it computes what the JAX module loaded through the JAX
  loader computes (the JAX package's tests/test_wav2vec.py holds that
  converter against HuggingFace's Wav2Vec2Model).
- VAESKConv's embeddings (``encode_motion`` on seeded 322-d motions) and
  the FID between two sets of them, on the JAX model's weights.

Tolerances: 1e-5 x max(1, max |JAX|) for f32 outputs (sums in another
order); the converters' arrays exactly; the FID within 1e-4 x max(1, FID)
(a matrix square root of covariances of embeddings that agree to 1e-5);
the metrics exactly, as the JAX package's in float64.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu.eval import gesture_metrics as jax_gm
from motioncraft_tpu.eval import metrics as jax_metrics
from motioncraft_tpu.eval.s2g_fid import LocalEncoderModule as JaxLocalEncoder
from motioncraft_tpu.eval.s2g_fid import VAESKConv as JaxVAESKConv
from motioncraft_tpu.models.wav2vec import Wav2Vec2Module as JaxWav2Vec2
from motioncraft_tpu.models.wav2vec import linear_interpolate as jax_interpolate
from motioncraft_tpu.registry import build_architecture as build_jax
from motioncraft_tpu.utils import torch_convert as jax_convert
from motioncraft_tpu_torch.eval import gesture_metrics, metrics
from motioncraft_tpu_torch.eval.s2g_fid import VAESKConv, smplx322_to_rot6d
from motioncraft_tpu_torch.models.wav2vec import Wav2Vec2Module, linear_interpolate
from motioncraft_tpu_torch.registry import build_architecture as build_torch
from motioncraft_tpu_torch.utils import torch_convert
from motioncraft_tpu_torch.utils.convert import (fabricate_state_dict, from_jax_params,
                                                 to_jax_params)
from test_torch_controlnet import _forward_torch
from torch_port_util import assert_close_scaled, t

REL, FID_REL = 1e-5, 1e-4
TINY = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
T, SPF = 16, 16000 // 30


def _wav(seed, batch=2, samples=3200):
    return np.random.RandomState(seed).randn(batch, samples).astype(np.float32)


@pytest.fixture(scope="module")
def wav2vec():
    """(the flax module's jitted apply: (params, wav, output_len) -> output,
    seeded params (the JAX converter's tree of a fabricated HuggingFace
    state dict), the port's module loaded with them)."""
    mod = JaxWav2Vec2(**TINY)
    params = jax_convert.convert_wav2vec2(_hf_wav2vec2_state_dict(1, False),
                                          TINY["num_layers"], len(TINY["conv_dim"]))
    applies = {n: jax.jit(lambda p, w, n=n: mod.apply({"params": p}, w, n)) for n in (None, T)}
    port = Wav2Vec2Module(**TINY)
    port.load_state_dict(from_jax_params(params), strict=True)
    return (lambda p, w, n=None: np.asarray(applies[n](p, jnp.asarray(w)))), params, port.eval()


@pytest.mark.parametrize("output_len", [None, T])
def test_wav2vec2_module(wav2vec, output_len):
    apply, params, port = wav2vec
    wav = _wav(2)
    want = apply(params, wav, output_len)
    with torch.no_grad():
        got = port(t(wav), output_len=output_len).numpy()
    assert want.shape == got.shape and (output_len is None or got.shape[1] == T)
    assert np.abs(want).max() > 1e-2
    assert_close_scaled(got, want, REL, "Wav2Vec2Module")


def test_linear_interpolate():
    x = np.random.RandomState(1).randn(2, 49, 8).astype(np.float32)
    for n in (1, 15, 49, 100):
        want = np.asarray(jax_interpolate(jnp.asarray(x), n)) if n > 1 else None
        got = linear_interpolate(t(x), n).numpy()
        assert got.shape == (2, n, 8)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ the ControlNet
def _controlnet_cfg():
    base = tiny_t2m_cfg()
    cfg = dict(base)
    cfg["model"] = dict(
        type="ControlT2MHalf", base_model=base["model"], copy_blocks_num=1,
        control_cond_feats=2,
        condition_encode_cfg=dict(dataset_name="beats2", condition_pre_encode=True,
                                  condition_pre_encode_type="wav2vec",
                                  condition_latent_dim=16, control_cond_feats=2,
                                  condition_cfg=True, wav2vec_cfg=TINY))
    return cfg


def _cn_batch():
    batch = make_text_batch(["someone is speaking", "a person talks and waves"],
                            max_seq_len=T)
    batch["c"] = np.random.RandomState(2).randn(2, T * SPF, 2).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def controlnet():
    """(the port's arch with seeded fabricated weights, batch, noisy motion,
    the JAX package's forward_test and encode_condition on the same
    weights (the port's state dict as a flax tree), one jit)."""
    arch_j = build_jax(_controlnet_cfg())
    arch_t = build_torch(copy.deepcopy(_controlnet_cfg()), device="cpu")
    sd = fabricate_state_dict(arch_t.model, seed=1)
    arch_t.model.load_state_dict(sd, strict=True)
    batch = _cn_batch()
    rng = np.random.RandomState(3)
    x, ts = rng.randn(2, T, 322).astype(np.float32), np.full((2,), 499, np.int32)

    def run(v, c):
        xf = arch_j.encode_text(v, batch["text_ids"])
        tf = arch_j.model.apply(v, xf, method="precompute_text_feats")
        out = arch_j.model.apply(v, x, ts, motion_mask=batch["motion_mask"],
                                 motion_length=batch["motion_length"], xf_out=xf, c=c,
                                 text_feats=tf, mode="test")
        return out, arch_j.model.apply(v, c, T, method="forward_c")

    want = jax.jit(run)({"params": to_jax_params(sd)}, batch["c"])
    return arch_t, batch, x, ts, [np.asarray(a) for a in want]


def test_controlnet_wav2vec_forward_test(controlnet):
    from motioncraft_tpu_torch.models.wav2vec import Wav2Vec2Conditioner

    arch_t, batch, x, ts, (want, _) = controlnet
    assert isinstance(arch_t.model.condition_pre_encoder, Wav2Vec2Conditioner)
    got, _ = _forward_torch(arch_t, batch, x, ts, batch["c"])
    assert np.abs(want).max() > 1e-3
    assert_close_scaled(got, want, REL, "wav2vec ControlNet forward_test")


def test_controlnet_wav2vec_encode_condition(controlnet):
    arch_t, batch, _, _, (_, want) = controlnet
    with torch.no_grad():
        got = arch_t.model.encode_condition(t(batch["c"]), T).numpy()
    assert got.shape == want.shape == (2, T, arch_t.model.base_model.latent_dim)
    assert_close_scaled(got, want, REL, "encode_condition")


# ------------------------------------------------------------ the converters
def _hf_wav2vec2_state_dict(seed, parametrized):
    """A HuggingFace Wav2Vec2Model state dict of TINY's shapes, seeded
    numbers; the positional convolution weight-normed in the legacy
    (weight_g / weight_v) or the parametrize-era key layout."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)  # noqa: E731
    c, h, ff = TINY["conv_dim"][0], TINY["hidden_size"], TINY["intermediate_size"]
    k, g = TINY["num_conv_pos_embeddings"], TINY["num_conv_pos_embedding_groups"]
    sd = {"feature_extractor.conv_layers.0.layer_norm.weight": 1 + f(c),
          "feature_extractor.conv_layers.0.layer_norm.bias": f(c),
          "feature_projection.layer_norm.weight": 1 + f(c),
          "feature_projection.layer_norm.bias": f(c),
          "feature_projection.projection.weight": f(h, c),
          "feature_projection.projection.bias": f(h),
          "encoder.pos_conv_embed.conv.bias": f(h),
          "encoder.layer_norm.weight": 1 + f(h), "encoder.layer_norm.bias": f(h)}
    c_in = 1
    for i, (ci, ki) in enumerate(zip(TINY["conv_dim"], TINY["conv_kernel"])):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = f(ci, c_in, ki)
        c_in = ci
    gk, vk = (("parametrizations.weight.original0", "parametrizations.weight.original1")
              if parametrized else ("weight_g", "weight_v"))
    sd[f"encoder.pos_conv_embed.conv.{gk}"] = 1 + f(1, 1, k)
    sd[f"encoder.pos_conv_embed.conv.{vk}"] = f(h, h // g, k)
    for i in range(TINY["num_layers"]):
        p = f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.attention.{n}.weight"], sd[f"{p}.attention.{n}.bias"] = f(h, h), f(h)
        sd[f"{p}.feed_forward.intermediate_dense.weight"] = f(ff, h)
        sd[f"{p}.feed_forward.intermediate_dense.bias"] = f(ff)
        sd[f"{p}.feed_forward.output_dense.weight"] = f(h, ff)
        sd[f"{p}.feed_forward.output_dense.bias"] = f(h)
        for n in ("layer_norm", "final_layer_norm"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1 + f(h), f(h)
    return sd


def _assert_same_trees(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_trees(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("parametrized", [False, True], ids=["weight_g", "parametrizations"])
def test_convert_wav2vec2(parametrized):
    sd = _hf_wav2vec2_state_dict(4, parametrized)
    n, convs = TINY["num_layers"], len(TINY["conv_dim"])
    _assert_same_trees(torch_convert.convert_wav2vec2(sd, n, convs),
                       jax_convert.convert_wav2vec2(sd, n, convs))


def test_load_wav2vec2_params(wav2vec, tmp_path):
    apply, params, _ = wav2vec
    sd = _hf_wav2vec2_state_dict(5, True)
    path = str(tmp_path / "wav2vec2.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    n, convs = TINY["num_layers"], len(TINY["conv_dim"])
    port = Wav2Vec2Module(**TINY)
    loaded = torch_convert.load_wav2vec2_params(path, port, n, convs)
    assert set(loaded) == set(port.state_dict())
    # the JAX loader fills a variables tree of the module's shapes
    variables = jax_convert.load_wav2vec2_params(path, {"params": params}, n, convs)
    wav = _wav(6)
    want = apply(variables["params"], wav)
    with torch.no_grad():
        got = port.eval()(t(wav)).numpy()
    assert_close_scaled(got, want, REL, "loaded Wav2Vec2Module")


def _vaeskconv_state_dict(model, seed):
    """A reference VAESKConv state dict (``module.`` prefixed, as the
    released file) of the shapes of ``model``'s flax trees."""
    rng = np.random.RandomState(seed)
    enc = model.enc_params["params"]
    sd = {}
    for i in range(model.encoder.num_layers):
        layer, p = enc[f"layer_{i}"], f"module.encoder.layers.{i}.0"
        for name, ref in (("conv", "residual.0"), ("shortcut", "shortcut")):
            w = np.asarray(layer[name]["weight"])  # [k, in, out]
            sd[f"{p}.{ref}.weight"] = rng.randn(*w.shape[::-1]).astype(np.float32) * 0.1
            sd[f"{p}.{ref}.bias"] = rng.randn(w.shape[2]).astype(np.float32) * 0.1
        c = np.asarray(layer["gn"]["scale"]).shape[0]
        sd[f"{p}.residual.1.weight"] = 1 + rng.randn(c).astype(np.float32) * 0.1
        sd[f"{p}.residual.1.bias"] = rng.randn(c).astype(np.float32) * 0.1
    mu = np.asarray(model.mu_params["params"]["kernel"])
    sd["module.fc_mu.weight"] = rng.randn(*mu.shape[::-1]).astype(np.float32) * 0.1
    sd["module.fc_mu.bias"] = rng.randn(mu.shape[1]).astype(np.float32) * 0.1
    return sd


@pytest.fixture(scope="module")
def vaeskconv():
    """(the JAX package's VAESKConv, the port's on the CPU with its
    weights).  The JAX object's weights come from one jitted init of its
    modules (its constructor inits them eagerly, 14 s here); encode_motion
    and map2latent are its own."""
    jax_model = JaxVAESKConv.__new__(JaxVAESKConv)
    jax_model.variational = False
    jax_model.encoder = JaxLocalEncoder(num_layers=4, grow=(1, 1, 2, 1), vae_length=240)
    jax_model.fc_mu = fnn.Dense(240)
    key = jax.random.PRNGKey(0)
    jax_model.enc_params = unfreeze(jax.jit(jax_model.encoder.init)(key, jnp.zeros((1, 16, 330))))
    jax_model.mu_params = unfreeze(jax.jit(jax_model.fc_mu.init)(key, jnp.zeros((1, 240))))
    jax_model._map = jax.jit(lambda ep, mp, x: jax_model.encoder.apply(ep, x))
    port = VAESKConv(device="cpu")
    port.encoder.load_state_dict(from_jax_params(jax_model.enc_params["params"]), strict=True)
    port.fc_mu.load_state_dict(from_jax_params(jax_model.mu_params["params"]), strict=True)
    return jax_model, port


def test_convert_and_load_vaeskconv(vaeskconv, tmp_path):
    jax_model, port = vaeskconv
    sd = _vaeskconv_state_dict(jax_model, 7)
    plain = {k.removeprefix("module."): v for k, v in sd.items()}
    for got, want in zip(torch_convert.convert_vaeskconv(plain, 4),
                         jax_convert.convert_vaeskconv(plain, 4)):
        _assert_same_trees(got, want)
    path = str(tmp_path / "vaeskconv.bin")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    fresh = VAESKConv(device="cpu", init_cfg=dict(type="Pretrained", checkpoint=path))
    enc_j, mu_j = jax_convert.load_vaeskconv_ckpt(path, jax_model.enc_params,
                                                  jax_model.mu_params)
    assert jax_model.enc_params["params"]["layer_0"]["conv"]["weight"].shape == (
        enc_j["params"]["layer_0"]["conv"]["weight"].shape)
    for module, tree in ((fresh.encoder, enc_j), (fresh.fc_mu, mu_j)):
        want = from_jax_params(tree["params"])
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_vaeskconv_embeddings_and_fid(vaeskconv):
    jax_model, port = vaeskconv
    rng = np.random.RandomState(8)
    a = (rng.randn(6, 40, 322) * 0.5).astype(np.float32)
    b = (rng.randn(6, 40, 322) * 0.5 + 0.2).astype(np.float32)
    rot6d = smplx322_to_rot6d(a).numpy()
    from motioncraft_tpu.eval.s2g_fid import smplx322_to_rot6d as jax_rot6d
    assert_close_scaled(rot6d, jax_rot6d(a), REL, "rot6d")
    emb = {}
    for name, m in (("a", a), ("b", b)):
        want = np.asarray(jax_model.encode_motion(m))
        got = port.encode_motion(m).numpy()
        assert got.shape == want.shape == (6, 240)
        assert_close_scaled(got, want, REL, f"embeddings {name}")
        emb[name] = (got, want)

    def fid(pkg, x, y):
        mu1, s1 = pkg.calculate_activation_statistics(x)
        mu2, s2 = pkg.calculate_activation_statistics(y)
        return pkg.calculate_frechet_distance(mu1, s1, mu2, s2)

    want = fid(jax_metrics, emb["a"][1], emb["b"][1])
    got = fid(metrics, emb["a"][0], emb["b"][0])
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= FID_REL * max(1.0, abs(want))


# --------------------------------------------------------------- the metrics
def test_srgr_and_l1div_reset():
    rng = np.random.RandomState(9)
    res, tgt = rng.randn(30, 47 * 3) * 0.05, rng.randn(30, 47 * 3) * 0.05
    sem = rng.rand(30)
    ours, theirs = gesture_metrics.SRGR(threshold=0.2), jax_gm.SRGR(threshold=0.2)
    for lo, hi in ((0, 12), (12, 30)):
        assert ours.run(res[lo:hi], tgt[lo:hi], sem[lo:hi]) == theirs.run(
            res[lo:hi], tgt[lo:hi], sem[lo:hi])
    assert ours.avg() == theirs.avg() > 0 and ours.counter == theirs.counter == 30
    l1, l1_j = gesture_metrics.L1div(), jax_gm.L1div()
    for m in (l1, l1_j):
        m.run(res)
    assert l1.avg() == l1_j.avg() > 0
    l1.reset()
    l1_j.reset()
    assert (l1.counter, l1.sum, l1.avg()) == (l1_j.counter, l1_j.sum, l1_j.avg()) == (0, 0.0, 0.0)
