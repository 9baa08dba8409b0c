"""The quadratic ``Base{Self,Cross,Mixed}Attention`` and
``EfficientMixedAttention`` in training with dropout, against the JAX
package on the CPU.

Each flax module is initialised, its ``params`` replaced by a seeded numpy
tree and carried into the port by ``from_jax_params`` with
``strict=True``; the same inputs go through both.  The JAX package
computes the Base attentions with einsums outside any Pallas kernel, and
the mixed attention's dropout path with the softmaxes and
``linear_attention_core`` in plain ops; the port does the same.  Dropout:
the random streams differ, so the JAX run's keep masks (read off its
Dropout modules' outputs: flax's ``intercept_methods``) are handed to the
port's ``dropout`` in call order.  Tolerance 1e-5 x max(1, max |JAX|).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncraft_tpu.models import attentions as jax_att
from motioncraft_tpu_torch.models import attentions, blocks
from motioncraft_tpu_torch.registry import ATTENTIONS
from motioncraft_tpu_torch.utils.convert import from_jax_params
from torch_port_util import assert_close_scaled, grad_mode_on, seeded_params, t  # noqa: F401

REL = 1e-5
B, T, N, D, DT, H, TE = 2, 7, 5, 16, 12, 4, 24


def inputs():
    rng = np.random.RandomState(11)
    x = rng.randn(2 * B, T, D).astype(np.float32)
    xf = rng.randn(2 * B, N, DT).astype(np.float32)
    emb = rng.randn(2 * B, TE).astype(np.float32)
    mask = np.ones((2 * B, T, 1), np.float32)
    mask[1::2, 4:] = 0
    cond = np.array([1, 0, 11, 10], np.int32).reshape(2 * B, 1, 1)
    return dict(x=x, xf=xf, emb=emb, src_mask=mask, cond_type=cond)


def carry(flax_m, port, kw):
    shapes = jax.eval_shape(lambda: flax_m.init(jax.random.PRNGKey(0), kw["x"], **{
        k: v for k, v in kw.items() if k != "x"}))
    params = seeded_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                  dict(shapes["params"])), 3)
    port.load_state_dict(from_jax_params(params), strict=True)
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}, port.eval()


CASES = {
    "BaseSelfAttention": dict(latent_dim=D, num_heads=H, time_embed_dim=TE),
    "BaseCrossAttention": dict(latent_dim=D, text_latent_dim=DT, num_heads=H,
                               time_embed_dim=TE),
    "BaseMixedAttention": dict(latent_dim=D, text_latent_dim=DT, num_heads=H,
                               time_embed_dim=TE),
}


@pytest.mark.parametrize("name,with_cond", [
    ("BaseSelfAttention", False), ("BaseCrossAttention", True), ("BaseCrossAttention", False),
    ("BaseMixedAttention", True)])
def test_base_attention(name, with_cond):
    """Each with the inputs it reads; the cross-attention also without
    ``cond_type`` (the text never masked)."""
    kw = inputs()
    if not with_cond:
        kw.pop("cond_type")
    flax_m = getattr(jax_att, name)(**CASES[name])
    v, port = carry(flax_m, ATTENTIONS.build(dict(type=name, **CASES[name])), kw)
    x = kw.pop("x")
    want = jax.jit(lambda v_: flax_m.apply(v_, x, **kw))(v)
    with torch.no_grad():
        got = port(t(x), **{k: t(a) for k, a in kw.items()}).numpy()
    assert np.abs(want - x).max() > 1e-3  # the residual is not the input
    assert_close_scaled(got, want, REL, name)


def _recorder(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and not kwargs.get("deterministic", True):
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


def test_efficient_mixed_attention_dropout_in_training(monkeypatch):
    """Training with dropout 0.3: the key softmax dropped out before the
    contraction, then the stylized residual's dropout; the port's output
    and its gradient path (the masks are the JAX run's)."""
    kw = inputs()
    cfg = dict(latent_dim=D, text_latent_dim=DT, num_heads=H, dropout=0.3, time_embed_dim=TE)
    flax_m = jax_att.EfficientMixedAttention(**cfg)
    v, port = carry(flax_m, attentions.EfficientMixedAttention(**cfg), kw)
    x = kw.pop("x")
    masks = []
    with fnn.intercept_methods(_recorder(masks)):
        want = flax_m.apply(v, x, train=True, rngs={"dropout": jax.random.PRNGKey(7)}, **kw)
    assert len(masks) == 2 and masks[0].shape == (2 * B, N + T, H, D // H)
    queue = list(masks)

    def replay(y, p, training, generator=None, mesh=None, split=None):
        if not training or p == 0.0:
            return y
        keep = torch.from_numpy(queue.pop(0))
        return y * keep / (1.0 - p)

    monkeypatch.setattr(attentions, "dropout", replay)
    monkeypatch.setattr(blocks, "dropout", replay)
    port.train()
    xt = t(x).requires_grad_()
    got = port(xt, **{k: t(a) for k, a in kw.items()})
    assert not queue
    assert_close_scaled(got.detach().numpy(), want, REL, "mixed attention, dropout")
    got.sum().backward()
    assert torch.isfinite(xt.grad).all()
