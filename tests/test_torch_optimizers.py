"""The port's optimizers beyond Adam against optax, on the CPU.

- Adafactor, AdaBelief and LAMB (parallel/optim.py, optax's defaults) at
  the flagship's parameter shapes (the expert and SFFN weights [E or H,
  128, 512], the time MLP [2048, 128], a bias, the gate's temperature):
  two updates against the JAX package's ``build_optimizer`` (optax).
  Adafactor factors which dims optax's ``_factored_dims`` says.  (Three
  updates with and without the gradient clip, under a step decay, are
  cases of tests/test_torch_train.py::test_optimizers_match_optax.)
- ``build_optimizers``: a dict-of-dicts config routes each top-level
  subtree to its own optimizer, as the JAX package's ``optax.multi_transform``
  does (three updates); a flat config is one optimizer; a name that is no
  subtree raises KeyError, a subtree without an optimizer ValueError, on
  both sides.

Tolerance 1e-6 absolute on parameters of order 1 moved by lr 1e-2: a few
f32 ulps, from the updates' reductions (Adafactor's factored means and
RMS, LAMB's norms) summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _factored_dims

from motioncraft_tpu.parallel.optimizers import build_optimizers as jax_build_optimizers
from motioncraft_tpu.parallel.train_state import build_optimizer as jax_build_optimizer
from motioncraft_tpu_torch.parallel import (AdaBelief, Adafactor, Lamb, build_optimizer,
                                            build_optimizers)
from motioncraft_tpu_torch.parallel.optim import factored_dims

ATOL = 1e-6
FLAGSHIP_SHAPES = {"expert_w1": (16, 128, 512), "w2": (12, 512, 128),
                   "time_embed": (2048, 128), "bias": (2048,), "temperature": (1,)}


def _tree(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) / np.sqrt(s[-2] if len(s) > 1 else 4)).astype(np.float32)
            for k, s in shapes.items()}


def _module(tree):
    """A torch module whose parameters (and submodules) mirror a nested
    dict of arrays."""
    m = torch.nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return m


def _run_optax(tx, p0, grads):
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return params


def _set_grads(module, g):
    for k, v in g.items():
        if isinstance(v, dict):
            _set_grads(getattr(module, k), v)
        else:
            module.get_parameter(k).grad = torch.from_numpy(v.copy())


def _assert_params(module, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_params(getattr(module, k), v)
        else:
            np.testing.assert_allclose(module.get_parameter(k).detach().numpy(),
                                       np.asarray(v), rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("shape", [(128, 128), (127, 300), (300, 127), (16, 128, 512),
                                   (12, 512, 128), (2048, 128), (130, 2, 200), (4, 3), (5,),
                                   (1,)])
def test_adafactor_factors_as_optax(shape):
    assert factored_dims(shape) == _factored_dims(shape, True, 128)


@pytest.mark.parametrize("cls,name", [(Adafactor, "Adafactor"), (AdaBelief, "AdaBelief"),
                                      (Lamb, "Lamb")])
def test_optax_defaults_at_flagship_shapes(cls, name):
    p0 = _tree(FLAGSHIP_SHAPES, 0)
    grads = [_tree(FLAGSHIP_SHAPES, s) for s in (1, 2)]
    want = _run_optax(jax_build_optimizer({"type": name, "lr": 1e-2}, frozen_prefixes=()),
                      p0, grads)
    module = _module(p0)
    opt = build_optimizer({"type": name, "lr": 1e-2, "betas": (0.5, 0.5)}, module.parameters())
    assert type(opt) is cls  # the config's other keys are not read, as in JAX
    for g in grads:
        _set_grads(module, g)
        opt.step()
    _assert_params(module, want)


def test_build_optimizers_routes_subtrees_as_multi_transform():
    p0 = {"enc": _tree({"kernel": (130, 200), "bias": (200,)}, 3),
          "dec": _tree({"w": (3, 4)}, 4)}
    cfgs = {"enc": dict(type="Adafactor", lr=1e-2), "dec": dict(type="Adam", lr=1e-2)}
    grads = [{"enc": _tree({"kernel": (130, 200), "bias": (200,)}, 10 + i),
              "dec": _tree({"w": (3, 4)}, 20 + i)} for i in range(3)]
    want = _run_optax(jax_build_optimizers(p0, cfgs), p0, grads)
    module = _module(p0)
    opts = build_optimizers(module, cfgs)
    assert set(opts) == {"enc", "dec"}
    assert isinstance(opts["enc"], Adafactor) and isinstance(opts["dec"], torch.optim.Adam)
    for g in grads:
        _set_grads(module, g)
        for opt in opts.values():
            opt.step()
    _assert_params(module, want)


def test_build_optimizers_flat_and_errors():
    p0 = {"enc": _tree({"kernel": (6, 5)}, 5), "dec": _tree({"w": (3, 4)}, 6)}
    grads = [{"enc": _tree({"kernel": (6, 5)}, 30 + i), "dec": _tree({"w": (3, 4)}, 40 + i)}
             for i in range(2)]
    want = _run_optax(jax_build_optimizers(p0, dict(type="Lamb", lr=1e-2)), p0, grads)
    module = _module(p0)
    opt = build_optimizers(module, dict(type="Lamb", lr=1e-2))
    assert isinstance(opt, Lamb)
    for g in grads:
        _set_grads(module, g)
        opt.step()
    _assert_params(module, want)
    with pytest.raises(KeyError, match="head"):
        jax_build_optimizers(p0, {"head": dict(type="Adam")})
    with pytest.raises(KeyError, match="head"):
        build_optimizers(module, {"head": dict(type="Adam")})
    with pytest.raises(ValueError):
        _run_optax(jax_build_optimizers(p0, {"enc": dict(type="Adam", lr=1e-2)}), p0, grads)
    with pytest.raises(ValueError, match="dec"):
        build_optimizers(module, {"enc": dict(type="Adam", lr=1e-2)})
