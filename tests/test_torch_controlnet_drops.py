"""The port's ControlNet against the JAX package with MoE capacity drops:
the CFG test forward of the tiny M2D config with cfg_layer0_dedup on (off:
tests/test_torch_controlnet_nodedup.py), text_hoist on and off, the
condition on and off, every gate leaning to expert 0 so that every MoE call
(base and control blocks, motion and text) overflows its capacity on both
sides; drops make the switches route differently, so each combination must
match its JAX counterpart.  The helpers are tests/test_torch_controlnet.py's.
Tolerance: 1e-5 x max(1, max |JAX|)."""

import pytest

from test_torch_controlnet import REL, _batch, _forward_jax, _forward_torch, _inputs, _pair
from test_torch_sample import _overflows
from torch_port_util import assert_close_scaled


@pytest.mark.parametrize("hoist", [True, False])
def test_cfg_switches_with_capacity_drops(hoist, dedup=True):
    """Each switch combination, c on and off, every gate leaning to expert 0
    so that every MoE call overflows its capacity on both sides."""
    arch_j, params, arch_t = _pair(skew=True, seed=2, cfg_layer0_dedup=dedup,
                                   text_hoist=hoist)
    batch = _batch()
    x, ts = _inputs()
    for c in (batch["c"], None):
        want, tf, jax_logits = _forward_jax(arch_j, params, batch, x, ts, c, capture=True)
        torch_logits = []
        got, tf_t = _forward_torch(arch_t, batch, x, ts, c, torch_logits)
        assert (tf is None) == (tf_t is None) == (not hoist)
        layers = arch_t.model.num_layers + (arch_t.model.copy_blocks_num if c is not None
                                            else 0)
        # per layer (base and control): one motion MoE call and one text MoE call
        assert len(torch_logits) == len(jax_logits) == 2 * layers
        assert sorted(lg.shape[0] for lg in torch_logits) == sorted(
            lg.shape[0] for lg in jax_logits)
        assert all(_overflows(lg, 2) for lg in torch_logits + jax_logits)
        assert_close_scaled(got, want, REL, f"forward_test c={'on' if c is not None else 'off'}")
