"""tests/test_torch_controlnet_drops.py's capacity-drop cases with
cfg_layer0_dedup off (the reference's strict drop semantics): the layer-0
motion MoE routes the whole CFG-doubled batch.  Tolerance: 1e-5 x max(1,
max |JAX|)."""

import pytest

from test_torch_controlnet_drops import test_cfg_switches_with_capacity_drops as _case


@pytest.mark.parametrize("hoist", [True, False])
def test_cfg_switches_with_capacity_drops_no_dedup(hoist):
    _case(hoist, dedup=False)
