"""Which configs of configs/ the port builds: every non-``_base_`` file is
built with the port's registry on the CPU.  The ones it runs build; each of
the others raises for the reason ROADMAP.md gives (RePaint outpainting,
DDPM sampling, or a model class not registered yet).  A config that moves
from one list to the other is port progress, recorded here."""

import glob
import os

import pytest

from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.registry import build_architecture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.py"), recursive=True)
                 if "_base_" not in p and not os.path.basename(p).startswith("_"))

BUILDS = {"gt.py", "stmogen/t2m_humanml3d.py", "stmogen/t2m_motionx_0_125b.py",
          "stmogen/t2m_motionx_0_25b.py", "stmogen/t2m_motionx_align.py",
          "stmogen/t2m_motionx_mix.py", "tests/flagship_calib.py", "tests/protocol_gt.py",
          "tests/protocol_learn.py", "tests/tiny_t2m.py"}
REPAINT = {"mcm/mcm_m2d_finedance.py", "mcm/mcm_s2g_beats2.py", "stmogen/m2d_finedance.py",
           "stmogen/m2d_finedance_0125b.py", "stmogen/m2d_finedance_0125b_local_unfreeze.py",
           "stmogen/s2g_beats2_0125b.py", "stmogen/s2g_beats2_0125b_local_unfreeze.py",
           "stmogen/s2g_beats2_025b.py", "tests/fixture_m2d.py", "tests/tiny_m2d.py",
           "tests/tiny_s2g.py"}
DDPM = {"mcm/mcm_t2m_smplx.py", "mdm/mdm_kit.py", "mdm/mdm_t2m.py", "mdm/mdm_t2m_official.py",
        "mdm/mdm_t2m_smplx.py", "motiondiffuse/motiondiffuse_kit.py",
        "motiondiffuse/motiondiffuse_t2m.py", "motiondiffuse/motiondiffuse_t2m_smplx.py"}
UNREGISTERED = {"finemogen/finemogen_kit.py": "FineMoGenTransformer",
                "finemogen/finemogen_t2m.py": "FineMoGenTransformer",
                "finemogen/finemogen_t2m_smplx.py": "FineMoGenTransformer",
                "mcm/mcm_t2m.py": "MCMTransformer",
                "remodiffuse/remodiffuse_t2m.py": "ReMoDiffuseTransformer"}


def test_every_config_is_listed_once():
    lists = [BUILDS, REPAINT, DDPM, set(UNREGISTERED)]
    assert sorted(set().union(*lists)) == CONFIGS
    assert sum(map(len, lists)) == len(CONFIGS)
    assert (len(BUILDS), len(REPAINT), len(DDPM), len(UNREGISTERED)) == (10, 11, 8, 5)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_or_raises_its_reason(name):
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    if name in BUILDS:
        arch = build_architecture(cfg.model, device="cpu")
        assert arch.inference_type in ("ddim", "gt")
        assert (arch.model is None) == (arch.inference_type == "gt")
        return
    if name in REPAINT:
        err, reason = NotImplementedError, "repaint"
    elif name in DDPM:
        err, reason = NotImplementedError, "inference_type 'ddpm'"
    else:
        err, reason = KeyError, f"{UNREGISTERED[name]} is not registered"
    with pytest.raises(err, match=reason):
        build_architecture(cfg.model, device="cpu")
