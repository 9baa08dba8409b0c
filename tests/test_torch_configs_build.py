"""Which configs of configs/ the port builds: every non-``_base_`` file is
built with the port's registry on the CPU.  The ones it runs build; each of
the others raises for the reason ROADMAP.md gives (DDPM sampling, or a
model class not registered yet).  A config that moves from one list to the
other is port progress, recorded here (the four speech-to-gesture configs,
which raised at the WavEncoder, build since the S2G slice).  Also one CPU
run of tools/torch_m2d_test.py over the committed FineDance fixture."""

import glob
import importlib.util
import json
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
          "tests/protocol_learn.py", "tests/tiny_t2m.py", "stmogen/m2d_finedance.py",
          "stmogen/m2d_finedance_0125b.py", "stmogen/m2d_finedance_0125b_local_unfreeze.py",
          "tests/fixture_m2d.py", "tests/tiny_m2d.py", "stmogen/s2g_beats2_0125b.py",
          "stmogen/s2g_beats2_0125b_local_unfreeze.py", "stmogen/s2g_beats2_025b.py",
          "tests/tiny_s2g.py"}
WAV: set = set()  # the configs that raised at the WavEncoder: none since S2G is ported
DDPM = {"mcm/mcm_t2m_smplx.py", "mdm/mdm_kit.py", "mdm/mdm_t2m.py", "mdm/mdm_t2m_official.py",
        "mdm/mdm_t2m_smplx.py", "motiondiffuse/motiondiffuse_kit.py",
        "motiondiffuse/motiondiffuse_t2m.py", "motiondiffuse/motiondiffuse_t2m_smplx.py"}
UNREGISTERED = {"finemogen/finemogen_kit.py": "FineMoGenTransformer",
                "finemogen/finemogen_t2m.py": "FineMoGenTransformer",
                "finemogen/finemogen_t2m_smplx.py": "FineMoGenTransformer",
                "mcm/mcm_t2m.py": "MCMTransformer",
                "mcm/mcm_m2d_finedance.py": "ControlT2MHalfMCM",
                "mcm/mcm_s2g_beats2.py": "ControlT2MHalfMCM",
                "remodiffuse/remodiffuse_t2m.py": "ReMoDiffuseTransformer"}


def test_every_config_is_listed_once():
    lists = [BUILDS, WAV, DDPM, set(UNREGISTERED)]
    assert sorted(set().union(*lists)) == CONFIGS
    assert sum(map(len, lists)) == len(CONFIGS)
    assert (len(BUILDS), len(WAV), len(DDPM), len(UNREGISTERED)) == (19, 0, 8, 7)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_or_raises_its_reason(name):
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    if name in BUILDS:
        arch = build_architecture(cfg.model, device="cpu")
        assert arch.inference_type in ("ddim", "gt")
        assert (arch.model is None) == (arch.inference_type == "gt")
        assert (arch.repaint_cfg is not None) == ("m2d" in name or "s2g" in name)
        if "s2g" in name:  # the speech condition's encoder, with its statistics
            assert any(k.endswith("running_var") for k in arch.model.state_dict())
        return
    if name in DDPM:
        err, reason = NotImplementedError, "inference_type 'ddpm'"
    else:
        err, reason = KeyError, f"{UNREGISTERED[name]} is not registered"
    with pytest.raises(err, match=reason):
        build_architecture(cfg.model, device="cpu")


# tools/m2d_test.py's metrics.json: the metrics (Diversity only with more
# than two 150-frame chunks; the fixture has one track of 64 frames), the
# protocol verdict and the honesty flags
M2D_KEYS = {"FID_whole", "FID_hands", "protocol", "flags"}
M2D_FLAGS = {"untrained_evaluator", "hash_tokenizer", "int8_weights", "step_cache"}


def test_torch_m2d_cli_on_the_fixture(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "torch_m2d_test", os.path.join(REPO, "tools", "torch_m2d_test.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.chdir(REPO)  # the config's data paths are relative to the repository
    run = tool.main(["configs/tests/fixture_m2d.py", "--device", "cpu",
                     "--work-dir", str(tmp_path)])
    with open(tmp_path / "metrics.json") as f:
        out = json.load(f)
    assert set(out) == M2D_KEYS and set(out["flags"]) == M2D_FLAGS
    assert out["flags"]["untrained_evaluator"] and not out["protocol"]
    assert out["flags"]["int8_weights"] is False and out["flags"]["step_cache"] == 0
    assert run["windows"] == 5 and run["preds"][0].shape == (64, 322)
    for bad in (["--bf16"], ["--int8"], ["--int8-mode", "w8"], ["--step-cache", "4"]):
        with pytest.raises(SystemExit, match="ROADMAP queue 1: step cache"):
            tool.parse_args(["configs/tests/fixture_m2d.py", *bad])
