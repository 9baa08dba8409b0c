"""Which configs of configs/ the port builds: every non-``_base_`` file is
built with the port's registry on the CPU.  The ones it runs build; each of
the others raises for the reason ROADMAP.md gives (a model class not
registered yet).  A config that moves from one list to the other is port
progress, recorded here (the four speech-to-gesture configs, which raised
at the WavEncoder, build since the S2G slice; the eight DDPM configs, which
raised at ``inference_type 'ddpm'``, and ``mcm/mcm_t2m.py``, whose
MCMTransformer was not registered, build since the baselines slice and
carry their inference type and their K5-bearing attentions; the three
FineMoGen configs build since the FineMoGen slice, SAMI in every layer; the
two MCM ControlNet configs and ReMoDiffuse, whose classes were not
registered, build since the slice that ported them, so every config
builds).  Also one CPU run of tools/torch_m2d_test.py over the committed
FineDance fixture."""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.registry import build_architecture
from torch_port_util import bf16_cast_dtypes

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
          "tests/tiny_s2g.py", "mcm/mcm_t2m.py", "mcm/mcm_t2m_smplx.py", "mdm/mdm_kit.py",
          "mdm/mdm_t2m.py", "mdm/mdm_t2m_official.py", "mdm/mdm_t2m_smplx.py",
          "motiondiffuse/motiondiffuse_kit.py", "motiondiffuse/motiondiffuse_t2m.py",
          "motiondiffuse/motiondiffuse_t2m_smplx.py", "finemogen/finemogen_kit.py",
          "finemogen/finemogen_t2m.py", "finemogen/finemogen_t2m_smplx.py",
          "mcm/mcm_m2d_finedance.py", "mcm/mcm_s2g_beats2.py", "remodiffuse/remodiffuse_t2m.py"}
WAV: set = set()  # the configs that raised at the WavEncoder: none since S2G is ported
DDPM: set = set()  # the configs that raised at 'ddpm': none since the baselines slice
# the baselines: each config's inference type and the attention types of its
# layers (the Efficient ones run K5; MDM's trunk is plain attention;
# FineMoGen's SAMI runs K4's route and K1 in its MoEs; ReMoDiffuse's
# semantics-modulated attention and its retrieval encoder's self-attention
# run K5)
BASELINES = {"mcm/mcm_t2m.py": ("ddim", "MCMTransformer"),
             "mcm/mcm_t2m_smplx.py": ("ddpm", "MCMTransformer"),
             "mdm/mdm_kit.py": ("ddpm", "MDMTransformer"),
             "mdm/mdm_t2m.py": ("ddpm", "MDMTransformer"),
             "mdm/mdm_t2m_official.py": ("ddpm", "MDMTransformer"),
             "mdm/mdm_t2m_smplx.py": ("ddpm", "MDMTransformer"),
             "motiondiffuse/motiondiffuse_kit.py": ("ddpm", "MotionDiffuseTransformer"),
             "motiondiffuse/motiondiffuse_t2m.py": ("ddpm", "MotionDiffuseTransformer"),
             "motiondiffuse/motiondiffuse_t2m_smplx.py": ("ddpm", "MotionDiffuseTransformer"),
             "finemogen/finemogen_kit.py": ("ddim", "FineMoGenTransformer"),
             "finemogen/finemogen_t2m.py": ("ddim", "FineMoGenTransformer"),
             "finemogen/finemogen_t2m_smplx.py": ("ddim", "FineMoGenTransformer"),
             "mcm/mcm_m2d_finedance.py": ("ddim", "ControlT2MHalfMCM"),
             "mcm/mcm_s2g_beats2.py": ("ddim", "ControlT2MHalfMCM"),
             "remodiffuse/remodiffuse_t2m.py": ("ddim", "ReMoDiffuseTransformer")}
K5_ATTENTIONS = {"EfficientSelfAttention", "EfficientCrossAttention"}
UNREGISTERED: dict = {}  # the configs whose model class is not registered: none since then


def test_every_config_is_listed_once():
    lists = [BUILDS, WAV, DDPM, set(UNREGISTERED)]
    assert sorted(set().union(*lists)) == CONFIGS
    assert sum(map(len, lists)) == len(CONFIGS)
    assert (len(BUILDS), len(WAV), len(DDPM), len(UNREGISTERED)) == (34, 0, 0, 0)
    assert set(BASELINES) <= BUILDS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_or_raises_its_reason(name):
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    if name in BUILDS:
        arch = build_architecture(cfg.model, device="cpu")
        assert arch.inference_type in ("ddim", "gt", "ddpm")
        assert (arch.model is None) == (arch.inference_type == "gt")
        assert (arch.repaint_cfg is not None) == ("m2d" in name or "s2g" in name)
        if "s2g" in name:  # the speech condition's encoder, with its statistics
            assert any(k.endswith("running_var") for k in arch.model.state_dict())
        if name in BASELINES:
            inference_type, model_type = BASELINES[name]
            assert (arch.inference_type, type(arch.model).__name__) == (inference_type,
                                                                       model_type)
            attentions = {type(m).__name__ for m in arch.model.modules()
                          if type(m).__name__.startswith(("Efficient", "SAMI", "STMA",
                                                          "Semantics"))}
            assert attentions == {"MDMTransformer": set(), "FineMoGenTransformer": {"SAMI"},
                                  "ReMoDiffuseTransformer": {"EfficientSelfAttention",
                                                             "SemanticsModulatedAttention"}
                                  }.get(model_type, K5_ATTENTIONS)
        else:
            assert arch.inference_type in ("ddim", "gt")
        return
    with pytest.raises(KeyError, match=f"{UNREGISTERED[name]} is not registered"):
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
    # int8 and the step cache are ported now (tests/test_torch_quant.py runs them)
    for argv, want in ((["--bf16", "--int8"], ("w8a8", 0)), (["--int8"], ("w8a8", 0)),
                       (["--int8-mode", "w8"], ("w8", 0)), (["--step-cache", "4"], (None, 4))):
        args = tool.parse_args(["configs/tests/fixture_m2d.py", *argv])
        assert (args.int8, args.step_cache) == want


def test_torch_m2d_cli_bf16_on_the_fixture(tmp_path, monkeypatch):
    """--bf16 through the windowed sampler: the weights in bf16, the music
    encoded in f32 and cast, every window's denoiser in bf16; finite
    predictions and metrics."""
    spec = importlib.util.spec_from_file_location(
        "torch_m2d_test", os.path.join(REPO, "tools", "torch_m2d_test.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.chdir(REPO)
    run = tool.main(["configs/tests/fixture_m2d.py", "--device", "cpu", "--bf16",
                     "--work-dir", str(tmp_path)])
    assert bf16_cast_dtypes(run["arch"].model) == ({torch.bfloat16}, {torch.float32})
    assert run["windows"] == 5 and run["preds"][0].shape == (64, 322)
    assert np.isfinite(run["preds"][0]).all()
    assert all(np.isfinite(run["out"][k]) for k in ("FID_whole", "FID_hands"))
