"""The PyTorch port imports nothing of JAX, flax or the JAX package, nor
``transformers`` (which the machine with the card lacks)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "motioncraft_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tools" / "profile_torch_sample.py",
                                        ROOT / "tools" / "profile_torch_train.py",
                                        ROOT / "tools" / "torch_test.py",
                                        ROOT / "tools" / "torch_m2d_test.py",
                                        ROOT / "tools" / "torch_s2g_test.py",
                                        ROOT / "tools" / "torch_serve.py",
                                        ROOT / "tools" / "torch_calibrate_step_cache.py",
                                        ROOT / "tools" / "torch_lowprec.py",
                                        ROOT / "tools" / "profile_torch_m2d.py",
                                        ROOT / "tools" / "torch_train.py",
                                        ROOT / "tools" / "torch_train_protocol_evaluator.py",
                                        ROOT / "tools" / "torch_make_calib_ckpt.py",
                                        ROOT / "tools" / "torch_measure_approx_drift.py",
                                        ROOT / "tools" / "torch_soak_report.py",
                                        ROOT / "tools" / "torch_quality_run.py",
                                        ROOT / "tools" / "torch_visualize.py",
                                        ROOT / "tools" / "torch_m2d_visualize.py",
                                        ROOT / "tools" / "torch_s2g_visualize.py",
                                        ROOT / "tools" / "profile_chip_smoke.py",
                                        ROOT / "tools" / "profile_torch_ffn16.py",
                                        ROOT / "tests" / "torch_dist_ranks.py"]
FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|flax|motioncraft_tpu|transformers)(\.|\s|$)",
    re.MULTILINE)

_BLOCKED = """
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "motioncraft_tpu", "transformers"):
    sys.modules[name] = None  # any import of these raises ImportError
import motioncraft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(motioncraft_tpu_torch.__path__,
                                               "motioncraft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from motioncraft_tpu_torch.diffusion import p_sample_loop, p_sample_step
from motioncraft_tpu_torch.models import (MCMTransformer, MDMTransformer,
                                          MotionDiffuseTransformer)
from motioncraft_tpu_torch.models.attentions import (EfficientCrossAttention,
                                                     EfficientMixedAttention)
from motioncraft_tpu_torch.utils.torch_convert import (convert_mcm, convert_mdm,
                                                       convert_motiondiffuse)
spec = importlib.util.spec_from_file_location("torch_test", "tools/torch_test.py")
torch_test = importlib.util.module_from_spec(spec)
spec.loader.exec_module(torch_test)
torch_test.parse_args(["configs/tests/tiny_t2m.py"])
spec = importlib.util.spec_from_file_location("torch_m2d_test", "tools/torch_m2d_test.py")
torch_m2d_test = importlib.util.module_from_spec(spec)
spec.loader.exec_module(torch_m2d_test)
torch_m2d_test.parse_args(["configs/tests/tiny_m2d.py"])
spec = importlib.util.spec_from_file_location("torch_s2g_test", "tools/torch_s2g_test.py")
torch_s2g_test = importlib.util.module_from_spec(spec)
spec.loader.exec_module(torch_s2g_test)
torch_s2g_test.parse_args(["configs/tests/tiny_s2g.py"])
spec = importlib.util.spec_from_file_location("torch_serve", "tools/torch_serve.py")
torch_serve = importlib.util.module_from_spec(spec)
spec.loader.exec_module(torch_serve)
torch_serve.make_handler(None)
torch_serve.parse_args(["configs/tests/tiny_t2m.py", "--device", "cpu"])
spec = importlib.util.spec_from_file_location("torch_calibrate_step_cache",
                                              "tools/torch_calibrate_step_cache.py")
calibrate = importlib.util.module_from_spec(spec)
spec.loader.exec_module(calibrate)
calibrate.parse_args(["configs/tests/tiny_t2m.py", "out.npz", "--device", "cpu"])
for name, argv in (("torch_train", ["configs/tests/tiny_t2m.py", "--device", "cpu"]),
                   ("torch_train_protocol_evaluator", ["--device", "cpu"]),
                   ("torch_make_calib_ckpt", ["configs/tests/tiny_t2m.py", "out.npz"]),
                   ("torch_measure_approx_drift", ["--modes", "int8"]),
                   ("torch_quality_run", []),
                   ("torch_visualize", ["configs/tests/tiny_t2m.py", "--text", "a", "--web"]),
                   ("torch_m2d_visualize", ["configs/tests/tiny_m2d.py", "--track", "063"]),
                   ("torch_s2g_visualize", ["configs/tests/tiny_s2g.py", "--limit", "1"])):
    spec = importlib.util.spec_from_file_location(name, f"tools/{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.parse_args(argv)
spec = importlib.util.spec_from_file_location("torch_soak_report", "tools/torch_soak_report.py")
soak_report = importlib.util.module_from_spec(spec)
spec.loader.exec_module(soak_report)
soak_report.parse_log("", 32)
spec = importlib.util.spec_from_file_location("torch_dist_ranks", "tests/torch_dist_ranks.py")
sys.modules["torch_dist_ranks"] = dist_ranks = importlib.util.module_from_spec(spec)
spec.loader.exec_module(dist_ranks)
spec = importlib.util.spec_from_file_location("torch_model_ranks", "tests/torch_model_ranks.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in ("data", "data.datasets", "eval", "utils.checkpoint", "utils.torch_convert",
             "apis.eval_hook", "models.controlnet", "apis.windowed", "data.beat2",
             "data.native", "eval.gesture_metrics", "ops.fk", "ops.rotation",
             "ops.smplx_lbs", "serving", "serving.server", "diffusion.stepcache",
             "ops.quant", "models.baselines", "models.diffusion_transformer",
             "parallel.mesh", "utils.dist_utils", "parallel.tp", "parallel.optim",
             "utils.export", "utils.web_player", "utils.render", "utils.fast_render",
             "ops.humanml3d", "data.bvh", "data.mocap", "data.prep", "models.wav2vec",
             "eval.s2g_fid"):
    assert "motioncraft_tpu_torch." + name in names, name
print(len(names))
"""


def test_port_imports_with_jax_flax_and_the_jax_package_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module of the port was imported


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"
