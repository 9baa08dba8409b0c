"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
nothing of JAX, so on a machine with a card and no JAX it runs without the
repository's conftest files (which import JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K4 must agree exactly; K1-K3 to 1e-5 x max |plain| (another summation
order).  The end-to-end case runs a narrow model (widths the kernels take)
on the card and on the CPU with the same weights and noise.
"""

import numpy as np
import pytest
import torch

from motioncraft_tpu_torch.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from motioncraft_tpu_torch.ops.moe_ffn import BLOCK
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

pytestmark = pytest.mark.cuda
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def _case(name, variant, g):
    if name == "moe_positions":
        M, E = variant
        idx = torch.randint(0, E, (M,), generator=g, dtype=torch.int32)
        idx[torch.rand(M, generator=g) < 0.05] = E + 1  # sentinel ids >= E
        return idx, E
    if name == "grouped_ffn":
        E, D, F, be = variant
        return (torch.tensor(be, dtype=torch.int32), _randn(g, len(be) * BLOCK, D),
                _randn(g, E, D, F, scale=D ** -0.5), _randn(g, E, F, scale=0.1),
                _randn(g, E, F, D, scale=F ** -0.5))
    if name == "head_ffn":
        n, H, d, f = variant
        return (_randn(g, n, H * d), _randn(g, H, d, f, scale=d ** -0.5),
                _randn(g, H, f, scale=0.1), _randn(g, H, f, d, scale=f ** -0.5),
                _randn(g, H, d, scale=0.1))
    B, T, H, d, TXT = variant
    mask = torch.ones(B, T, 1)
    mask[1, T // 2:] = 0
    tcond = (torch.arange(B) < B // 2).float().reshape(B, 1, 1)
    return _randn(g, B, T, H, 4 * d), _randn(g, B, TXT, 2 * d), mask, tcond


CASES = [
    ("moe_positions", (1, 16)), ("moe_positions", (5000, 16)),
    ("moe_positions", (70000, 3)),
    ("grouped_ffn", (4, 128, 512, [0, 3, 3, 1])), ("grouped_ffn", (2, 256, 1024, [1, 1])),
    ("grouped_ffn", (3, 32, 64, [2, 0])),
    ("head_ffn", (700, 3, 128, 512)), ("head_ffn", (65, 2, 64, 96)),
    ("stma_linear_attention", (4, 50, 3, 128, 77)),
    ("stma_linear_attention", (2, 33, 5, 32, 7)),
]


@pytest.mark.parametrize("name,variant", CASES, ids=lambda v: str(v))
def test_kernel_matches_plain(cuda, name, variant):
    wrapper, plain = KERNELS[name]
    args = [a.to(cuda) if torch.is_tensor(a) else a
            for a in _case(name, variant, torch.Generator().manual_seed(0))]
    reset_launch_counts()
    got, want = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    if name == "moe_positions":
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=REL * float(want.abs().max()))


def test_narrow_model_samples_alike_on_card_and_cpu(cuda):
    cfg = tiny_t2m_cfg()
    m = cfg["model"]
    m["latent_dim"] = 12 * 32
    m["ca_block_cfg"].update(latent_dim=32, text_latent_dim=32, num_experts=4)
    m["ffn_cfg"].update(latent_dim=32, ffn_dim=64)
    m["text_encoder"]["latent_dim"] = 32
    m["pose_encoder_cfg"]["latent_dim"] = m["pose_decoder_cfg"]["latent_dim"] = 32
    batch = make_text_batch(["a person walks", "someone waves"], max_seq_len=16,
                            lengths=np.array([[16], [9]], np.int32))
    noise = torch.randn(2, 16, 322, generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        arch = build_architecture(cfg, device=dev)
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
        reset_launch_counts()
        out[str(dev)] = arch.sample(batch, noise=noise).cpu()
    steps, layers = arch.diffusion_test.num_timesteps, m["num_layers"]
    assert launch_counts() == {"moe_positions": layers * (steps + 1),
                               "grouped_ffn": layers * (steps + 1),
                               "head_ffn": layers * steps,
                               "stma_linear_attention": layers * steps}
    want = out["cpu"]
    scale = max(1.0, float(want.abs().max()))
    assert float((out["cuda"] - want).abs().max()) <= 1e-4 * scale
