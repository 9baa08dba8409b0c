"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
nothing of JAX, so on a machine with a card and no JAX it runs without the
repository's conftest files (which import JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K4 must agree exactly in its integer outputs and, in route mode, within
1e-6 in its gates (a softmax over E terms summed in another order); a
route also keeps the dispatch invariants.  K1-K3, K5 and K6 agree to
1e-5 x max |plain| (another
summation order; the FFN kernels K1, K2 and K6 run their products in 3xTF32
on the tensor cores, K3's and K5's key softmax is merged from per-CTA
chunks).  K5 and K6 are also held backward: their gradient recomputes the
plain version, so it must equal plain autograd's to the same tolerance.  The end-to-end case runs a narrow model (widths the kernels
take) on the card and on the CPU with the same weights and noise.

The bf16 instantiations of K1-K3, K5 and K6 (``*_bf16``) agree with their
plain versions to 1e-2 x max |plain|: both round the hidden (K1, K2, K6)
and the output to bf16, whose ulp is 3.9e-3 relative, and a sum that lands
near a rounding boundary may round the other way; K5's also rounds A and
the query softmax, its plain version the key softmax too.  K5's and K6's
bf16 gradients recompute the plain version in bf16, so they equal plain
autograd's to that tolerance too.

K6's f16 instantiation (``fused_expert_ffn_f16``, float16 training) agrees
with its plain version on f16 operands to one f16 ulp of the largest
output, 2^-10 x max |plain|; a hidden value past f16's range is +inf in
both, and so is every output it feeds.  Its gradient recomputes the plain
version in f16.  The Wav2Vec2 conditioner and VAESKConv (cuDNN convolutions,
TF32 off) agree with the CPU to 1e-4 of their scale.
"""

import numpy as np
import pytest
import torch

from motioncraft_tpu_torch.apis.factory import make_text_batch, tiny_t2m_cfg
from motioncraft_tpu_torch.ops import COUNTED, KERNELS, launch_counts, reset_launch_counts
from motioncraft_tpu_torch.ops.moe_ffn import BLOCK
from motioncraft_tpu_torch.ops.quant import int_mm, int_mm_plain
from motioncraft_tpu_torch.ops.stma_attention import max_active_clusters
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict
from torch_port_util import grad_mode_on  # noqa: F401
from torch_port_util import check_route_invariants, route_logits, tutel_capacity

pytestmark = pytest.mark.cuda
REL = 1e-5
GATE_ATOL = 1e-6  # moe_route's gates: a softmax over E terms summed in another order
REL_BF16 = 1e-2
REL_F16 = 2.0 ** -10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def _case(name, variant, g):
    if name.endswith("_f16"):  # K6's f32 case's operands, rounded to f16
        return [a.to(torch.float16) for a in _case(name[:-4], variant, g)]
    if name.endswith("_bf16"):  # the f32 case's operands, rounded to bf16
        # (K3's 0/1 mask and text flag stay f32, as the models pass them)
        args = _case(name[:-5], variant, g)
        n = 2 if name.startswith("stma") else len(args)
        return [a.to(torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() and i < n
                else a for i, a in enumerate(args)]
    if name == "moe_route":
        N, E, K, kind = variant
        return (torch.from_numpy(route_logits(N, E, kind, seed=N + E)), K,
                tutel_capacity(N, E, K), BLOCK)
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
    if name == "fused_linear_attention":
        B, T, N, H, d, *kind = variant
        key = _randn(g, B, N, H, d)
        key[0, N // 2:] += -1e6  # masked keys, as STMA's padding gives them
        if kind == ["masked_chunk"]:  # the first CTA's whole chunk, every cell
            key[:, :N // 4] += -1e6
        return _randn(g, B, T, H, d), key, _randn(g, B, N, H, d)
    if name == "fused_expert_ffn":
        E, C, D, F = variant
        xe = _randn(g, E, C, D)
        xe[:, C - C // 3:] = 0  # empty slots
        return (xe, _randn(g, E, D, F, scale=D ** -0.5), _randn(g, E, F, scale=0.1),
                _randn(g, E, F, D, scale=F ** -0.5), _randn(g, E, D, scale=0.1))
    B, T, H, d, TXT, *kind = variant
    mask = torch.ones(B, T, 1)
    mask[1, T // 2:] = 0
    tcond = (torch.arange(B) < B // 2).float().reshape(B, 1, 1)
    if kind == ["length_1"]:
        mask[:, 1:] = 0
    if kind == ["text_off"]:
        tcond.zero_()
    return _randn(g, B, T, H, 4 * d), _randn(g, B, TXT, 2 * d), mask, tcond


CASES = [
    # the flagship's motion MoE (N = 75264, E = 16, K = 2; capacity 14112),
    # the same leaning to one expert (drops), its text MoE (N = 2464)
    ("moe_route", (75264, 16, 2, "balanced")), ("moe_route", (75264, 16, 2, "skewed")),
    ("moe_route", (2464, 16, 2, "balanced")),
    # more tiles (1172) than the card holds blocks of 512 threads at once
    # (an SM holds 2048 threads: 4 x 132 = 528), so blocks take several;
    # E = 4, K = 1; equal logits; E = 64 (the wider kernel), K = 8; N < 32
    ("moe_route", (600000, 16, 2, "skewed")), ("moe_route", (5000, 4, 1, "ties")),
    ("moe_route", (3000, 64, 8, "ties")), ("moe_route", (7, 16, 2, "balanced")),
    ("moe_positions", (1, 16)), ("moe_positions", (5000, 16)),
    ("moe_positions", (70000, 3)), ("moe_positions", (600000, 16)),
    ("moe_positions", (3000, 256)),
    ("grouped_ffn", (4, 128, 512, [0, 3, 3, 1])), ("grouped_ffn", (2, 256, 1024, [1, 1])),
    ("grouped_ffn", (3, 32, 64, [2, 0])),
    # the four 128-row tiles of a block share its expert, the next block has
    # another; D = 256 (64-row tiles, 32-column chunks); F not a multiple of
    # the 64-column chunk
    ("grouped_ffn", (4, 128, 512, [2, 0, 0, 3])), ("grouped_ffn", (3, 256, 1024, [2, 0, 1])),
    ("grouped_ffn", (2, 64, 96, [1, 0, 1])),
    ("head_ffn", (700, 3, 128, 512)), ("head_ffn", (65, 2, 64, 96)),
    # the flagship's SFFN (x [6272, 12 x 128], F 512); D = 256 and D = 32;
    # fewer rows than one tile
    ("head_ffn", (6272, 12, 128, 512)), ("head_ffn", (300, 2, 256, 1024)),
    ("head_ffn", (200, 4, 32, 128)), ("head_ffn", (50, 3, 64, 256)),
    ("stma_linear_attention", (4, 50, 3, 128, 77)),
    ("stma_linear_attention", (2, 33, 5, 32, 7)),
    # every motion row masked past length 1; text off for the whole batch;
    # 37 rows over a cluster of 4; d = 16 (a cluster of 2, 27 rows)
    ("stma_linear_attention", (3, 40, 2, 64, 9, "length_1")),
    ("stma_linear_attention", (2, 50, 3, 128, 77, "text_off")),
    ("stma_linear_attention", (2, 30, 2, 32, 7)), ("stma_linear_attention", (3, 21, 2, 16, 6)),
    # more than one 64-row query step per CTA
    ("stma_linear_attention", (2, 300, 2, 32, 77)),
    # the flagship training step at B = 32: STMA's global attention (77 text
    # + 196 motion keys), the motion and the text MoE's slot buffers
    ("fused_linear_attention", (32, 196, 273, 12, 128)),
    ("fused_linear_attention", (4, 50, 77, 3, 16)),
    ("fused_linear_attention", (2, 33, 40, 5, 64)),
    # a CTA's chunk made only of -1e6 keys; fewer keys than CTAs in a cluster
    ("fused_linear_attention", (3, 20, 40, 2, 128, "masked_chunk")),
    ("fused_linear_attention", (2, 5, 3, 2, 32)),
    # many 32-row key steps and 64-row query steps per CTA
    ("fused_linear_attention", (2, 300, 700, 2, 64)),
    # the baselines' inference shapes at B = 16: MotionDiffuse's self- and
    # cross-attention, MCM's channel attention (d = 49, padded to 64) and
    # cross-attention; other widths the wrapper pads (5 -> 16, 100 -> 128)
    ("fused_linear_attention", (16, 196, 196, 8, 64)),
    ("fused_linear_attention", (16, 196, 77, 8, 64)),
    ("fused_linear_attention", (16, 512, 512, 4, 49)),
    ("fused_linear_attention", (16, 196, 77, 4, 128)),
    ("fused_linear_attention", (2, 20, 30, 3, 5)), ("fused_linear_attention", (2, 10, 9, 2, 100)),
    ("fused_expert_ffn", (16, 14112, 128, 512)),
    ("fused_expert_ffn", (16, 462, 256, 1024)),
    ("fused_expert_ffn", (3, 37, 32, 128)),
    # fewer slots than one tile; ragged last tiles at D = 256; a part-filled
    # last hidden chunk (F 96, chunks of 64)
    ("fused_expert_ffn", (4, 50, 128, 512)), ("fused_expert_ffn", (3, 100, 256, 384)),
    ("fused_expert_ffn", (2, 70, 256, 192)), ("fused_expert_ffn", (2, 130, 64, 96)),
    # the M2D shapes of one recording (a CFG-doubled 2 x 120 window): the
    # motion MoE (N = 2880, and 1440 at layer 0's dedup, leaning to one
    # expert), the text MoE (N = 154); K1's 28 and 17 blocks of 512 rows
    # with empty experts; K2's 240 rows; K3's 2 x 120 frames
    ("moe_route", (2880, 16, 2, "balanced")), ("moe_route", (1440, 16, 2, "skewed")),
    ("moe_route", (154, 16, 2, "balanced")),
    ("grouped_ffn", (16, 128, 512, [min(i // 2, 13) for i in range(28)])),
    ("grouped_ffn", (16, 256, 1024, [min(i, 15) for i in range(17)])),
    ("head_ffn", (240, 12, 128, 512)),
    ("stma_linear_attention", (2, 120, 12, 128, 77)),
    # 4 recordings in lockstep (8 x 120): the motion MoE (N = 11520, and 5760
    # at layer 0, leaning to one expert), the text MoE (N = 616); K1's 61
    # blocks; K2's 960 rows; K3's 8 x 120 frames
    ("moe_route", (11520, 16, 2, "balanced")), ("moe_route", (5760, 16, 2, "skewed")),
    ("moe_route", (616, 16, 2, "balanced")),
    ("grouped_ffn", (16, 128, 512, [min(i // 4, 15) for i in range(61)])),
    ("head_ffn", (960, 12, 128, 512)),
    ("stma_linear_attention", (8, 120, 12, 128, 77)),
    # the S2G shapes (a CFG-doubled 2 x 64 window, and 8 x 64 for 4
    # recordings in lockstep): the motion MoE (N = 1536 / 6144, and 768 /
    # 3072 at layer 0, leaning to one expert); K1's 22 and 40 blocks; K2's
    # 128 and 512 rows; K3's 2 x 64 and 8 x 64 frames (the text MoE's 154 /
    # 616 tokens are the M2D cases above)
    ("moe_route", (1536, 16, 2, "balanced")), ("moe_route", (768, 16, 2, "skewed")),
    ("moe_route", (6144, 16, 2, "balanced")), ("moe_route", (3072, 16, 2, "skewed")),
    ("grouped_ffn", (16, 128, 512, [min(i // 2, 15) for i in range(22)])),
    ("grouped_ffn", (16, 128, 512, [min(i // 3, 15) for i in range(40)])),
    ("head_ffn", (128, 12, 128, 512)), ("head_ffn", (512, 12, 128, 512)),
    ("stma_linear_attention", (2, 64, 12, 128, 77)),
    ("stma_linear_attention", (8, 64, 12, 128, 77)),
    # FineMoGen at B = 16 (32 CFG rows of 196 frames, 64-wide heads): SAMI's
    # motion MoE at D = 64, F = 256 (N = 75264 tokens x 2 over 311 blocks of
    # 512 rows; its text MoE is the flagship's D = 256 case above) and SFFN
    # at d = 64, F = 512 over 12 heads (finemogen_t2m_smplx) and 8 (the
    # HumanML3D / KIT-ML configs)
    ("grouped_ffn", (16, 64, 256, [min(i // 19, 15) for i in range(311)])),
    ("head_ffn", (6272, 12, 64, 512)), ("head_ffn", (6272, 8, 64, 512)),
    # the zoo's STMoGen variants at 2 requests (4 CFG rows of 196 frames):
    # V1's K3 over 98 patches and its SFFN at F 256; V2's text MoE on one
    # 32-wide text head a body-part head (2464 tokens x 2, D = 32, F = 128),
    # K5 over 77 text + 196 motion keys in 8 heads, K2 at 8 heads; V3's 23
    # joint heads: the motion MoE (N = 18032, and 9016 at layer 0, leaning
    # to one expert), K2 and K3
    ("stma_linear_attention", (4, 98, 12, 128, 77)), ("head_ffn", (392, 12, 128, 256)),
    ("grouped_ffn", (16, 32, 128, [min(i // 2, 15) for i in range(26)])),
    ("fused_linear_attention", (4, 196, 273, 8, 128)), ("head_ffn", (784, 8, 128, 512)),
    ("moe_route", (18032, 16, 2, "balanced")), ("moe_route", (9016, 16, 2, "skewed")),
    ("head_ffn", (784, 23, 128, 512)), ("stma_linear_attention", (4, 196, 23, 128, 77)),
]
GRAD_CASES = [c for c in CASES if c[0] in ("fused_linear_attention", "fused_expert_ffn")]
BF16_CASES = [
    # K1: four 128-row tiles of a block on one expert; D = 256; a part-filled
    # hidden chunk (F 96); D = 32; the flagship's text MoE (26 blocks of 256)
    ("grouped_ffn_bf16", (4, 128, 512, [2, 0, 0, 3])),
    ("grouped_ffn_bf16", (3, 256, 1024, [2, 0, 1])),
    ("grouped_ffn_bf16", (2, 64, 96, [1, 0, 1])), ("grouped_ffn_bf16", (3, 32, 64, [2, 0])),
    ("grouped_ffn_bf16", (16, 256, 1024, [min(i, 15) for i in range(26)])),
    # K2: the flagship's SFFN; D = 256, D = 32; a part-filled chunk; fewer
    # rows than one tile
    ("head_ffn_bf16", (6272, 12, 128, 512)), ("head_ffn_bf16", (300, 2, 256, 1024)),
    ("head_ffn_bf16", (200, 4, 32, 128)), ("head_ffn_bf16", (65, 2, 64, 96)),
    ("head_ffn_bf16", (50, 3, 64, 256)),
    # K3: the flagship's (32 x 196 frames, 77 text rows); masked rows; text
    # off; d = 16; more than one 64-row query step per CTA
    ("stma_linear_attention_bf16", (32, 196, 12, 128, 77)),
    ("stma_linear_attention_bf16", (3, 40, 2, 64, 9, "length_1")),
    ("stma_linear_attention_bf16", (2, 50, 3, 128, 77, "text_off")),
    ("stma_linear_attention_bf16", (3, 21, 2, 16, 6)),
    ("stma_linear_attention_bf16", (2, 300, 2, 32, 77)),
    # K6: the flagship's text slots at B = 32 (bf16 training's text MoE);
    # a ragged last slot tile of each expert (C = 37, 130); D = 64
    # (FineMoGen's motion slots) with a part-filled hidden chunk
    ("fused_expert_ffn_bf16", (16, 462, 256, 1024)),
    ("fused_expert_ffn_bf16", (3, 37, 256, 1024)),
    ("fused_expert_ffn_bf16", (4, 130, 128, 512)),
    ("fused_expert_ffn_bf16", (2, 130, 64, 96)),
    # K5: d = 16, 32, 64, 128; MCM's channel self-attention (512 channel
    # tokens of 196 frames over 4 heads: d = 49, run padded to 64) and its
    # text cross-attention at B = 16; a masked first chunk
    ("fused_linear_attention_bf16", (4, 50, 77, 3, 16)),
    ("fused_linear_attention_bf16", (2, 33, 40, 5, 32)),
    ("fused_linear_attention_bf16", (2, 300, 700, 2, 64)),
    ("fused_linear_attention_bf16", (3, 20, 40, 2, 128, "masked_chunk")),
    ("fused_linear_attention_bf16", (16, 512, 512, 4, 49)),
    ("fused_linear_attention_bf16", (16, 196, 77, 4, 128)),
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
    if name == "moe_route":
        for field, a, b in zip(got._fields, got, want):
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=0, atol=GATE_ATOL, msg=field)
            else:
                assert a.dtype == torch.int32 and torch.equal(a, b), field
        check_route_invariants(got, args[2])
    elif name == "moe_positions":
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=REL * float(want.abs().max()))


# K6's f16 instantiation: the flagship's text slots at B = 32 (float16
# training's text MoE), a ragged last slot tile, D = 128 and 32
F16_CASES = [("fused_expert_ffn_f16", (16, 462, 256, 1024)),
             ("fused_expert_ffn_f16", (3, 37, 256, 1024)),
             ("fused_expert_ffn_f16", (4, 130, 128, 512)),
             ("fused_expert_ffn_f16", (2, 40, 32, 128))]
HALF = {"_bf16": (torch.bfloat16, REL_BF16), "_f16": (torch.float16, REL_F16)}


def _half(name):
    """(the f32 kernel's name, the 16-bit dtype, the tolerance) of a 16-bit
    instantiation's name."""
    base, _, suffix = name.rpartition("_")
    return (base, *HALF[f"_{suffix}"])


@pytest.mark.parametrize("name,variant", BF16_CASES + F16_CASES, ids=lambda v: str(v))
def test_bf16_kernel_matches_plain(cuda, name, variant):
    """Each 16-bit instantiation (bf16; K6's f16), reached through its f32
    wrapper as the models call it, against its plain version on the same
    16-bit operands."""
    base, dtype, rel = _half(name)
    wrapper, plain = KERNELS[base][0], KERNELS[name][1]
    args = [a.to(cuda) if torch.is_tensor(a) else a
            for a in _case(name, variant, torch.Generator().manual_seed(0))]
    reset_launch_counts()
    got, want = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts[name] == 1 and counts[base] == 0
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * float(want.float().abs().max()))


@pytest.mark.parametrize("name,variant",
                         GRAD_CASES + [c for c in BF16_CASES if c[0] in (
                             "fused_expert_ffn_bf16", "fused_linear_attention_bf16")]
                         + F16_CASES, ids=lambda v: str(v))
def test_kernel_gradient_matches_plain(cuda, name, variant):
    wrapper, plain = KERNELS[name]
    g = torch.Generator().manual_seed(1)
    args = [a.to(cuda) for a in _case(name, variant, g)]
    rel = _half(name)[2] if name.endswith(("_bf16", "_f16")) else REL
    grads = []
    for fn in (wrapper, plain):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves)
        if not grads:
            weight = torch.randn(out.shape, generator=g).to(cuda)
        grads.append(torch.autograd.grad((out * weight).sum(), leaves))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=rel * float(want.abs().max()))


def test_f16_kernel_keeps_an_overflow(cuda):
    """A hidden unit driven past f16's 65504 (positive: the GELU keeps it)
    is +inf in the kernel as in the plain version: its slot's outputs are
    +-inf by the sign of w2's row, at the same places."""
    from motioncraft_tpu_torch.ops import fused_expert_ffn_f16

    g = torch.Generator().manual_seed(2)
    xe, w1, b1, w2, b2 = _case("fused_expert_ffn", (2, 40, 32, 128), g)
    xe[:, 0], w1[:, :, 0], b1[:, 0] = 8.0, 100.0, 70000.0 - 800.0 * 32
    args = [a.to(torch.float16).to(cuda) for a in (xe, w1, b1, w2, b2)]
    got, want = fused_expert_ffn_f16(*args).float(), KERNELS["fused_expert_ffn_f16"][1](*args)
    want = want.float()
    finite = torch.isfinite(want)
    assert not torch.isnan(want).any() and not finite[:, 0].any() and finite[:, 1:].all()
    assert torch.equal(got[~finite], want[~finite])
    torch.testing.assert_close(got[finite], want[finite], rtol=0,
                               atol=REL_F16 * float(want[finite].abs().max()))


def test_strided_query_is_read_in_place(cuda):
    """STMA hands K5 its query as a column slice of the MoE projection."""
    g = torch.Generator().manual_seed(2)
    feat = _randn(g, 2, 30, 3, 4 * 32).to(cuda)
    key, value = _randn(g, 2, 45, 3, 32).to(cuda), _randn(g, 2, 45, 3, 32).to(cuda)
    wrapper, plain = KERNELS["fused_linear_attention"]
    query = feat[..., 96:]
    assert not query.is_contiguous()
    got, want = wrapper(query, key, value), plain(query, key, value)
    torch.testing.assert_close(got, want, rtol=0, atol=REL * float(want.abs().max()))


def test_k5_keeps_no_graph_under_no_grad(cuda):
    """At inference (torch.no_grad) K5's recompute Function records no
    autograd graph, so none of its inputs is kept for a backward pass, even
    where they require a gradient."""
    g = torch.Generator().manual_seed(3)
    ops = [_randn(g, 2, 77, 4, 49).to(cuda).requires_grad_() for _ in range(3)]
    wrapper, _ = KERNELS["fused_linear_attention"]
    with torch.no_grad():
        out = wrapper(*ops)
    assert out.grad_fn is None and not out.requires_grad
    assert wrapper(*ops).grad_fn is not None


def test_k3_clusters_fit_on_the_card(cuda):
    """Every SM holds at least one CTA of a d = 128 cell's cluster at once."""
    assert max_active_clusters() * 4 >= torch.cuda.get_device_properties(0).multi_processor_count


def _narrow(cfg):
    """A T2M model config at widths the kernels take (d = 32)."""
    m = cfg["model"]
    m["latent_dim"] = 12 * 32
    m["ca_block_cfg"].update(latent_dim=32, text_latent_dim=32, num_experts=4)
    m["ffn_cfg"].update(latent_dim=32, ffn_dim=64)
    m["text_encoder"]["latent_dim"] = 32
    m["pose_encoder_cfg"]["latent_dim"] = m["pose_decoder_cfg"]["latent_dim"] = 32
    return cfg


@pytest.mark.parametrize("m,k,n,col", [(1, 1536, 2048, True), (2, 20, 12, False),
                                       (17, 128, 512, False), (40, 322, 128, True),
                                       (1764, 64, 256, False), (1764, 64, 256, True)])
def test_int_mm_is_the_int32_product(cuda, m, k, n, col):
    """int_mm on the card (torch._int_mm, padded to its shape rules) equals
    the plain int32 product exactly, counts one launch, and its hooks see
    the caller's shapes; ``col``: a column-major mat2, as nn.Linear's.  The
    [1764, 64] x [64, 256] case is FineMoGen's W8A8 motion expert, whose
    row-major mat2 cuBLASLt refuses."""
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k) if col else (k, n), generator=g, dtype=torch.int8)
    b = b.t() if col else b
    seen = []
    int_mm.hooks.append(lambda x, y: seen.append((tuple(x.shape), tuple(y.shape))))
    reset_launch_counts()
    try:
        got = int_mm(a.to(cuda), b.to(cuda)).cpu()
    finally:
        int_mm.hooks.pop()
    assert launch_counts()["int_mm"] == 1 and seen == [((m, k), (k, n))]
    assert torch.equal(got, int_mm_plain(a, b))


def test_narrow_controlnet_window_alike_on_card_and_cpu(cuda):
    """One outpainted M2D window (RePaint over the jump schedule) of a
    narrow ControlNet, card and CPU on the same weights and draws; every
    base and control layer's kernels launch once a denoiser call."""
    from motioncraft_tpu_torch.apis.factory import flagship_m2d_cfg
    from motioncraft_tpu_torch.diffusion import Outpainting, harmonize_schedule

    cfg = flagship_m2d_cfg(window=40, num_layers=3, latent_dim=32, text_latent_dim=32,
                           ff_size=64, time_embed_dim=64, num_experts=4, clip_width=32,
                           clip_layers=1, respace="10")
    g = torch.Generator().manual_seed(3)
    batch = {"motion": torch.zeros(2, 40, 322), "motion_mask": torch.ones(2, 40),
             "motion_length": torch.full((2, 1), 40),
             "text_ids": torch.as_tensor(make_text_batch(["a", "b"], max_seq_len=40)["text_ids"]),
             "c": torch.randn(2, 40, 163, generator=g)}
    gt = torch.cat([torch.randn(2, 10, 322, generator=g), torch.zeros(2, 30, 322)], dim=1)
    mask = (torch.arange(40) < 10).reshape(1, 40, 1)
    out = {}
    for dev in ("cpu", cuda):
        arch = build_architecture(cfg, device=dev)
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
        pairs = harmonize_schedule(arch.diffusion_test.num_timesteps, arch.repaint_cfg)
        draws = iter([torch.randn(2, 40, 322, generator=torch.Generator().manual_seed(i))
                      for i in range(1 + len(pairs))])
        reset_launch_counts()
        out[str(dev)] = arch.sample({k: v.to(dev) for k, v in batch.items()},
                                    randn=lambda shape: next(draws).to(dev),
                                    outpainting=Outpainting(mask=mask.to(dev),
                                                            gt=gt.to(dev))).cpu()
    calls, layers = sum(d for _, d in pairs), 3 + 2
    assert launch_counts() == dict.fromkeys(COUNTED, 0) | {
        "moe_route": layers * (calls + 1), "grouped_ffn": layers * (calls + 1),
        "head_ffn": layers * calls, "stma_linear_attention": layers * calls}
    want = out["cpu"]
    scale = max(1.0, float(want.abs().max()))
    assert float((out["cuda"] - want).abs().max()) <= 1e-4 * scale


def test_wav_encoder_alike_on_card_and_cpu(cuda):
    """The full-width speech encoder (out_dim 1536) on one 64-frame window
    of onset + amplitude audio (64 x 533 samples -> 64 frames): cuDNN's f32
    convolutions with TF32 off against the CPU's, BatchNorm on seeded
    running statistics."""
    from motioncraft_tpu_torch.models.architecture import exact_f32
    from motioncraft_tpu_torch.models.blocks import WavEncoder

    exact_f32()
    g = torch.Generator().manual_seed(4)
    wav = torch.stack([torch.rand(2, 64 * 533, generator=g) * 0.5,
                       (torch.rand(2, 64 * 533, generator=g) < 2e-4).float()], dim=-1)
    enc = WavEncoder(1536, audio_in=2).eval()
    enc.load_state_dict(fabricate_state_dict(enc, seed=0), strict=True)
    with torch.no_grad():
        want = enc(wav)
        got = enc.to(cuda)(wav.to(cuda)).cpu()
    assert got.shape == (2, 64, 1536) and torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_wav2vec_conditioner_alike_on_card_and_cpu(cuda):
    """The Wav2Vec2 conditioner at its full width (base-960h: 7
    convolutions of 512, 12 layers of 768) on one 64-frame window of 16 kHz
    audio, interpolated to 64 frames and projected to 1536, seeded
    fabricated weights: cuDNN's f32 convolutions (TF32 off) and cuBLAS's
    products against the CPU's."""
    from motioncraft_tpu_torch.models.architecture import exact_f32
    from motioncraft_tpu_torch.models.wav2vec import Wav2Vec2Conditioner

    exact_f32()
    g = torch.Generator().manual_seed(5)
    wav = torch.randn(2, 64 * 533, 2, generator=g) * 0.3
    cond = Wav2Vec2Conditioner(1536).eval()
    cond.load_state_dict(fabricate_state_dict(cond, seed=0), strict=True)
    with torch.no_grad():
        want = cond(wav, 64)
        got = cond.to(cuda)(wav.to(cuda), 64).cpu()
    assert got.shape == (2, 64, 1536) and torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_vaeskconv_alike_on_card_and_cpu(cuda):
    """The S2G embedding model (VAESKConv at the reference's settings) on
    seeded 322-d motions, the same seeded weights on the card and on the
    CPU: its rot6d conversion, masked convolutions and pooling."""
    from motioncraft_tpu_torch.eval.s2g_fid import VAESKConv

    g = torch.Generator().manual_seed(6)
    motion = torch.randn(4, 64, 322, generator=g) * 0.5
    models = {d: VAESKConv(device=d, seed=3) for d in ("cpu", "cuda")}
    want = models["cpu"].encode_motion(motion)
    got = models["cuda"].encode_motion(motion).cpu()
    assert got.shape == (4, 240) and torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_narrow_model_samples_alike_on_card_and_cpu(cuda):
    cfg = _narrow(tiny_t2m_cfg())
    m = cfg["model"]
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
    assert launch_counts() == dict.fromkeys(COUNTED, 0) | {
        "moe_route": layers * (steps + 1), "grouped_ffn": layers * (steps + 1),
        "head_ffn": layers * steps, "stma_linear_attention": layers * steps}
    want = out["cpu"]
    scale = max(1.0, float(want.abs().max()))
    assert float((out["cuda"] - want).abs().max()) <= 1e-4 * scale


def test_narrow_bf16_server_on_the_card(cuda):
    """MotionGenServer over a bf16-cast narrow model on the card: requests
    of two length buckets and one long-form request answer with finite
    motions of their lengths, through the bf16 K1-K3 only (K4 routes the f32
    gate logits)."""
    from motioncraft_tpu_torch.apis import bf16_cast_
    from motioncraft_tpu_torch.serving import MotionGenServer

    arch = build_architecture(_narrow(tiny_t2m_cfg()), device=cuda)
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=0), strict=True)
    bf16_cast_(arch)
    srv = MotionGenServer(arch, max_seq_len=16, batch_buckets=(1, 2, 4), seq_buckets=(8, 16),
                          max_wait_ms=200.0, compute_dtype=torch.bfloat16).warmup()
    reset_launch_counts()
    with srv:
        long = srv.submit_long("a long walk", 40)
        outs = srv.generate(["a person walks", "someone waves", "a jump"], [16, 5, 12],
                            timeout=120)
        outs.append(long.result(timeout=120))
        st = srv.stats()
    assert [o.shape for o in outs] == [(16, 322), (5, 322), (12, 322), (40, 322)]
    assert all(np.isfinite(o).all() for o in outs) and st["requests"] == 4
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("moe_route", "grouped_ffn_bf16", "head_ffn_bf16",
                                       "stma_linear_attention_bf16"))
    assert counts["grouped_ffn"] == counts["head_ffn"] == counts["stma_linear_attention"] == 0
