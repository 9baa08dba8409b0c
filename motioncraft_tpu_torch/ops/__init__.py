"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (``<wrapper>.launches``).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel (built from ``csrc/`` at first use) or raises.  K1, K2,
K3, K5 and K6 have a bf16 instantiation each, with its own wrapper and count
(``*_bf16``); the f32 wrapper hands bf16 operands on to it.  K6 also has an
f16 one (``fused_expert_ffn_f16``, float16 training), handed float16
operands the same way.  ``int_mm``, the W8A8 int8 product
(``torch._int_mm`` on the card, not a kernel of the port), counts its
launches beside them.
"""

from .expert_ffn import (expert_ffn_plain, fused_expert_ffn, fused_expert_ffn_bf16,
                         fused_expert_ffn_f16)
from .linear_attention import (fused_linear_attention, fused_linear_attention_bf16,
                               fused_linear_attention_plain, fused_linear_attention_plain_bf16)
from .moe_ffn import grouped_ffn, grouped_ffn_bf16, grouped_ffn_plain
from .moe_positions import (moe_positions_counts, moe_positions_counts_plain, moe_route,
                            moe_route_plain)
from .quant import int_mm
from .sffn import head_ffn, head_ffn_bf16, head_ffn_plain
from .stma_attention import (stma_linear_attention, stma_linear_attention_bf16,
                             stma_linear_attention_plain)

# name -> (wrapper, plain version); the names follow the Pallas kernels, and
# "moe_route" is K4's kernel with the MoE routing around it
KERNELS = {
    "moe_route": (moe_route, moe_route_plain),
    "moe_positions": (moe_positions_counts, moe_positions_counts_plain),
    "grouped_ffn": (grouped_ffn, grouped_ffn_plain),
    "head_ffn": (head_ffn, head_ffn_plain),
    "stma_linear_attention": (stma_linear_attention, stma_linear_attention_plain),
    "fused_linear_attention": (fused_linear_attention, fused_linear_attention_plain),
    "fused_expert_ffn": (fused_expert_ffn, expert_ffn_plain),
    "grouped_ffn_bf16": (grouped_ffn_bf16, grouped_ffn_plain),
    "head_ffn_bf16": (head_ffn_bf16, head_ffn_plain),
    "stma_linear_attention_bf16": (stma_linear_attention_bf16, stma_linear_attention_plain),
    "fused_expert_ffn_bf16": (fused_expert_ffn_bf16, expert_ffn_plain),
    "fused_expert_ffn_f16": (fused_expert_ffn_f16, expert_ffn_plain),
    "fused_linear_attention_bf16": (fused_linear_attention_bf16,
                                    fused_linear_attention_plain_bf16),
}

# name -> every wrapper with a launch count
COUNTED = {**{name: wrapper for name, (wrapper, _) in KERNELS.items()}, "int_mm": int_mm}


def reset_launch_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}
