"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (``<wrapper>.launches``).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel (built from ``csrc/`` at first use) or raises.
"""

from .moe_ffn import grouped_ffn, grouped_ffn_plain
from .moe_positions import moe_positions_counts, moe_positions_counts_plain
from .sffn import head_ffn, head_ffn_plain
from .stma_attention import stma_linear_attention, stma_linear_attention_plain

# name -> (wrapper, plain version); the names follow the Pallas kernels
KERNELS = {
    "moe_positions": (moe_positions_counts, moe_positions_counts_plain),
    "grouped_ffn": (grouped_ffn, grouped_ffn_plain),
    "head_ffn": (head_ffn, head_ffn_plain),
    "stma_linear_attention": (stma_linear_attention, stma_linear_attention_plain),
}


def reset_launch_counts() -> None:
    for wrapper, _ in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, (wrapper, _) in KERNELS.items()}
