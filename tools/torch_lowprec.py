"""The low-precision options of the port's CLIs (tools/torch_test.py,
tools/torch_m2d_test.py, tools/torch_s2g_test.py, tools/torch_serve.py),
declared and applied in one place: ``--bf16``'s cast, ``--int8 [w8a8|w8]``
and its position-safe form ``--int8-mode``, ``--step-cache N`` and, where a
tool offers it, ``--step-cache-table PATH``.

  add_lowprec_args(parser, table=True)
  args = lowprec_from_args(parser.parse_args(argv))
  compute_dtype = apply_lowprec_(arch, args)      # after loading the weights
  sample(..., compute_dtype=compute_dtype, step_cache=step_cache_from_args(args))
"""

import argparse

INT8_MODES = ("w8a8", "w8")


def step_cache_arg(v: str) -> int:
    """0 = off; N >= 2 = the reuse period.  1 is refused: it would be exact
    but look like a cached run."""
    n = int(v)
    if n != 0 and n < 2:
        raise argparse.ArgumentTypeError("--step-cache must be 0 (off) or an integer >= 2")
    return n


def add_lowprec_args(p: argparse.ArgumentParser, table: bool = False) -> None:
    """``--int8``, ``--int8-mode``, ``--step-cache`` and, with ``table``,
    ``--step-cache-table``."""
    p.add_argument("--int8", nargs="?", const="w8a8", default=None, choices=INT8_MODES,
                   help="int8 denoiser weights (ops/quant.py; after --bf16's cast): bare "
                        "--int8 = w8a8 (per-row int8 activations, int32 products), "
                        "'--int8 w8' = weight-only (dequantized into the float products); "
                        "a bare --int8 before a positional swallows it: use --int8-mode")
    p.add_argument("--int8-mode", default=None, choices=INT8_MODES,
                   help="position-safe form of '--int8 MODE'")
    p.add_argument("--step-cache", type=step_cache_arg, default=0, metavar="N",
                   help="layer-residual reuse: each decoder layer computes every N-th DDIM "
                        "step and replays its cached residual otherwise "
                        "(diffusion/stepcache.py); 0 = off (exact)")
    if table:
        p.add_argument("--step-cache-table", default=None, metavar="PATH",
                       help="a calibrated per-(step, layer) reuse table (.npz or .json, "
                            "e.g. artifacts/step_cache_flagship.json); excludes "
                            "--step-cache N")


def lowprec_from_args(args: argparse.Namespace) -> argparse.Namespace:
    """Resolve the parsed options in place: ``--int8-mode`` wins over
    ``--int8``; ``--step-cache N`` and ``--step-cache-table`` exclude each
    other.  Returns ``args``."""
    if args.int8_mode:
        args.int8 = args.int8_mode
    if getattr(args, "step_cache_table", None) is not None and args.step_cache:
        raise SystemExit("--step-cache and --step-cache-table are mutually exclusive")
    return args


def apply_lowprec_(arch, args, logger=print):
    """``--bf16``'s cast, then ``--int8``'s quantization, of the loaded
    ``arch`` in place; returns the compute dtype (None: f32).  An
    architecture without a denoiser (GT mode) is left as it is."""
    import torch

    from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_
    from motioncraft_tpu_torch.ops.quant import count_quantized

    if arch.model is None:
        return None
    compute_dtype = None
    if args.bf16:
        bf16_cast_(arch)
        compute_dtype = torch.bfloat16
    if args.int8:
        int8_quantize_(arch, weight_only=args.int8 == "w8")
        n, elems = count_quantized(arch.model)
        logger(f"int8 ({args.int8}): quantized {n} weights ({elems / 1e6:.1f}M params)")
    return compute_dtype


def step_cache_from_args(args, logger=print):
    """The ``StepCacheConfig`` of ``--step-cache N`` or
    ``--step-cache-table PATH`` (``load_flags``); None when off."""
    from motioncraft_tpu_torch.diffusion.stepcache import StepCacheConfig, load_flags

    table = getattr(args, "step_cache_table", None)
    if table is not None:
        flags = load_flags(table)
        logger(f"step-cache table {table}: {flags.shape[0]} steps x {flags.shape[1]} "
               f"layers, reuse fraction {flags.mean():.1%}")
        return StepCacheConfig(flags=flags)
    return StepCacheConfig(reuse_every=args.step_cache) if args.step_cache else None
