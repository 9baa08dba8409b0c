#!/usr/bin/env python3
"""Time the 16-bit FFN kernels of a source tree on the card: K1 and K2's
bf16 instantiations at the flagship's sampling shapes (a CFG batch of 16
requests: K1 on the motion, text and layer-0 MoEs, K2), K6's bf16 and,
where the tree has it, f16 instantiation on the flagship's text slots at
B = 32 and 128 (its training batches), each against its plain version.

    python3 tools/profile_torch_ffn16.py [--root DIR] [--out FILE.json]

``--root`` is the tree whose package, kernels and chip_smoke.py run (by
default this one), so that two trees are compared on one card by calling
it once for each, in turns (parent, change, change, parent).  Per case:
the max abs error against the plain version, the device time a call
(torch.profiler) and a back-to-back call's (CUDA events), as
chip_smoke.py's phase 2 measures them.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)  # the tree's relative paths resolve from its root

    import torch

    import chip_smoke as cs
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.ops import KERNELS, _build

    if not torch.cuda.is_available():
        sys.exit("profile_torch_ffn16: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    _build.build()
    cfg = Config.fromfile(os.path.join(root, "configs", "stmogen", "t2m_motionx_0_125b.py"))
    dev = torch.device("cuda")
    model = cfg["model"]
    sample = cs.flagship_inputs(torch, model, dev, training=False)
    layer0 = cs.flagship_inputs(torch, model, dev, training=False, layer0=True)
    cases = {}
    for tag, inputs in (("t2m", sample), ("t2m layer 0", layer0)):
        for name, args_list in cs.bf16_inputs(torch, inputs).items():
            if name != "stma_linear_attention_bf16":
                for i, a in enumerate(args_list):
                    cases[f"{name} {tag} case {i}"] = (name, a)
    for Bt in (cs.TRAIN_BATCH, cfg["data"]["samples_per_gpu"]):
        text = cs.flagship_inputs(torch, model, dev, B2=Bt, Bt=Bt)["fused_expert_ffn"][1:]
        if hasattr(cs, "half_cases"):
            halves = [cs.half_cases(torch, "fused_expert_ffn", text, dt)
                      for dt in ("bfloat16", "float16")]
        else:  # a tree from before K6's f16 instantiation
            halves = [cs.bf16_cases(torch, "fused_expert_ffn", text)]
        for half in halves:
            for name, args_list in half.items():
                cases[f"{name} text B={Bt}"] = (name, args_list[0])
    rows = {}
    for label, (name, a) in cases.items():
        wrapper, plain = KERNELS[name]
        got, want = wrapper(*a), plain(*a)
        torch.cuda.synchronize()
        rows[label] = {"max_abs_err": float((got.float() - want.float()).abs().max()),
                       "scale": float(want.float().abs().max()),
                       "ms": cs.device_ms(torch, lambda: wrapper(*a)),
                       "call_ms": cs.time_ms(torch, lambda: wrapper(*a))}
        print(f"[ffn16] {label}: {rows[label]}", flush=True)
    line = json.dumps({"root": root, "card": card, "cases": rows})
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
