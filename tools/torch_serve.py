"""Motion generation over HTTP with the PyTorch port (the counterpart of
tools/serve.py, which serves the JAX package): dynamic request batching over
CFG-DDIM sampling on the card (motioncraft_tpu_torch/serving/server.py).

Concurrent POSTs are grouped by the dispatcher into one sampling call per
batch bucket; ``--bf16`` casts the weights to bf16 and runs the denoiser in
bf16 (the bf16 kernels); ``--int8`` serves int8 denoiser weights (W8A8, as
tools/serve.py's --int8; ``--int8 w8`` or ``--int8-mode w8`` weight-only),
quantized after the cast; ``--step-cache N`` reuses each layer's residual on
all but every N-th DDIM step.  Weights come from ``--checkpoint`` (a
save_params ``.npz`` of either package) or ``--torch-checkpoint`` (a
released ``.pth``); without either they are fabricated from ``--seed``.

Usage:
  python tools/torch_serve.py configs/stmogen/t2m_motionx_0_125b.py \\
      --checkpoint params.npz --port 8080 --bf16 --warmup
  python tools/torch_serve.py configs/tests/tiny_t2m.py --device cpu --port 8080
  python tools/torch_serve.py CONFIG --checkpoint params.npz --bf16 --int8 --step-cache 2

  curl -s localhost:8080/generate -d '{"text": "a person waves", "length": 64}'
  curl -s localhost:8080/generate_long -d '{"text": "a long walk", "total_frames": 400}'
  curl -s localhost:8080/stats

Not ported, and refused: --data-parallel (ROADMAP queue 1: multi-GPU,
serving and the host-side tools).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from tools.torch_lowprec import (add_lowprec_args, apply_lowprec_,  # noqa: E402
                                 lowprec_from_args, step_cache_from_args)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve motion generation with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params snapshot (save_params of either package)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="released reference .pth (converted on load)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs; cuda raises without a card")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="batch buckets: a group is padded to the smallest that holds it")
    p.add_argument("--seq-buckets", type=int, nargs="+", default=None,
                   help="motion-length buckets (must end at max_seq_len)")
    p.add_argument("--max-wait-ms", type=float, default=20.0,
                   help="dynamic-batching window after the first request")
    p.add_argument("--window", type=int, default=None,
                   help="long-form window (default: the model's max_seq_len)")
    p.add_argument("--pre-frames", type=int, default=4,
                   help="overlap frames outpainted between long-form windows")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 denoiser compute (weights cast, compute_dtype bf16)")
    p.add_argument("--warmup", action="store_true",
                   help="sample every bucket once before accepting traffic")
    p.add_argument("--cfg-options", nargs="*", default=None)
    add_lowprec_args(p)
    # tools/serve.py's options that the port does not run yet
    p.add_argument("--data-parallel", action="store_true")
    args = lowprec_from_args(p.parse_args(argv))
    if args.data_parallel:
        raise SystemExit("--data-parallel: serving over several cards is not ported "
                         "(ROADMAP queue 1: multi-GPU, serving and the host-side tools)")
    return args


def build_server(args, logger=print):
    """The configured, not yet started MotionGenServer (warmed up with
    ``--warmup``)."""
    import torch

    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.serving import MotionGenServer
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    model_cfg = cfg.model["model"]
    base_cfg = model_cfg.get("base_model", model_cfg)
    max_seq_len = base_cfg.get("max_seq_len", 196)
    input_feats = base_cfg.get("input_feats", 322)

    arch = build_architecture(cfg.model, device=args.device)
    if args.checkpoint or args.torch_checkpoint:
        load_eval_variables(cfg.model, arch.model, checkpoint=args.checkpoint,
                            torch_checkpoint=args.torch_checkpoint)
    else:
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=args.seed),
                                   strict=True)
    compute_dtype = apply_lowprec_(arch, args, logger)

    mean = std = None
    for step in (cfg.get("data", {}).get("test", {}) or {}).get("pipeline", []):
        if step.get("type") == "Normalize" and os.path.isfile(step["mean_path"]):
            mean, std = np.load(step["mean_path"]), np.load(step["std_path"])

    srv = MotionGenServer(arch, max_seq_len=max_seq_len, input_feats=input_feats,
                          batch_buckets=sorted(set(args.buckets)),
                          seq_buckets=args.seq_buckets, max_wait_ms=args.max_wait_ms,
                          seed=args.seed, compute_dtype=compute_dtype, mean=mean, std=std,
                          window=args.window, pre_frames=args.pre_frames,
                          step_cache=step_cache_from_args(args, logger))
    if args.warmup:
        logger(f"warmup: sampling batch buckets {sorted(set(args.buckets))}")
        srv.warmup()
    return srv


def make_handler(srv):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, srv.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/generate", "/generate_long"):
                return self._json(404, {"error": "unknown path"})
            try:
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                texts = req.get("texts") or [req["text"]]
                conds = req.get("conditions") or [req.get("condition")] * len(texts)
                conds = [None if c is None else np.asarray(c, np.float32) for c in conds]
                if self.path == "/generate_long":
                    totals = req.get("total_frames")
                    totals = totals if isinstance(totals, list) else [totals] * len(texts)
                    futures = [srv.submit_long(t, n, condition=c)
                               for t, n, c in zip(texts, totals, conds)]
                else:
                    lengths = req.get("lengths") or [req.get("length")] * len(texts)
                    futures = [srv.submit(t, n, condition=c)
                               for t, n, c in zip(texts, lengths, conds)]
                outs = [f.result() for f in futures]
                self._json(200, {"motions": [o.tolist() for o in outs],
                                 "lengths": [int(o.shape[0]) for o in outs]})
            except Exception as e:  # noqa: BLE001 -- reported to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # no access log
            pass

    return Handler


def main(argv=None):
    args = parse_args(argv)
    srv = build_server(args).start()
    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv))
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(buckets {args.buckets}, wait {args.max_wait_ms} ms, "
          f"{'bf16' if args.bf16 else 'f32'}{f', int8 {args.int8}' if args.int8 else ''}"
          f"{f', step cache {args.step_cache}' if args.step_cache > 1 else ''} on "
          f"{args.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.stop()


if __name__ == "__main__":
    main()
