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
A baseline config serves as tools/serve.py serves it (its own sampler, bf16
and int8 included); ReMoDiffuse and MoMatMoGen, which sample only with a
retrieval that neither server builds, exit saying so.

Usage:
  python tools/torch_serve.py configs/stmogen/t2m_motionx_0_125b.py \\
      --checkpoint params.npz --port 8080 --bf16 --warmup
  python tools/torch_serve.py configs/tests/tiny_t2m.py --device cpu --port 8080
  python tools/torch_serve.py CONFIG --checkpoint params.npz --bf16 --int8 --step-cache 2

  curl -s localhost:8080/generate -d '{"text": "a person waves", "length": 64}'
  curl -s localhost:8080/generate_long -d '{"text": "a long walk", "total_frames": 400}'
  curl -s localhost:8080/stats

``--data-parallel`` serves over several cards, one process a rank
(serving/server.py): this process is one rank of torchrun's environment
(``WORLD_SIZE`` > 1; NCCL), else it spawns one rank per visible card
(``--devices N`` on the CPU: N gloo ranks); rank 0 runs the HTTP front and
the dispatcher, every rank samples its rows of each dispatch, and the
batch buckets must be multiples of the rank count.

  python tools/torch_serve.py CONFIG --checkpoint params.npz --data-parallel --buckets 2 4 8
  torchrun --nproc-per-node 4 tools/torch_serve.py CONFIG --data-parallel --buckets 4 8
  python tools/torch_serve.py configs/tests/tiny_t2m.py --device cpu --data-parallel \
      --devices 2 --buckets 2 4 --port 8080
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from tools.torch_lowprec import (add_lowprec_args, apply_lowprec_,  # noqa: E402
                                 lowprec_from_args, step_cache_from_args)
from tools.torch_test import refuse_retrieval  # noqa: E402


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
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each dispatch's batch rows over one process a card "
                        "(batch buckets must tile them)")
    p.add_argument("--devices", type=int, default=None,
                   help="with --data-parallel: the ranks to spawn (default: one a "
                        "visible card; N gloo ranks with --device cpu)")
    args = lowprec_from_args(p.parse_args(argv))
    if args.devices is not None and not args.data_parallel:
        raise SystemExit("--devices counts the ranks of --data-parallel")
    return args


def build_server(args, logger=print, mesh=None):
    """The configured, not yet started MotionGenServer (warmed up with
    ``--warmup``), over ``mesh`` when given (every rank builds it; rank 0
    warms it up while the others follow)."""
    import torch

    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.serving import MotionGenServer
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    device = args.device if mesh is None else mesh.device
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(cfg_options_from_args(args.cfg_options))
    refuse_retrieval(cfg, jax_tool="tools/serve.py")
    model_cfg = cfg.model["model"]
    base_cfg = model_cfg.get("base_model", model_cfg)
    max_seq_len = base_cfg.get("max_seq_len", 196)
    input_feats = base_cfg.get("input_feats", 322)

    arch = build_architecture(cfg.model, device=device)
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
                          step_cache=step_cache_from_args(args, logger), mesh=mesh)
    if args.warmup and (mesh is None or mesh.lead):
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


def serve(args, mesh=None):
    """Build the server over ``mesh`` and serve: rank 0 (or one process)
    over HTTP until interrupted, the other ranks following it."""
    srv = build_server(args, mesh=mesh)
    if mesh is not None and not mesh.lead:
        srv.follow()
        return
    srv.start()
    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv))
    ranks = "" if mesh is None else f", {mesh.world} ranks over {mesh.backend}"
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(buckets {args.buckets}, wait {args.max_wait_ms} ms, "
          f"{'bf16' if args.bf16 else 'f32'}{f', int8 {args.int8}' if args.int8 else ''}"
          f"{f', step cache {args.step_cache}' if args.step_cache > 1 else ''} on "
          f"{args.device}{ranks})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.stop()


def _rank(rank, args):
    """One spawned rank of ``--data-parallel``."""
    from motioncraft_tpu_torch.parallel.mesh import create_mesh, local_device

    serve(args, create_mesh(device=local_device(rank) if args.device == "cuda" else "cpu"))


def main(argv=None):
    args = parse_args(argv)
    if not args.data_parallel:
        return serve(args)
    import torch

    from motioncraft_tpu_torch.parallel.mesh import (create_mesh, init_distributed, launch,
                                                     local_device)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    backend = "nccl" if args.device == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # torchrun: this process is a rank
        rank = init_distributed(backend=backend)
        return serve(args, create_mesh(
            device=local_device(rank) if args.device == "cuda" else "cpu"))
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda" else 0)
    if n < 2:
        raise SystemExit(f"--data-parallel over {n} rank(s): give --devices N (N >= 2) "
                         "on the CPU, or run where several cards are visible")
    launch(_rank, n, args=(args,), backend=backend)


if __name__ == "__main__":
    main()
