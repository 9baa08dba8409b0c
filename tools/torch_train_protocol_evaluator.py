"""Train the small contrastive SMPL-X evaluator on the learnable protocol tree
with the PyTorch port (the counterpart of tools/train_protocol_evaluator.py,
which trains the JAX package's modules).

The port's ActorAgnosticEncoderModule + DistilbertActorAgnosticModule
(eval/models.py) at the dimensions of configs/tests/protocol_learn.py's
evaluator learn a symmetric InfoNCE loss on negative squared euclidean
distances over the 32-class tree that ``tools/make_tiny_data.py
--protocol-learnable`` writes: an 80/20 split by clip, batches of one clip a
class drawn from ``np.random.RandomState(seed)`` in the JAX tool's order,
Adam.  The frozen DistilBERT gets no update, and dropout is off, as flax's
``apply`` without dropout keys runs.  It prints the held-out batch-32 top-1
retrieval (chance 1/32) and saves the JAX tool's ``.npz`` layout
(``motion/params/...``, ``text/params/...``), which the config's
``init_cfg`` loads in both packages.  Runs on the card unless ``--device
cpu``.

Usage:
  python tools/torch_train_protocol_evaluator.py --root ./data_protocol_learn \\
      --out outputs/protocol_evaluator.npz [--steps 1500] [--lr 1e-3]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the small evaluator dims of configs/tests/protocol_gt.py / protocol_learn.py
# and tools/train_protocol_evaluator.py: keep in sync
MOTION_ENCODER = dict(nfeats=322, vae=True, num_layers=1, latent_dim=32,
                      ff_size=32, num_heads=2)
TEXT_ENCODER = dict(num_layers=1, latent_dim=32, ff_size=32, num_heads=2,
                    bert_cfg=dict(dim=32, n_layers=1, n_heads=2, hidden_dim=64))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default="./data_protocol_learn")
    p.add_argument("--out", default="outputs/protocol_evaluator.npz")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the evaluator trains; cuda raises without a card")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temp", type=float, default=10.0,
                   help="InfoNCE temperature divisor on squared distances")
    return p.parse_args(argv)


def load_tree(root):
    """The tree's motions [n, T, 322] and each clip's first caption."""
    d = os.path.join(root, "datasets", "motionx")
    names = [ln.strip() for ln in open(os.path.join(d, "ann.txt")) if ln.strip()]
    motions, texts = [], []
    for name in names:
        motions.append(np.load(os.path.join(d, "motions", name + ".npy")))
        with open(os.path.join(d, "texts", name + ".txt")) as f:
            texts.append(f.readline().split("#")[0].strip())
    return np.stack(motions).astype(np.float32), texts


def split(cls, seed):
    """The JAX tool's 80/20 split by clip: (rng, train_idx, test_idx,
    by_class), ``rng`` the generator the batch picks go on drawing from."""
    n, k = len(cls), int(cls.max()) + 1
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    train_idx, test_idx = perm[: int(0.8 * n)], perm[int(0.8 * n):]
    by_class = [train_idx[cls[train_idx] == c] for c in range(k)]
    return rng, train_idx, test_idx, by_class


def picks(rng, by_class, batch):
    """One training batch: one clip from each of ``batch`` shuffled classes,
    drawn in the JAX tool's order."""
    return np.array([by_class[c][rng.randint(len(by_class[c]))]
                     for c in rng.permutation(len(by_class))[:batch]])


def info_nce(m_emb, t_emb, temp):
    """Symmetric InfoNCE on logits -|m - t|^2 / temp, the distance expanded
    as |m|^2 + |t|^2 - 2 m.t (the JAX tool's)."""
    import torch
    import torch.nn.functional as F

    d2 = ((m_emb ** 2).sum(-1)[:, None] + (t_emb ** 2).sum(-1)[None, :]
          - 2.0 * m_emb @ t_emb.T)
    logits = -d2 / temp
    labels = torch.arange(m_emb.shape[0], device=m_emb.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def build_modules(seed, device):
    """The two encoders, seeded, in ``eval()`` mode (dropout off)."""
    import torch

    from motioncraft_tpu_torch.eval.models import (ActorAgnosticEncoderModule,
                                                   DistilbertActorAgnosticModule)
    from motioncraft_tpu_torch.models.architecture import exact_f32

    exact_f32()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        motion = ActorAgnosticEncoderModule(**MOTION_ENCODER)
        text = DistilbertActorAgnosticModule(**TEXT_ENCODER)
    return motion.to(device).eval(), text.to(device).eval()


def make_optimizer(motion, text, lr):
    """Adam over both encoders (optax.adam's defaults: betas 0.9 / 0.999,
    eps 1e-8 outside the square root)."""
    import torch

    return torch.optim.Adam(list(motion.parameters()) + list(text.parameters()), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def batch_loss(motion, text, batch, temp):
    """The InfoNCE loss of ``batch`` = (motion [B, T, 322], length [B], ids
    [B, L], mask [B, L]) tensors through the two encoders, with its graph
    whatever the caller's grad mode."""
    import torch

    m, length, ids, mask = batch
    with torch.enable_grad():
        return info_nce(motion(m, length)[0], text(ids, mask)[0], temp)


def train_step(motion, text, optimizer, batch, temp):
    """One Adam step on ``batch_loss``; returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = batch_loss(motion, text, batch, temp)
    loss.backward()
    optimizer.step()
    return loss.detach()


def retrieval_top1(m_emb, t_emb, size=32):
    """Held-out top-1 retrieval within consecutive batches of ``size``
    (numpy embeddings); the protocol's R-precision shape."""
    hits, total = 0, 0
    for s in range(0, len(m_emb) - size + 1, size):
        d2 = ((m_emb[s:s + size, None] - t_emb[None, s:s + size]) ** 2).sum(-1)
        hits += int((d2.argmin(1) == np.arange(size)).sum())
        total += size
    return hits / max(1, total)


def evaluator_tree(motion, text):
    """The JAX tool's ``.npz`` tree: ``{"motion": {"params": ...}, "text":
    {"params": ...}}`` with the flax names."""
    from motioncraft_tpu_torch.utils.convert import to_jax_params

    return {"motion": {"params": to_jax_params(motion.state_dict())},
            "text": {"params": to_jax_params(text.state_dict())}}


def run(args, logger=print) -> dict:
    """Train, report and save as ``args`` say; returns {"top1", "losses",
    "motion", "text"}."""
    import torch

    from motioncraft_tpu_torch.eval.models import _WordPieceTokenizer
    from motioncraft_tpu_torch.utils.checkpoint import save_params

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    motions, texts = load_tree(args.root)
    uniq = sorted(set(texts))
    cls = np.array([uniq.index(t) for t in texts])
    logger(f"{len(texts)} clips, {len(uniq)} caption classes")
    ids_all, mask_all = _WordPieceTokenizer(None)(texts)
    motion_mod, text_mod = build_modules(args.seed, dev)
    optimizer = make_optimizer(motion_mod, text_mod, args.lr)
    rng, _, test_idx, by_class = split(cls, args.seed)
    T = motions.shape[1]
    motions_d = torch.from_numpy(motions).to(dev)
    ids_d = torch.from_numpy(ids_all).long().to(dev)
    mask_d = torch.from_numpy(mask_all).long().to(dev)
    length = torch.full((args.batch,), T, device=dev)
    losses = []
    for it in range(args.steps):
        pick = torch.from_numpy(picks(rng, by_class, args.batch)).to(dev)
        loss = train_step(motion_mod, text_mod, optimizer,
                          (motions_d[pick], length, ids_d[pick], mask_d[pick]), args.temp)
        losses.append(loss)
        if it % 100 == 0 or it == args.steps - 1:
            logger(f"step {it}: loss {float(loss):.4f}")
    with torch.no_grad():
        test = torch.from_numpy(test_idx).to(dev)
        m_emb = motion_mod(motions_d[test], torch.full((len(test_idx),), T, device=dev))[0]
        t_emb = text_mod(ids_d[test], mask_d[test])[0]
    acc = retrieval_top1(m_emb.cpu().numpy(), t_emb.cpu().numpy())
    print(f"held-out batch-32 top-1 retrieval: {acc:.3f} (chance 0.031)")
    if acc < 0.5:
        print("WARNING: evaluator did not train well", file=sys.stderr)
    save_params(args.out, evaluator_tree(motion_mod, text_mod))
    logger(f"saved -> {args.out}")
    return {"top1": acc, "losses": torch.stack(losses).cpu().numpy() if losses else None,
            "motion": motion_mod, "text": text_mod}


def main(argv=None):
    return run(parse_args(argv), logger=lambda m: print(m, file=sys.stderr))


if __name__ == "__main__":
    main()
