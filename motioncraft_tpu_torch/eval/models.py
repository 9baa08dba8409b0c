"""The learned evaluators of the text-to-motion protocol (PyTorch port of
motioncraft_tpu/eval/models.py): the SMPL-X contrastive evaluator of
MC-Bench (``T2MContrastiveModel_SMPLX``) and the HumanML3D / KIT-ML one of
Guo et al. (``T2MContrastiveModel``).

- ActorAgnosticEncoderModule: a transformer over the 322-d motion with VAE
  mu/logvar tokens; ``encode_motion`` returns mu.
- DistilbertActorAgnosticModule: DistilBERT (6 x 768, learned positions,
  post-LN, exact-erf GELU) -> ReLU + projection -> the same trunk;
  ``encode_text`` returns mu.
- _WordPieceTokenizer: BERT WordPiece given a vocab.txt, else a hash of each
  word (the repository ships no vocabulary).

Both encoders use the port's post-LN encoder layer (models/text_encoder.py)
and carry the flax module and parameter names, so a flax ``params`` tree
loads through ``utils/convert.py:from_jax_params``.  ``init_cfg`` loads a
native ``.npz`` snapshot (``motion/...`` and ``text/...`` leaves, as the JAX
package's evaluator trainer writes it) or the reference ``.ckpt``
(utils/torch_convert.py).  The encoders run on the model's device: the card
unless the caller asks for the CPU.

T2MContrastiveModel: the motion side is MovementConvEncoderModule (two
stride-2 Conv1d + LeakyReLU, a Linear; the last 4 features, the foot
contacts, left out) and a BiGRUCoModule over the quarter-rate sequence at
``length // 4``; the text side a BiGRUCoModule over GloVe word vectors
plus a projection of their POS one-hots (utils/word_vectorizer.py; a
hashed vector per word without ``./data/glove``).  BiGRUCoModule is one
``nn.GRU(bidirectional=True)`` (cuDNN on the card, f32) over
``pack_padded_sequence``, so each direction ends at the row's own last
valid step, as flax's ``nn.RNN(seq_lengths=...)`` does; a row of length 0
runs over its whole padded length, as flax's does.  Its GRU is the one
module whose parameters do not follow flax's names (a flax tree maps onto
it through utils/convert.py:bigru_from_jax_params); it keeps the
reference's, so ``init_cfg``'s checkpoint (``finest.tar``) loads by key
when the file exists.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.architecture import exact_f32, resolve_device
from ..models.blocks import LayerNorm
from ..models.text_encoder import PostLNEncoderLayer
from ..registry import SUBMODULES


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _trunk(module: nn.Module, x, key_mask, n_tok: int):
    """Prepend the distribution tokens, add the sinusoidal positions and run
    the post-LN layers ``layer_0..``; returns the sequence."""
    B, T, L = x.shape
    tokens = (torch.stack([module.mu_token, module.logvar_token]) if n_tok == 2
              else module.emb_token[None])
    xseq = torch.cat([tokens[None].expand(B, n_tok, L), x], dim=1)
    xseq = xseq + torch.from_numpy(sinusoidal_table(T + n_tok, L)).to(x.device)[None]
    mask = torch.cat([torch.ones(B, n_tok, dtype=torch.bool, device=x.device), key_mask],
                     dim=1)
    for i in range(module.num_layers):
        xseq = getattr(module, f"layer_{i}")(xseq, key_mask=mask)
    return xseq


class ActorAgnosticEncoderModule(nn.Module):
    """Transformer + VAE mu/logvar tokens over a motion [B, T, nfeats]."""

    def __init__(self, nfeats: int, vae: bool = True, latent_dim: int = 256,
                 ff_size: int = 1024, num_layers: int = 4, num_heads: int = 4,
                 dropout: float = 0.1, activation: str = "gelu"):
        super().__init__()
        self.vae, self.num_layers = vae, num_layers
        self.skel_embedding = nn.Linear(nfeats, latent_dim)
        if vae:
            self.mu_token = nn.Parameter(torch.randn(latent_dim))
            self.logvar_token = nn.Parameter(torch.randn(latent_dim))
        else:
            self.emb_token = nn.Parameter(torch.randn(latent_dim))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(latent_dim, num_heads, ff_size,
                                                             dropout, activation))

    def forward(self, motion, motion_length):
        T = motion.shape[1]
        valid = torch.arange(T, device=motion.device)[None] < motion_length[:, None]
        xseq = _trunk(self, self.skel_embedding(motion), valid, 2 if self.vae else 1)
        return (xseq[:, 0], xseq[:, 1]) if self.vae else (xseq[:, 0], None)


class DistilBertModule(nn.Module):
    """DistilBERT-base (6 layers, 768 wide, learned positions, post-LN,
    GELU): enough to host converted distilbert-base-uncased weights."""

    def __init__(self, vocab_size: int = 30522, dim: int = 768, n_layers: int = 6,
                 n_heads: int = 12, hidden_dim: int = 3072, max_position: int = 512):
        super().__init__()
        self.n_layers = n_layers
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Embedding(max_position, dim)
        self.emb_ln = LayerNorm(dim)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(dim, n_heads, hidden_dim, 0.0,
                                                             "gelu"))

    def forward(self, input_ids, attention_mask):
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)[None]
        x = self.emb_ln(self.word_embeddings(input_ids) + self.position_embeddings(pos))
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, key_mask=attention_mask.bool())
        return x


class DistilbertActorAgnosticModule(nn.Module):
    """DistilBERT (frozen) -> ReLU + projection -> the ActorAgnostic trunk."""

    def __init__(self, vae: bool = True, latent_dim: int = 256, ff_size: int = 1024,
                 num_layers: int = 4, num_heads: int = 4, dropout: float = 0.1,
                 activation: str = "gelu", bert_cfg: Optional[dict] = None):
        super().__init__()
        self.num_layers = num_layers
        self.text_model = DistilBertModule(**(bert_cfg or {}))
        self.projection = nn.Linear(self.text_model.word_embeddings.embedding_dim,
                                    latent_dim)
        self.mu_token = nn.Parameter(torch.randn(latent_dim))
        self.logvar_token = nn.Parameter(torch.randn(latent_dim))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", PostLNEncoderLayer(latent_dim, num_heads, ff_size,
                                                             dropout, activation))

    def forward(self, input_ids, attention_mask):
        with torch.no_grad():  # the frozen language model
            text = self.text_model(input_ids, attention_mask)
        xseq = _trunk(self, self.projection(F.relu(text)), attention_mask.bool(), 2)
        return xseq[:, 0], xseq[:, 1]


class _WordPieceTokenizer:
    """Minimal BERT WordPiece tokenizer given a vocab.txt; hash fallback."""

    def __init__(self, vocab_path: Optional[str] = None, max_len: int = 64):
        self.max_len = max_len
        self.vocab = None
        if vocab_path and os.path.isfile(vocab_path):
            with open(vocab_path) as f:
                self.vocab = {w.strip(): i for i, w in enumerate(f)}

    def _ids(self, text: str) -> List[int]:
        words = text.lower().split()
        if self.vocab is None:
            return [3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % 30000
                    for w in words]
        ids = []
        for w in words:
            w = "".join(ch for ch in w if ch.isalnum() or ch in "'-")
            if not w:
                continue
            start, sub_ids = 0, []
            while start < len(w):
                end, cur = len(w), None
                while start < end:
                    piece = w[start:end] if start == 0 else "##" + w[start:end]
                    if piece in self.vocab:
                        cur = self.vocab[piece]
                        break
                    end -= 1
                if cur is None:
                    sub_ids = [self.vocab.get("[UNK]", 100)]
                    break
                sub_ids.append(cur)
                start = end
            ids.extend(sub_ids)
        return ids

    def __call__(self, texts: List[str]):
        cls = self.vocab.get("[CLS]", 101) if self.vocab else 101
        sep = self.vocab.get("[SEP]", 102) if self.vocab else 102
        seqs = [[cls] + self._ids(t)[: self.max_len - 2] + [sep] for t in texts]
        L = max(len(s) for s in seqs)
        ids = np.zeros((len(texts), L), np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        return ids, mask


@SUBMODULES.register_module()
class T2MContrastiveModel_SMPLX:
    """MC-Bench SMPL-X 322 contrastive evaluator.  ``encode_motion`` /
    ``encode_text`` return the VAE distribution mean, [B, latent_dim], on
    the model's device.  Without ``init_cfg`` its weights are the modules'
    own initialisation, seeded by ``seed``."""

    def __init__(self, motion_encoder=None, text_encoder=None, init_cfg=None,
                 seed: int = 0, device=None):
        exact_f32()
        self.device = resolve_device(device)
        te = dict(text_encoder or {})
        modelpath = te.pop("modelpath", None)
        te.pop("finetune", None)
        self.tokenizer = _WordPieceTokenizer(
            os.path.join(modelpath, "vocab.txt") if modelpath else None)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.motion_module = ActorAgnosticEncoderModule(
                **(motion_encoder or {"nfeats": 322}))
            self.text_module = DistilbertActorAgnosticModule(**te)
        self.pretrained_loaded = False
        if init_cfg and init_cfg.get("type") == "Pretrained":
            ckpt = init_cfg["checkpoint"]
            if os.path.isfile(ckpt):
                self._load(ckpt)
                self.pretrained_loaded = True
            else:
                print(f"[T2MContrastiveModel_SMPLX] checkpoint {ckpt} not found; "
                      "using random weights (metrics will not be meaningful)")
        self.motion_module.to(self.device).eval()
        self.text_module.to(self.device).eval()

    def _load(self, ckpt: str):
        if ckpt.endswith(".npz"):
            from ..utils.checkpoint import load_params
            from ..utils.convert import from_jax_params
            tree = load_params(ckpt)
            for name, module in (("motion", self.motion_module), ("text", self.text_module)):
                params = tree[name].get("params", tree[name])
                module.load_state_dict(from_jax_params(params), strict=True)
        else:
            from ..utils.torch_convert import load_smplx_evaluator_ckpt
            load_smplx_evaluator_ckpt(ckpt, self.motion_module, self.text_module,
                                      self.motion_module.num_layers)

    def _tensor(self, a, dtype):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def encode_motion(self, motion, motion_length=None, motion_mask=None, **kwargs):
        motion = self._tensor(motion, torch.float32)
        if motion_length is None:
            motion_length = torch.full((motion.shape[0],), motion.shape[1])
        motion_length = self._tensor(motion_length, torch.long).reshape(-1)
        return self.motion_module(motion, motion_length)[0]

    @torch.no_grad()
    def encode_text(self, text, token=None, **kwargs):
        ids, mask = self.tokenizer(list(text))
        return self.text_module(self._tensor(ids, torch.long), self._tensor(mask, torch.long))[0]


class MovementConvEncoderModule(nn.Module):
    """Two stride-2 Conv1d (kernel 4, padding 1) + LeakyReLU(0.2) blocks and
    a Linear, over a motion [B, T, input_size] -> [B, T / 4, output_size]."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.conv1 = nn.Conv1d(input_size, hidden_size, 4, stride=2, padding=1)
        self.conv2 = nn.Conv1d(hidden_size, output_size, 4, stride=2, padding=1)
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x):
        x = F.leaky_relu(self.conv1(x.transpose(1, 2)), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        return self.out_net(x.transpose(1, 2))


class BiGRUCoModule(nn.Module):
    """Linear embedding, a bidirectional GRU from the learned initial
    states ``hidden`` over each row's ``lengths`` frames, the two final
    states joined -> Linear, LayerNorm, LeakyReLU(0.2), Linear."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.hidden = nn.Parameter(torch.randn(2, hidden_size))
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.out1 = nn.Linear(2 * hidden_size, hidden_size)
        self.out_ln = LayerNorm(hidden_size)
        self.out2 = nn.Linear(hidden_size, output_size)

    def forward(self, inputs, lengths):
        B, T = inputs.shape[:2]
        x = self.input_emb(inputs)
        h0 = self.hidden[:, None, :].expand(2, B, -1).contiguous()
        # flax reads a row's final state at index length - 1, so a row of
        # length 0 gets the state after all T steps (its reverse pass flips
        # all T): the whole padded row, which pack_padded_sequence (it
        # refuses a 0) is given here
        lengths = torch.where(lengths == 0, T, lengths)
        packed = nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                                   enforce_sorted=False)
        # cuDNN takes the weights from one buffer, which a deep copy of the
        # module (each metric's evaluator holds one) does not share; a no-op
        # on the CPU
        self.gru.flatten_parameters()
        _, hn = self.gru(packed, h0)
        h = torch.cat([hn[0], hn[1]], dim=-1)
        return self.out2(F.leaky_relu(self.out_ln(self.out1(h)), 0.2))


@SUBMODULES.register_module()
class T2MContrastiveModel:
    """The HumanML3D / KIT-ML contrastive evaluator.  ``encode_motion`` /
    ``encode_text`` return [B, output size] on the model's device.  Without
    ``init_cfg``'s checkpoint its weights are the modules' own
    initialisation, seeded by ``seed``."""

    def __init__(self, motion_encoder=None, text_encoder=None, init_cfg=None,
                 seed: int = 0, device=None):
        from ..utils.word_vectorizer import WordVectorizer

        exact_f32()
        self.device = resolve_device(device)
        me, te = dict(motion_encoder or {}), dict(text_encoder or {})
        self.max_text_len = te.get("max_text_len", 20)
        word_size, pos_size = te.get("word_size", 300), te.get("pos_size", 15)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.movement = MovementConvEncoderModule(
                me.get("input_size", 263) - 4, me.get("movement_hidden_size", 512),
                me.get("movement_latent_size", 512))
            self.motion_gru = BiGRUCoModule(me.get("movement_latent_size", 512),
                                            me.get("motion_hidden_size", 1024),
                                            me.get("motion_latent_size", 512))
            self.text_gru = BiGRUCoModule(word_size, te.get("hidden_size", 512),
                                          te.get("output_size", 512))
            self.pos_emb = nn.Linear(pos_size, word_size)
        self.w_vectorizer = WordVectorizer("./data/glove", "our_vab", word_size=word_size,
                                           pos_size=pos_size)
        self.pretrained_loaded = False
        if init_cfg and init_cfg.get("type") == "Pretrained":
            ckpt = init_cfg["checkpoint"]
            if os.path.isfile(ckpt):
                from ..utils.torch_convert import load_t2m_evaluator_ckpt
                load_t2m_evaluator_ckpt(ckpt, self.movement, self.motion_gru, self.text_gru,
                                        self.pos_emb)
                self.pretrained_loaded = True
            else:
                print(f"[T2MContrastiveModel] checkpoint {ckpt} not found; "
                      "using random weights (metrics will not be meaningful)")
        for m in (self.movement, self.motion_gru, self.text_gru, self.pos_emb):
            m.to(self.device).eval()

    def _tensor(self, a, dtype):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def encode_motion(self, motion, motion_length=None, motion_mask=None, **kwargs):
        """[B, T, input_size] motions of ``motion_length`` frames."""
        motion = self._tensor(motion, torch.float32)
        lengths = self._tensor(motion_length, torch.long).reshape(-1)
        return self.motion_gru(self.movement(motion[..., :-4]), lengths // 4)

    def tokens(self, text, token=None):
        """Each caption's 'word/POS' tokens (its ``token`` line, else its
        words as OTHER) between sos and eos, cut to ``max_text_len`` words
        or padded with unk to ``max_text_len + 2``; and the unpadded
        lengths."""
        rows, lens = [], []
        for i in range(len(text)):
            toks = (token[i].split(" ") if token and token[i]
                    else [f"{w}/OTHER" for w in str(text[i]).split(" ")])
            toks = ["sos/OTHER"] + toks[:self.max_text_len] + ["eos/OTHER"]
            lens.append(len(toks))
            rows.append(toks + ["unk/OTHER"] * (self.max_text_len + 2 - len(toks)))
        return rows, lens

    @torch.no_grad()
    def encode_text(self, text, token=None, **kwargs):
        """Captions (with their 'word/POS' token lines where given) ->
        [B, output size]: word vector plus projected POS one-hot a token."""
        rows, lens = self.tokens(text, token)
        vecs = [[self.w_vectorizer[t] for t in toks] for toks in rows]
        word = np.stack([np.stack([w for w, _ in row]) for row in vecs])
        pos = np.stack([np.stack([p for _, p in row]) for row in vecs])
        inputs = (self._tensor(word, torch.float32)
                  + self.pos_emb(self._tensor(pos, torch.float32)))
        return self.text_gru(inputs, self._tensor(lens, torch.long))
