"""The HumanML3D / KIT-ML evaluator of the port (Guo et al.'s BiGRU
contrastive model) against the JAX package:

- the word vectors, GloVe-backed and hashed, and the POS one-hots, bit for
  bit;
- the movement encoder and the BiGRU encoder on one seeded flax tree
  (``from_jax_params`` / ``bigru_from_jax_params``, ``strict=True``), with
  lengths below T, 1 and 0 (flax runs a row of length 0 over all T steps);
- the reference checkpoint (``finest.tar``, fabricated here from torch
  modules laid out as the reference's) through both packages' loaders:
  the port's modules hold its tensors by key, and each encoder computes
  what the JAX converter's trees compute; then the whole evaluator's
  ``encode_motion`` and ``encode_text`` (with and without tokens, a
  caption past ``max_text_len``);
- tools/torch_test.py against tools/test.py on a tiny FineMoGen config and
  a synthetic HumanML3D (263-d) or KIT-ML (251-d) tree written into
  tmp_path (the JAX side with ``text_hoist=False``, the port's sampler on
  the JAX run's draws): the five T2M metrics within 1e-4, and GT mode's
  FID ~0.

Encoders: 1e-5 x max(1, max |JAX|) (torch's GRU and convolutions sum in
another order than XLA's); the CLI's metrics 1e-4 relative, as
tests/test_torch_eval_cli.py holds them."""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

import motioncraft_tpu.models  # noqa: F401  (registers the flax classes)
from motioncraft_tpu.eval import models as jax_ev
from motioncraft_tpu.utils import word_vectorizer as jax_wv
from motioncraft_tpu_torch.eval import models as port_ev
from motioncraft_tpu_torch.utils import word_vectorizer as port_wv
from motioncraft_tpu_torch.utils.convert import bigru_from_jax_params, from_jax_params
from torch_port_util import Replay, assert_close_scaled, jax_sample_draws, seeded_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_MODULE, REL = 1e-5, 1e-4
FEATS, T = 263, 16
MOTION_ENC = dict(input_size=FEATS, movement_hidden_size=16, movement_latent_size=12,
                  motion_hidden_size=10, motion_latent_size=8)
TEXT_ENC = dict(word_size=12, pos_size=15, hidden_size=10, output_size=8, max_text_len=6)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ word vectors
TOKENS = ["walk/VERB", "person/NOUN", "the/DET", "zyzzyva/NOUN", "left/Loc_VIP",
          "x/NOPOS", "bare", "sos/OTHER", "unk/OTHER"]


@pytest.mark.parametrize("glove", [False, True], ids=["hashed", "glove"])
def test_word_vectors_bit_for_bit(glove, tmp_path):
    """Hashed vectors of every word without the GloVe files; with them, the
    file's vector for the words it holds and the hash for the others."""
    if glove:
        words = ["walk", "person", "the"]
        vectors = np.random.RandomState(3).randn(len(words), 300).astype(np.float32)
        np.save(tmp_path / "our_vab_data.npy", vectors)
        with open(tmp_path / "our_vab_words.pkl", "wb") as f:
            pickle.dump(words, f)
        with open(tmp_path / "our_vab_idx.pkl", "wb") as f:
            pickle.dump({w: i for i, w in enumerate(words)}, f)
    want = jax_wv.WordVectorizer(str(tmp_path), "our_vab")
    got = port_wv.WordVectorizer(str(tmp_path), "our_vab")
    assert (got.word2vec is None) == (not glove) == (want.word2vec is None)
    assert port_wv.POS_ENUMERATOR == jax_wv.POS_ENUMERATOR
    for token in TOKENS:
        for g, w in zip(got[token], want[token]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w, err_msg=token)
    if glove:
        np.testing.assert_array_equal(got["walk/VERB"][0], vectors[0])


# ----------------------------------------------------------------- encoders
def _carry(flax_module, port_module, *args, mapping=from_jax_params):
    variables = jax.jit(lambda: flax_module.init(jax.random.PRNGKey(0), *args))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 2)
    port_module.load_state_dict(mapping(params), strict=True)
    return lambda *a: np.asarray(jax.jit(lambda v: flax_module.apply(v, *a))(
        {"params": params}))


def test_movement_encoder():
    x = np.random.RandomState(4).randn(3, 196, FEATS - 4).astype(np.float32)
    port = port_ev.MovementConvEncoderModule(FEATS - 4, 16, 12)
    apply = _carry(jax_ev.MovementConvEncoderModule(16, 12), port, x)
    with torch.no_grad():
        got = port(t(x)).numpy()
    assert got.shape == (3, 49, 12)
    assert_close_scaled(got, apply(x), REL_MODULE, "movement encoder")


def test_bigru_encoder():
    rs = np.random.RandomState(5)
    x = rs.randn(4, 9, 7).astype(np.float32)
    lengths = np.array([9, 5, 1, 0])
    port = port_ev.BiGRUCoModule(7, 10, 6)
    apply = _carry(jax_ev.BiGRUCoModule(10, 6), port, x, lengths,
                   mapping=bigru_from_jax_params)
    with torch.no_grad():
        got = port(t(x), t(lengths)).numpy()
        full = port(t(x), t(np.full(4, 9))).numpy()
    assert_close_scaled(got, apply(x, lengths), REL_MODULE, "BiGRU")
    np.testing.assert_array_equal(got[3], full[3])  # length 0: the whole row, as flax
    assert np.abs(got[1] - full[1]).max() > 1e-3  # a shorter row stops at its length


# ---------------------------------------------- the reference checkpoint
class _RefBiGRU(nn.Module):
    """The reference's BiGRU encoder layout (t2m_bigru.py): its state dict
    carries the keys of finest.tar."""

    def __init__(self, input_size, hidden, output, pos_size=None):
        super().__init__()
        if pos_size:
            self.pos_emb = nn.Linear(pos_size, input_size)
        self.input_emb = nn.Linear(input_size, hidden)
        self.gru = nn.GRU(hidden, hidden, batch_first=True, bidirectional=True)
        self.output_net = nn.Sequential(nn.Linear(2 * hidden, hidden), nn.LayerNorm(hidden),
                                        nn.LeakyReLU(0.2, inplace=True), nn.Linear(hidden, output))
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden))


def write_reference_checkpoint(path, seed=0, motion_encoder=MOTION_ENC, text_encoder=TEXT_ENC):
    """A finest.tar of seeded weights in the reference's layout."""
    me, te = motion_encoder, text_encoder
    torch.manual_seed(seed)
    movement = nn.Module()
    movement.main = nn.Sequential(
        nn.Conv1d(me["input_size"] - 4, me["movement_hidden_size"], 4, 2, 1), nn.Dropout(0.2),
        nn.LeakyReLU(0.2), nn.Conv1d(me["movement_hidden_size"], me["movement_latent_size"],
                                     4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2))
    movement.out_net = nn.Linear(me["movement_latent_size"], me["movement_latent_size"])
    motion = _RefBiGRU(me["movement_latent_size"], me["motion_hidden_size"],
                       me["motion_latent_size"])
    text = _RefBiGRU(te["word_size"], te["hidden_size"], te["output_size"], te["pos_size"])
    with torch.no_grad():  # GRU biases well away from 0, so a lost b_hh would show
        for m in (motion, text):
            m.gru.bias_hh_l0.uniform_(-1, 1)
            m.gru.bias_hh_l0_reverse.uniform_(-1, 1)
    torch.save({"movement_encoder": movement.state_dict(), "motion_encoder": motion.state_dict(),
                "text_encoder": text.state_dict(), "epoch": 1}, path)


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """The JAX and the port's evaluator on one fabricated finest.tar, and
    the path; built in a directory without ./data/glove (hashed vectors)."""
    root = tmp_path_factory.mktemp("t2m_evaluator")
    path = str(root / "finest.tar")
    write_reference_checkpoint(path)
    init = dict(type="Pretrained", checkpoint=path)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        jax_model = jax_ev.T2MContrastiveModel(MOTION_ENC, TEXT_ENC, init_cfg=init)
        port = port_ev.T2MContrastiveModel(MOTION_ENC, TEXT_ENC, init_cfg=init, device="cpu")
    finally:
        os.chdir(cwd)
    assert jax_model.pretrained_loaded and port.pretrained_loaded
    assert port.w_vectorizer.word2vec is None
    return jax_model, port, path


def test_load_t2m_evaluator_ckpt_matches_jax(evaluators):
    """The port's modules hold the reference's tensors, renamed, bit for bit
    (the GRU's as they are: its hidden r / z biases stay in ``bias_hh``),
    and each encoder so loaded computes what the JAX converter's trees
    (those biases folded into the input ones) compute, with lengths T, 5, 1
    and 0: 1e-5 x scale."""
    jax_model, port, path = evaluators
    ref = torch.load(path, weights_only=False)
    mov, mot, txt = (ref[k] for k in ("movement_encoder", "motion_encoder", "text_encoder"))
    pairs = [(port.movement, mov, {"conv1": "main.0", "conv2": "main.3"}),
             (port.motion_gru, mot, {"out1": "output_net.0", "out_ln": "output_net.1",
                                     "out2": "output_net.3"}),
             (port.text_gru, txt, {"out1": "output_net.0", "out_ln": "output_net.1",
                                   "out2": "output_net.3"}),
             (port.pos_emb, {k[len("pos_emb."):]: v for k, v in txt.items()
                             if k.startswith("pos_emb.")}, {})]
    for module, sd, names in pairs:
        for k, v in module.state_dict().items():
            head, _, rest = k.partition(".")
            want = sd[f"{names[head]}.{rest}" if head in names else k]
            assert torch.equal(v, want.reshape(v.shape)), k
    H = MOTION_ENC["motion_hidden_size"]
    assert float(port.motion_gru.gru.bias_hh_l0.detach()[:2 * H].abs().max()) > 0.1

    rs = np.random.RandomState(7)
    lengths = np.array([9, 5, 1, 0])
    x = rs.randn(2, 24, FEATS - 4).astype(np.float32)
    want = np.asarray(jax.jit(jax_model.movement.apply)(jax_model.movement_params, x))
    with torch.no_grad():
        assert_close_scaled(port.movement(t(x)).numpy(), want, REL_MODULE, "movement")
    for name, module, flax_module, params, width in (
            ("motion", port.motion_gru, jax_model.motion_gru, jax_model.motion_params,
             MOTION_ENC["movement_latent_size"]),
            ("text", port.text_gru, jax_model.text_gru, jax_model.text_params,
             TEXT_ENC["word_size"])):
        x = rs.randn(4, 9, width).astype(np.float32)
        want = np.asarray(jax.jit(flax_module.apply)(params, x, lengths))
        with torch.no_grad():
            got = module(t(x), t(lengths)).numpy()
        assert_close_scaled(got, want, REL_MODULE, f"{name} BiGRU")


def test_missing_checkpoint_leaves_the_seeded_weights(tmp_path, capsys):
    init = dict(type="Pretrained", checkpoint=str(tmp_path / "absent.tar"))
    a = port_ev.T2MContrastiveModel(MOTION_ENC, TEXT_ENC, init_cfg=init, seed=3, device="cpu")
    b = port_ev.T2MContrastiveModel(MOTION_ENC, TEXT_ENC, seed=3, device="cpu")
    assert not a.pretrained_loaded and "not found" in capsys.readouterr().out
    for x, y in ((a.movement, b.movement), (a.motion_gru, b.motion_gru)):
        assert all(torch.equal(u, v) for u, v in zip(x.state_dict().values(),
                                                     y.state_dict().values()))


def test_encode_motion(evaluators):
    jax_model, port, _ = evaluators
    rs = np.random.RandomState(6)
    motion = rs.randn(4, 196, FEATS).astype(np.float32)
    lengths = np.array([[196], [123], [40], [7]])
    want = np.asarray(jax_model.encode_motion(motion, lengths))
    got = port.encode_motion(motion, lengths).numpy()
    assert got.shape == (4, MOTION_ENC["motion_latent_size"])
    assert_close_scaled(got, want, REL_MODULE, "encode_motion")


@pytest.mark.parametrize("tokens", [False, True], ids=["words", "tokens"])
def test_encode_text(evaluators, tokens):
    """The sos / eos / unk padding to max_text_len + 2 (a caption past
    max_text_len cut), from the token lines or the words as OTHER."""
    jax_model, port, _ = evaluators
    text = ["a person walks", "someone waves both hands high above the head twice", "jumps"]
    token = (["a/DET person/NOUN walk/VERB",
              "someone/PRON wave/VERB both/DET hand/NOUN high/ADV above/ADP the/DET "
              "head/NOUN twice/ADV", "jump/VERB"] if tokens else None)
    rows, lens = port.tokens(text, token)
    assert lens == [5, 8, 3] and all(len(r) == TEXT_ENC["max_text_len"] + 2 for r in rows)
    assert rows[0][0] == "sos/OTHER" and rows[0][4] == "eos/OTHER" and rows[0][5] == "unk/OTHER"
    want = np.asarray(jax_model.encode_text(text, token))
    got = port.encode_text(text, token).numpy()
    assert_close_scaled(got, want, REL_MODULE, f"encode_text tokens={tokens}")


# ------------------------------------------------------------------- CLI
SEED, STEPS = 3, 4
CONFIG = '''
data_keys = ['motion', 'motion_mask', 'motion_length']
pipeline = [
    dict(type='Normalize', mean_path='{root}/datasets/{dataset}/mean.npy',
         std_path='{root}/datasets/{dataset}/std.npy'),
    dict(type='Crop', crop_size={T}),
    dict(type='ToTensor', keys=data_keys[:2]),
    dict(type='Collect', keys=data_keys, meta_keys=['text', 'token']),
]
data = dict(
    samples_per_gpu=4, workers_per_gpu=0,
    test=dict(type='TextMotionDataset', dataset_name='{dataset}', data_prefix='{root}',
              pipeline=pipeline, ann_file='test.txt', motion_dir='motions',
              text_dir='texts', token_dir='tokens',
              eval_cfg=dict(
                  shuffle_indexes=True, replication_times=2,
                  replication_reduction='statistics',
                  evaluator_model=dict(type='T2MContrastiveModel', motion_encoder={me},
                                       text_encoder={te},
                                       init_cfg=dict(type='Pretrained',
                                                     checkpoint='{ckpt}')),
                  metrics=[dict(type='R Precision', batch_size=4, top_k=3),
                           dict(type='Matching Score', batch_size=4),
                           dict(type='FID'), dict(type='Diversity', num_samples=4),
                           dict(type='MultiModality', num_samples=2, num_repeats=2,
                                num_picks=1)]),
              test_mode=True))
model = dict(
    type='MotionDiffusion',
    model=dict(type='FineMoGenTransformer', input_feats={F}, max_seq_len={T},
               latent_dim=64, time_embed_dim=32, num_layers=2,
               ca_block_cfg=dict(type='SAMI', latent_dim=8, text_latent_dim=16,
                                 num_heads=8, num_text_heads=1, num_experts=4, topk=2,
                                 gate_type='cosine_top', gate_noise=1.0, ffn_dim=16,
                                 time_embed_dim=32, max_seq_len={T}, max_text_seq_len=77,
                                 temporal_comb=False, dropout=0),
               ffn_cfg=dict(latent_dim=8, ffn_dim=16, dropout=0, time_embed_dim=32,
                            num_heads=8),
               text_encoder=dict(pretrained_model='clip', latent_dim=16, num_layers=1,
                                 ff_size=16, dropout=0, use_text_proj=False,
                                 clip_width=32, clip_layers=1),
               pose_encoder_cfg=dict(dataset_name='{dataset}', latent_dim=8,
                                     input_dim={F}),
               pose_decoder_cfg=dict(dataset_name='{dataset}', latent_dim=8,
                                     output_dim={F}),
               scale_func_cfg=dict(scale=6.5)),
    loss_recon=dict(type='MSELoss', loss_weight=1, reduction='none'),
    diffusion_train=dict(beta_scheduler='linear', diffusion_steps=1000,
                         model_mean_type='start_x', model_var_type='fixed_large'),
    diffusion_test=dict(beta_scheduler='linear', diffusion_steps=1000,
                        model_mean_type='start_x', model_var_type='fixed_large',
                        respace='{steps}'),
    inference_type='ddim')
'''
METRICS = {"R_precision Top 1", "R_precision Top 2", "R_precision Top 3", "Matching Score",
           "FID", "Diversity", "MultiModality"}


@pytest.fixture(scope="module", params=[("human_ml3d", 263), ("kit_ml", 251)],
                ids=["human_ml3d", "kit_ml"])
def cli_tree(request, tmp_path_factory):
    """A synthetic HumanML3D (263-d) or KIT-ML (251-d) tree of 10 clips,
    finest.tar, the tiny config and a seeded JAX params.npz of its
    denoiser."""
    from motioncraft_tpu.apis.factory import make_text_batch
    from motioncraft_tpu.config import Config
    from motioncraft_tpu.registry import build_architecture as build_jax
    from motioncraft_tpu.utils.checkpoint import save_params

    dataset, feats = request.param
    me = dict(MOTION_ENC, input_size=feats)
    root = tmp_path_factory.mktemp(f"{dataset}_cli")
    smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke.write_humanml3d_tree(str(root), 10, T + 8, SEED, feats=feats, dataset=dataset)
    write_reference_checkpoint(str(root / "finest.tar"), seed=1, motion_encoder=me)
    config = root / f"tiny_{dataset}.py"
    config.write_text(CONFIG.format(root=root, T=T, F=feats, me=me, te=TEXT_ENC,
                                    ckpt=root / "finest.tar", steps=STEPS, dataset=dataset))
    arch = build_jax(Config.fromfile(str(config)).model)
    batch = make_text_batch(["a person walks"], max_seq_len=T, input_feats=feats)
    variables = jax.jit(lambda: arch.init(jax.random.PRNGKey(0), batch))()
    params = seeded_params(jax.tree_util.tree_map(np.asarray, variables["params"]), 4)
    save_params(str(root / "params.npz"), {"params": params})
    return root, str(config), feats


def test_torch_test_matches_the_jax_cli(cli_tree, monkeypatch):
    """DDIM through both CLIs on the same params.npz, evaluator and --seed:
    the JAX run with text_hoist=False; the port's batch i sampled from the
    JAX run's draws (fold_in(PRNGKey(seed), i)).  Then GT mode: FID ~0."""
    from motioncraft_tpu_torch.models.architecture import MotionDiffusion

    root, config, feats = cli_tree
    common = ["--seed", str(SEED), "--checkpoint", str(root / "params.npz")]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", HOME=str(root))
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "test.py"), config,
                          "jax_ddim", *common, "--cfg-options", "model.model.text_hoist=False"],
                         env=env, cwd=str(root), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(root / "jax_ddim" / "metrics.json") as f:
        want = json.load(f)

    sample, calls = MotionDiffusion.sample, []

    def replayed(self, batch, *, generator=None, **kw):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), len(calls))
        calls.append(np.shape(batch["motion"]))
        draws = jax_sample_draws(STEPS, self.repaint_cfg, key, calls[-1])
        return sample(self, batch, randn=Replay(draws), **kw)

    monkeypatch.setattr(MotionDiffusion, "sample", replayed)
    monkeypatch.chdir(root)
    torch_test = _load("torch_test", os.path.join(REPO, "tools", "torch_test.py"))
    run = torch_test.main([config, "port_ddim", "--device", "cpu", *common])
    got = run["out"]
    # 10 clips x 2 replications + 2 x 2 x 2 MultiModality repeats in batches of 4
    assert len(run["results"]) == 28 and len(calls) == 7 and calls[-1] == (4, T, feats)
    assert type(run["arch"].model).__name__ == "FineMoGenTransformer"
    assert run["dataset"].evaluator_model.pretrained_loaded
    assert got["flags"] == want["flags"] and not got["flags"]["untrained_evaluator"]
    keys = {k for k in want if k not in ("flags", "protocol")}
    assert {k.rsplit(" (", 1)[0] for k in keys} == METRICS
    assert set(got) == set(want)
    for k in keys:
        assert np.isfinite(got[k]), k
        assert abs(got[k] - want[k]) <= REL * max(1.0, abs(want[k])), (k, got[k], want[k])

    gt = torch_test.main([config, "port_gt", "--device", "cpu", "--seed", str(SEED),
                          "--cfg-options", "model.inference_type=gt"])["out"]
    assert abs(gt["FID (mean)"]) < 1e-3
