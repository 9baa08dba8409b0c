"""Multi-process evaluation of the port against the JAX package's semantics,
on the CPU.

- ``RoundUpSampler`` and ``build_dataloader(dist=True)``: each rank's
  indices, shuffled and not, rounded up and not, for 2 and 4 replicas and
  two epochs, equal the JAX package's; ``interleave_parts`` equals JAX's on
  equal and unequal parts.
- ``collect_results`` over 2 and 4 gloo ranks (parallel/mesh.py:launch;
  tests/torch_dist_ranks.py): every rank gets every item once, in dataset
  order, the round-up padding cut, as JAX's ``interleave_parts`` of the
  same parts gives; ``build_dataloader(dist=True)`` reads the rank and the
  world from the process group; ``mean_across_hosts`` and the backward of
  ``all_reduce_sum`` / ``all_gather_rows`` (each rank's gradient the sum of
  the ranks' gradients of its input); ``gather_rows`` in the global order
  of the microbatch layout.
- ``multi_host_test`` over 2 ranks on the tiny T2M model (DDIM over 4 steps)
  and a list dataset of 7 clips at batch 2: every clip once, in dataset
  order, each rank's part equal to ``single_device_test`` over its slice
  with ``seed + rank``, in the rank and in this process.
- ``single_device_test(dispatch_batches=3)`` against 1: the same
  predictions bit for bit, a short last group included.
- The rows' layout of parallel/mesh.py on a mesh of 2: ``local_rows``,
  ``shard_batch`` (lists too), ``local_batch_size``, ``draw_rows``.
"""

import numpy as np
import pytest

import torch_dist_ranks as ranks
from motioncraft_tpu.data.loader import RoundUpSampler as JaxSampler
from motioncraft_tpu.data.loader import build_dataloader as jax_build_dataloader
from motioncraft_tpu.utils.dist_utils import interleave_parts as jax_interleave
from motioncraft_tpu_torch.apis import single_device_test, tiny_t2m_cfg
from motioncraft_tpu_torch.data import RoundUpSampler, build_dataloader
from motioncraft_tpu_torch.parallel.mesh import launch
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict
from motioncraft_tpu_torch.utils.dist_utils import interleave_parts

N_CLIPS, BATCH, SEED, T = 7, 2, 5, 16


@pytest.mark.parametrize("world", [2, 4])
def test_sampler_and_dist_loader_indices_match_jax(world):
    for n in (10, 13):
        for shuffle in (True, False):
            for round_up in (True, False):
                for rank in range(world):
                    got = RoundUpSampler(n, shuffle, round_up, world, seed=3, rank=rank)
                    want = JaxSampler(n, shuffle, round_up, world, seed=3, rank=rank)
                    for epoch in (0, 1):
                        got.set_epoch(epoch)
                        want.set_epoch(epoch)
                        np.testing.assert_array_equal(got.indices(), want.indices())
                lt = build_dataloader(list(range(n)), 2, dist=True, num_replicas=world,
                                      rank=world - 1, shuffle=shuffle, round_up=round_up)
                lj = jax_build_dataloader(list(range(n)), 2, dist=True, num_replicas=world,
                                          rank=world - 1, shuffle=shuffle, round_up=round_up)
                assert (lt.batch_size, len(lt)) == (lj.batch_size, len(lj))
                np.testing.assert_array_equal(lt.sampler.indices(), lj.sampler.indices())
    parts = [[0, 3, 6], [1, 4], [2, 5]]
    for total in (None, 5, 7):
        assert interleave_parts(parts, total) == jax_interleave(parts, total)


def test_the_rows_layout():
    """shard_batch / local_rows / local_batch_size / draw_rows on a mesh
    of 2 (no process group needed): rank r holds its half of every
    microbatch, the list values alike, and a per-row draw at the global
    microbatch's shape is cut to the rank's block."""
    import torch

    from motioncraft_tpu_torch.parallel.mesh import (DataMesh, draw_rows, local_batch_size,
                                                     local_rows, shard_batch)

    mesh = DataMesh(world=2, rank=1, device=torch.device("cpu"), backend="gloo")
    assert local_rows(8, None).tolist() == list(range(8)) and local_batch_size(8, mesh) == 4
    assert local_rows(8, mesh).tolist() == [4, 5, 6, 7]
    assert local_rows(8, mesh, grad_accum=2).tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError):
        local_rows(6, mesh, grad_accum=2)
    batch = {"motion": np.arange(8)[:, None], "text": [f"t{i}" for i in range(8)], "n": 3}
    got = shard_batch(batch, mesh, grad_accum=2)
    assert got["motion"].ravel().tolist() == [2, 3, 6, 7] and got["n"] == 3
    assert got["text"] == ["t2", "t3", "t6", "t7"]
    full = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(draw_rows(mesh, lambda s: full[:s[0]], (2, 3)), full[2:])
    assert torch.equal(draw_rows(None, lambda s: full[:s[0]], (2, 3)), full[:2])


def _samples():
    rng = np.random.RandomState(2)
    out = []
    for i in range(N_CLIPS):
        length = int(rng.randint(8, T + 1))
        out.append({"motion": np.zeros((T, 322), np.float32),
                    "motion_mask": (np.arange(T) < length).astype(np.float32),
                    "motion_length": length,
                    "motion_metas": {"text": f"clip {i}: a person walks"}})
    return out


@pytest.fixture(scope="module")
def model():
    cfg = tiny_t2m_cfg()
    cfg["inference_type"] = "ddim"
    arch = build_architecture(cfg, device="cpu")
    sd = fabricate_state_dict(arch.model, seed=1)
    arch.model.load_state_dict(sd, strict=True)
    return cfg, {k: v.numpy() for k, v in sd.items()}, arch


@pytest.fixture(scope="module")
def two_ranks(model, tmp_path_factory):
    cfg, sd, _ = model
    rendezvous = tmp_path_factory.mktemp("dist") / "rendezvous"
    return launch(ranks.eval_rank, 2, args=(cfg, sd, _samples(), BATCH, SEED), backend="gloo",
                  init_method=f"file://{rendezvous}", timeout_s=120, group_timeout_s=60)


def _check_collect(res, world, n):
    # rank r's part holds the interleaved items r, r + W, ... (rounded up)
    parts = [[{"item": int(i % n), "rank": r} for i in range(r, -(-n // world) * world, world)]
             for r in range(world)]
    want = jax_interleave(parts, n)
    assert [d["item"] for d in want] == list(range(n))
    for r in res:
        assert r["merged"] == want
    for rank, r in enumerate(res):
        want_idx = JaxSampler(n, True, True, world, seed=3, rank=rank)
        want_idx.set_epoch(1)
        assert r["indices"] == want_idx.indices().tolist()
        assert r["mean"] == pytest.approx((world - 1) / 2)
        # x = rank + 1 everywhere: the sum, and the gradient of
        # sum_r x_r.sum() + sum_r ((r + 1) x_r).sum() at x_rank
        assert r["total"] == pytest.approx(6 * sum(range(1, world + 1)))
        np.testing.assert_allclose(r["grad"], np.full((2, 3), world * (1 + rank + 1)))
        assert r["rows"].shape == (2 * world, 3)
        # gather_rows: rank r's [4] = 2 microbatches of 2; global order
        want_rows = [4 * q + 2 * i + j for i in range(2) for q in range(world) for j in range(2)]
        assert r["gathered"] == want_rows


def test_collect_results_four_ranks(tmp_path):
    res = launch(ranks.collect_rank, 4, args=(N_CLIPS,), backend="gloo",
                 init_method=f"file://{tmp_path / 'rendezvous'}", timeout_s=120,
                 group_timeout_s=60)
    _check_collect(res, 4, N_CLIPS)


def test_collect_results_two_ranks(two_ranks):
    _check_collect([r["collect"] for r in two_ranks], 2, N_CLIPS)


def _slice_loader(rank, world=2):
    out = build_dataloader(_samples(), BATCH, shuffle=False, round_up=True, dist=True,
                           num_replicas=world, rank=rank)
    out.drop_last = False
    return out


def test_multi_host_test_two_ranks(model, two_ranks):
    _, _, arch = model
    texts = [s["motion_metas"]["text"] for s in _samples()]
    for r in two_ranks:
        assert r["texts"] == texts  # every clip once, in dataset order
        np.testing.assert_array_equal(r["merged"], two_ranks[0]["merged"])
    for rank, r in enumerate(two_ranks):
        with ranks.one_thread():
            here = single_device_test(arch, _slice_loader(rank), seed=SEED + rank,
                                      device="cpu")
        here = np.stack([x["pred_motion"] for x in here])
        np.testing.assert_array_equal(r["local"], here)
        # the merged list holds this rank's clips at rank, rank + 2, ...
        n = len(range(rank, N_CLIPS, 2))
        np.testing.assert_array_equal(r["merged"][rank::2], here[:n])
    assert np.isfinite(two_ranks[0]["merged"]).all()


def test_dispatch_batches_equals_one(model):
    _, _, arch = model
    samples = _samples()

    def run(k):
        loader = build_dataloader(samples, BATCH, shuffle=False, round_up=False)
        loader.drop_last = False
        lines = []
        out = single_device_test(arch, loader, seed=SEED, device="cpu", dispatch_batches=k,
                                 logger=lines.append)
        return np.stack([x["pred_motion"] for x in out]), lines

    (one, lines1), (three, lines3) = run(1), run(3)
    assert one.shape == (N_CLIPS, T, 322) and len(lines1) == len(lines3) == 4
    np.testing.assert_array_equal(three, one)
    with pytest.raises(ValueError, match="dispatch_batches"):
        single_device_test(arch, [], device="cpu", dispatch_batches=0)
