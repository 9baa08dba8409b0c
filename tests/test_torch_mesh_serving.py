"""Serving over several ranks (``MotionGenServer(mesh=)``,
``tools/torch_serve.py --data-parallel``) against the one-card server, on
the CPU.

Two gloo ranks (``parallel/mesh.py:launch``, tests/torch_model_ranks.py):
rank 0 runs the dispatcher, each dispatch's batch and generator state are
broadcast, every rank samples its block of the bucket's rows (the draws
at the global shape, the MoEs routed over the whole dispatch) and rank 0
gathers them.  Its answers equal the one-card server's on the same
dispatches (each group fills or pads to a bucket that both split alike):
f32 and bf16 within 1e-5 of scale (the same sums in the same order on the
CPU: the rows of the other rank stay zero in the grouped expert FFN), and
the step cache (``reuse_every`` 2) and W8A8 int8 (every eligible weight,
the experts' too: their slot buffers filled from the whole dispatch's
route) too.  The tiny model's
gate is skewed so that the capacity drops choices.  A batch bucket that
the ranks do not divide raises ``ValueError``, as the JAX package's
server does; ``tools/torch_serve.py --data-parallel --devices 2`` answers
over HTTP what the one-process tool answers.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import torch_model_ranks as ranks
from motioncraft_tpu_torch.apis.factory import tiny_t2m_cfg
from motioncraft_tpu_torch.diffusion.stepcache import StepCacheConfig
from motioncraft_tpu_torch.parallel.mesh import DataMesh, free_port, launch
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.serving import MotionGenServer
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict
from test_torch_serving import _tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16
TEXTS = ["a person walks forward", "someone waves hello", "a man jumps twice",
         "she turns around slowly"]
# each call one group: 4 requests fill the largest bucket at once, 3 are
# padded to it when the window closes
REQUESTS = [(TEXTS, [16, 11, 9, 14]), (TEXTS[:3], [8, 16, 12])]


def _case(**kw):
    cfg = tiny_t2m_cfg(max_seq_len=T)
    cfg["model"]["ca_block_cfg"]["num_experts"] = 4
    arch = build_architecture(cfg, device="cpu")
    sd = fabricate_state_dict(arch.model, seed=2)
    for k, v in sd.items():
        if k.endswith("gate.sim_matrix"):
            v[:, 0] += v[:, 1:].sum(dim=1)  # most tokens lean to expert 0
    return dict(cfg=cfg, sd={k: v.numpy() for k, v in sd.items()}, T=T, buckets=(2, 4),
                wait_ms=400.0, seed=5, requests=REQUESTS, **kw)


CASES = {"f32": _case(), "bf16": _case(bf16=True),
         "step_cache": _case(step_cache=StepCacheConfig(reuse_every=2)),
         "int8": _case(int8=True)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rendezvous = tmp_path_factory.mktemp("serve") / "rendezvous"
    got = launch(ranks.serve_rank, 2, args=(CASES,), backend="gloo",
                 init_method=f"file://{rendezvous}", timeout_s=300, group_timeout_s=120)
    with ranks.one_thread():
        one = {name: ranks.server_case(case) for name, case in CASES.items()}
    return got, one


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_server_against_one_card(served, name):
    got, one = served
    assert got[1][name] is None  # rank 1 followed
    mine, want = got[0][name], one[name]
    assert mine["stats"]["dispatches"] == want["stats"]["dispatches"] == len(REQUESTS)
    assert mine["stats"]["padding_fraction"] == want["stats"]["padding_fraction"] > 0
    for outs, refs in zip(mine["outs"], want["outs"]):
        for o, r in zip(outs, refs):
            assert o.shape == r.shape and np.isfinite(o).all()
            np.testing.assert_allclose(o, r, atol=1e-5 * max(1.0, np.abs(r).max()))


def test_mesh_server_outlives_an_idle_period_past_the_group_timeout(served, tmp_path):
    """Rank 0 idles 12 s against an 8 s process-group timeout: its
    keep-alive broadcasts keep rank 1's wait short, and the server then
    answers as the one-card server does."""
    rendezvous = tmp_path / "rendezvous"
    idle = {"idle": _case(idle_s=12.0, keepalive_s=0.5)}
    got = launch(ranks.serve_rank, 2, args=(idle,), backend="gloo",
                 init_method=f"file://{rendezvous}", timeout_s=300, group_timeout_s=8)
    assert got[1]["idle"] is None
    for outs, refs in zip(got[0]["idle"]["outs"], served[1]["f32"]["outs"]):
        for o, r in zip(outs, refs):
            np.testing.assert_allclose(o, r, atol=1e-5 * max(1.0, np.abs(r).max()))


def test_mesh_server_refuses_a_bucket_the_ranks_do_not_divide():
    arch = build_architecture(tiny_t2m_cfg(max_seq_len=T), device="cpu")
    mesh = DataMesh(world=2, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="not divisible by the mesh's data-parallel size 2"):
        MotionGenServer(arch, max_seq_len=T, batch_buckets=(1, 2, 4), mesh=mesh)
    with pytest.raises(ValueError, match="follow"):
        MotionGenServer(arch, max_seq_len=T).follow()


@pytest.mark.parametrize("n,jax_shape", [(2, (1, 2)), (4, (2, 2)), (8, (4, 2))])
def test_default_meshes_differ_from_jax_on_purpose(n, jax_shape):
    """The JAX package's default ``create_mesh()`` puts 2 on ``expert``
    whenever the device count is even, and its data-parallel server and
    trainer replicate each row over it; the port splits the rows over every
    rank (tools/torch_train.py:mesh_axes), which does no duplicate work, so
    its server takes buckets that are multiples of the row-ranks and says
    so (ROADMAP queue 3, departures)."""
    import importlib.util

    import jax

    from motioncraft_tpu.parallel.mesh import create_mesh

    assert len(jax.devices()) >= n
    mesh = create_mesh(n)
    assert mesh.axis_names == ("data", "expert") and mesh.devices.shape == jax_shape
    spec = importlib.util.spec_from_file_location(
        "torch_train_cli", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "torch_train.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.mesh_axes(n, 1) == (("data",), (n,))
    arch = build_architecture(tiny_t2m_cfg(max_seq_len=T), device="cpu")
    port_mesh = DataMesh(world=n, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="a bucket must be a multiple of the row-ranks"):
        MotionGenServer(arch, max_seq_len=T, batch_buckets=(1, 2, 4, 8), mesh=port_mesh)
    MotionGenServer(arch, max_seq_len=T, batch_buckets=(n, 2 * n), mesh=port_mesh)


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_torch_serve_data_parallel_end_to_end(tmp_path):
    """Two gloo ranks behind tools/torch_serve.py's HTTP front answer a
    request as the one-process tool's server does (the same fabricated
    weights, dispatch 0), with ``--int8``."""
    config = os.path.join(REPO, "configs", "tests", "tiny_t2m.py")
    common = [config, "--device", "cpu", "--buckets", "2", "4", "--seed", "3",
              "--int8", "w8a8"]
    port = free_port()
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "torch_serve.py"),
                             *common, "--data-parallel", "--devices", "2",
                             "--port", str(port)], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    body = {"texts": ["a person waves", "a man runs"], "lengths": [12, 16]}
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5):
                    break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(proc.stdout.read().decode()[-3000:])
                time.sleep(0.5)
        got = _post(port, body)
    finally:
        os.killpg(proc.pid, signal.SIGINT)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
    tool = _tool()
    srv = tool.build_server(tool.parse_args(common), logger=lambda m: None)
    try:
        want = srv.generate(body["texts"], body["lengths"], timeout=120)
    finally:
        srv.stop()
    assert got["lengths"] == [12, 16]
    for o, w in zip(got["motions"], want):
        np.testing.assert_allclose(np.asarray(o, np.float32), w,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
