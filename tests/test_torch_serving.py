"""The port's serving layer (motioncraft_tpu_torch/serving/server.py and
tools/torch_serve.py) on the CPU, case for case with tests/test_serving.py:
grouped dispatch, bucket padding and its accounting, per-request length
slicing, de-normalisation, determinism per (group, dispatch index), error
fan-out, sequence buckets, HTTP, restart, conditioned requests and
long-form lockstep generation.  Beyond those: a dispatch equals
``MotionDiffusion.sample`` on the same padded batch and generator, bit for
bit; the same scripted requests give the JAX package's server the same
groups, buckets and padding (``stats()`` alike but for latencies); and the
bf16 server answers.  Every wait has a timeout, so a hang fails."""

import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from motioncraft_tpu_torch.apis.factory import bf16_cast_, make_text_batch, tiny_t2m_cfg
from motioncraft_tpu_torch.config import Config
from motioncraft_tpu_torch.registry import build_architecture
from motioncraft_tpu_torch.serving import MotionGenServer
from motioncraft_tpu_torch.serving.server import dispatch_seed
from motioncraft_tpu_torch.utils.convert import fabricate_state_dict
from torch_port_util import bf16_cast_dtypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D = 16, 322
WAIT = 120  # seconds any one future may take


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_serve", os.path.join(REPO, "tools", "torch_serve.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _arch(cfg, seed=0):
    arch = build_architecture(cfg, device="cpu")
    # seeded weights everywhere: the zero-initialised output heads would
    # denoise everything to 0 and leave the determinism checks empty
    arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=seed), strict=True)
    return arch


@pytest.fixture(scope="module")
def arch():
    return _arch(tiny_t2m_cfg(max_seq_len=T))


def _server(arch, **kw):
    kw.setdefault("max_seq_len", T)
    kw.setdefault("batch_buckets", (1, 2, 4))
    kw.setdefault("max_wait_ms", 300.0)
    return MotionGenServer(arch, **kw)


def test_generate_slices_lengths_and_batches(arch):
    with _server(arch) as srv:
        outs = srv.generate(["a person walks", "a person waves", "jumps"], [T, 8, 12],
                            timeout=WAIT)
        assert [o.shape for o in outs] == [(T, D), (8, D), (12, D)]
        assert all(np.isfinite(o).all() for o in outs)
        st = srv.stats()
    # all three rode one dispatch, padded 3 -> bucket 4
    assert st["requests"] == 3 and st["dispatches"] == 1
    assert st["mean_occupancy"] == 3.0
    assert 0 < st["padding_fraction"] <= 0.25
    assert st["latency_p95_s"] > 0


def test_concurrent_submits_group(arch):
    with _server(arch) as srv:
        srv.warmup(buckets=(4,))
        futures = []
        barrier = threading.Barrier(4)

        def client(i):
            barrier.wait(timeout=WAIT)
            futures.append(srv.submit(f"text {i}", 8 + i))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
            assert not th.is_alive()
        res = [f.result(timeout=WAIT) for f in futures]
        assert sorted(r.shape[0] for r in res) == [8, 9, 10, 11]
        st = srv.stats()
    # the wait window is generous: one full-bucket dispatch, no padding
    assert st["dispatches"] == 1 and st["mean_occupancy"] == 4.0
    assert st["padding_fraction"] == 0.0


def test_determinism_per_dispatch(arch):
    texts, lengths = ["walk", "wave"], [T, T]
    with _server(arch, seed=123) as a:
        out_a = a.generate(texts, lengths, timeout=WAIT)
    with _server(arch, seed=123) as b:
        out_b = b.generate(texts, lengths, timeout=WAIT)
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)
    with _server(arch, seed=124) as c:
        out_c = c.generate(texts, lengths, timeout=WAIT)
    assert np.abs(out_a[0] - out_c[0]).max() > 0
    assert len({dispatch_seed(s, i) for s in range(4) for i in range(4)}) == 16


def test_dispatch_is_sample_on_the_padded_batch(arch):
    """A dispatch is one MotionDiffusion.sample of the bucket-padded batch
    (the last request repeated) with dispatch 0's generator, bit for bit."""
    texts, lengths = ["a person walks", "someone waves", "a jump"], [T, 9, 12]
    with _server(arch, seed=7) as srv:
        outs = srv.generate(texts, lengths, timeout=WAIT)
        generator = srv.dispatch_generator(0)
    padded = make_text_batch(texts + texts[-1:], T,
                             lengths=np.asarray(lengths + lengths[-1:], np.int32)[:, None])
    want = arch.sample(padded, generator=generator).numpy()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, want[i, :lengths[i]])


def test_denormalize_applied(arch):
    mean = np.full((D,), 5.0, np.float32)
    std = np.zeros((D,), np.float32)  # out = raw * 1e-9 + 5 ~= 5
    with _server(arch, mean=mean, std=std) as srv:
        out = srv.generate(["walk"], timeout=WAIT)[0]
    np.testing.assert_allclose(out, 5.0, atol=1e-5)


def test_length_validation_and_error_fanout(arch):
    with pytest.raises(ValueError, match="together"):
        _server(arch, std=np.ones((D,), np.float32))  # no mean
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: multi-GPU"):
        _server(arch, mesh=object())
    srv = _server(arch)
    with pytest.raises(ValueError, match="lengths"):
        srv.generate(["a", "b", "c"], [8, 16])  # count mismatch
    with pytest.raises(ValueError, match="length"):
        srv.submit("too long", T + 1)
    # a dispatch that raises fails every future of its group
    srv._compute_dtype = torch.bfloat16  # the weights are f32: sample raises
    fs = [srv.submit("boom", T), srv.submit("bang", 8)]
    for f in fs:
        with pytest.raises(ValueError, match="bf16_cast_"):
            f.result(timeout=WAIT)
    srv.stop()


def test_seq_buckets_partition_group(arch):
    """Requests at different length buckets run separate (shorter) sampling
    calls; the output still has each request's exact length."""
    with _server(arch, seq_buckets=(8, T)) as srv:
        outs = srv.generate(["short walk", "long walk"], [5, 12], timeout=WAIT)
        assert [o.shape for o in outs] == [(5, D), (12, D)]
        st = srv.stats()
    assert st["requests"] == 2 and st["dispatches"] == 2  # one per length bucket
    with pytest.raises(ValueError, match="seq_buckets"):
        _server(arch, seq_buckets=(8,))  # must end at max_seq_len


def _http(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _tool().make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def test_http_endpoints(arch):
    """tools/torch_serve.py's HTTP layer on an ephemeral port: concurrent
    POSTs from two connections batch into one dispatch; /stats and /healthz
    answer; a bad request is a 400 and the server stays up."""
    with _server(arch) as srv:
        httpd, port = _http(srv)
        try:
            results = {}
            c1 = threading.Thread(target=lambda: results.update(
                a=_post(port, "/generate", {"text": "a person waves", "length": 12})))
            c1.start()
            results["b"] = _post(port, "/generate", {"texts": ["walks", "jumps"],
                                                     "lengths": [8, T]})
            c1.join(WAIT)
            assert results["a"]["lengths"] == [12]
            assert len(results["a"]["motions"][0][0]) == D
            assert results["b"]["lengths"] == [8, T]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=30) as r:
                assert json.loads(r.read())["ok"]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
                assert json.loads(r.read())["requests"] == 3
            with pytest.raises(urllib.error.HTTPError) as bad:
                _post(port, "/generate", {"length": 5})
            assert bad.value.code == 400
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_restart_after_stop(arch):
    srv = _server(arch)
    out1 = srv.generate(["walk"], timeout=WAIT)
    srv.stop()
    out2 = srv.generate(["walk"], timeout=WAIT)  # submit() restarts the dispatcher
    assert out1[0].shape == out2[0].shape
    srv.stop()


def test_bf16_server_answers(arch):
    """A bf16-cast copy served with compute_dtype bf16: finite f32 motions
    of the asked lengths, within bf16's reach of the f32 server's."""
    arch16 = bf16_cast_(_arch(tiny_t2m_cfg(max_seq_len=T)))
    texts, lengths = ["walk", "wave"], [T, 10]
    with _server(arch16, seed=3, compute_dtype=torch.bfloat16) as srv:
        srv.warmup(buckets=(2,))
        got = srv.generate(texts, lengths, timeout=WAIT)
    with _server(arch, seed=3) as srv:
        want = srv.generate(texts, lengths, timeout=WAIT)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= 0.1 * max(1.0, np.abs(w).max())


def test_stats_agree_with_the_jax_server(arch):
    """One scripted request list through both servers: the same groups,
    buckets and padding, so every stat but the latencies agrees."""
    import jax

    from motioncraft_tpu.apis import build_flagship
    from motioncraft_tpu.apis import make_text_batch as jax_batch
    from motioncraft_tpu.apis import tiny_t2m_cfg as jax_tiny
    from motioncraft_tpu.serving import MotionGenServer as JaxServer

    jarch = build_flagship(jax_tiny(max_seq_len=T))
    variables = jarch.init(jax.random.PRNGKey(0), jax_batch(["x"], max_seq_len=T))
    script = [(["walk", "wave", "jump"], [T, 8, 12]), (["turn"], [5]),
              (["sit", "run"], [T, 3])]
    stats = []
    for srv in (JaxServer(jarch, variables, max_seq_len=T, batch_buckets=(1, 2, 4),
                          max_wait_ms=300.0),
                _server(arch)):
        with srv:
            for texts, lengths in script:
                outs = srv.generate(texts, lengths) if isinstance(srv, JaxServer) else \
                    srv.generate(texts, lengths, timeout=WAIT)
                assert [o.shape[0] for o in outs] == lengths
            stats.append({k: v for k, v in srv.stats().items() if not k.startswith("latency_p")})
    assert stats[0] == stats[1]
    assert stats[1]["dispatches"] == 3 and stats[1]["padding_fraction"] == 1 / 7


# ------------------------------------------------- conditioned + long-form

@pytest.fixture(scope="module")
def s2g_arch():
    """configs/tests/tiny_s2g.py: the ControlNet with the raw-audio
    WavEncoder condition (onset and amplitude at 16 kHz, 533 samples a
    frame)."""
    return _arch(Config.fromfile(os.path.join(REPO, "configs", "tests", "tiny_s2g.py")).model,
                 seed=1), 16000 // 30


def test_conditioned_requests_batch_and_slice(s2g_arch):
    """Requests with audio of one rate share a dispatch; each output has its
    request's length."""
    arch, rate = s2g_arch
    rng = np.random.RandomState(1)
    with _server(arch) as srv:
        f1 = srv.submit("a person speaks", T,
                        condition=rng.randn(T * rate, 2).astype(np.float32))
        f2 = srv.submit("another person speaks", 10,
                        condition=rng.randn(10 * rate, 2).astype(np.float32))
        o1, o2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
        st = srv.stats()
    assert o1.shape == (T, D) and o2.shape == (10, D)
    assert np.isfinite(o1).all() and np.isfinite(o2).all()
    assert st["dispatches"] == 1  # same rate and trailing shape: one group


def test_condition_validation(s2g_arch):
    arch, rate = s2g_arch
    srv = _server(arch)
    with pytest.raises(ValueError, match="whole"):
        srv.submit("x", 10, condition=np.zeros((10 * rate + 1, 2), np.float32))
    srv.stop()


def test_long_form_lockstep(arch):
    """Two long-form requests run as one lockstep windowed dispatch; the
    outputs are exactly total_frames long."""
    total_a, total_b = 40, 28
    with _server(arch, window=T, pre_frames=4) as srv:
        fa = srv.submit_long("a long walk", total_a)
        fb = srv.submit_long("a long wave", total_b)
        oa, ob = fa.result(timeout=WAIT), fb.result(timeout=WAIT)
        st = srv.stats()
    assert oa.shape == (total_a, D) and ob.shape == (total_b, D)
    assert np.isfinite(oa).all() and np.isfinite(ob).all()
    assert st["long_dispatches"] == 1 and st["requests"] == 2


def test_long_form_covers_total_frames(arch):
    """A total that does not fill whole windows (33 frames at 16-frame
    windows overlapping by 4: 2 windows give 28) is sampled over one more
    window and cut: exactly total_frames, the first 28 as two windows give
    them with the same generator."""
    from motioncraft_tpu_torch.serving.server import covered_frames

    assert covered_frames(33, T, 4) == 40 and covered_frames(28, T, 4) == 28
    assert covered_frames(5, T, 4) == T
    with _server(arch, window=T, pre_frames=4, seed=9) as srv:
        out = srv.submit_long("a long walk", 33).result(timeout=WAIT)
    with _server(arch, window=T, pre_frames=4, seed=9) as srv:
        short = srv.submit_long("a long walk", 28).result(timeout=WAIT)
    assert out.shape == (33, D) and np.isfinite(out).all()
    np.testing.assert_array_equal(out[:28], short)


def test_long_form_conditioned_wav(s2g_arch):
    """One request turns audio of any length into a gesture clip through
    windowed RePaint generation."""
    arch, rate = s2g_arch
    total = 40  # > window = 16: several outpainted windows
    wav = np.random.RandomState(2).randn(total * rate, 2).astype(np.float32)
    with _server(arch, window=T, pre_frames=4) as srv:
        out = srv.submit_long("someone speaks at length", total,
                              condition=wav).result(timeout=WAIT)
    assert out.shape == (total, D)
    assert np.isfinite(out).all()


def test_http_generate_long(arch):
    with _server(arch, window=T, pre_frames=4) as srv:
        httpd, port = _http(srv)
        try:
            body = _post(port, "/generate_long", {"text": "a very long walk",
                                                  "total_frames": 28})
            assert body["lengths"] == [28]
            assert len(body["motions"][0]) == 28 and len(body["motions"][0][0]) == D
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_torch_serve_options():
    """tools/torch_serve.py builds a warmed-up server from a config on the
    CPU and refuses what the port does not run; --int8 is ported now
    (W8A8 when bare, as tools/serve.py's)."""
    tool = _tool()
    assert tool.parse_args(["configs/tests/tiny_t2m.py", "--int8"]).int8 == "w8a8"
    with pytest.raises(SystemExit, match="ROADMAP queue 1: multi-GPU"):
        tool.parse_args(["configs/tests/tiny_t2m.py", "--data-parallel"])
    args = tool.parse_args([os.path.join(REPO, "configs", "tests", "tiny_t2m.py"),
                            "--device", "cpu", "--bf16", "--buckets", "1", "2",
                            "--seq-buckets", "8", "16", "--warmup"])
    srv = tool.build_server(args, logger=lambda m: None)
    try:
        assert bf16_cast_dtypes(srv._arch.model) == ({torch.bfloat16}, {torch.float32})
        out = srv.generate(["a person waves"], [6], timeout=WAIT)[0]
        assert out.shape == (6, D) and np.isfinite(out).all()
    finally:
        srv.stop()
