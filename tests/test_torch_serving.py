"""The port's serving layer (diffusion_rs_tpu_torch/serving.py) against the
JAX package's (tests/test_serving.py's cases, one for one) and against the
port's own offline pipeline, on the tiny f32 pipeline of
torch_port_util.i2i_build with FLUX dense (hidden 256, 1 + 2 blocks; T5
nf4; the 4-level VAE; 64x64 images).

The JAX Pallas kernels run in interpret mode; the port runs its kernels'
plain versions on the CPU. The batched step is held to JAX's at the band
of tests/test_torch_pipeline.py (summed-rel 1e-5, inputs equal); whole
images to the JAX server's own band against its offline pipeline (u8 mean
|diff| < 1, max <= 16). For the server-against-server case both packages
draw the same noise: the port's ``get_noise`` / ``get_encode_noise`` are
the JAX package's draws for the seed (torch_port_util.jax_draws). One JAX
server run and one port server run are shared by the cases that read
them. The mesh cases use a mesh of one rank or, for the dp check, a
stand-in mesh object (the server reads only its axis sizes before it
refuses), so no process world is spawned.
"""

import base64
import copy
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.models.flux import compute_pe as j_compute_pe
from diffusion_rs_tpu.pipelines.sampling import make_img_ids as j_img_ids
from diffusion_rs_tpu.pipelines.sampling import make_txt_ids as j_txt_ids
from diffusion_rs_tpu.serving import FluxServer as JServer
from diffusion_rs_tpu_torch import serving as tserving
from diffusion_rs_tpu_torch.models.flux import compute_pe
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.pipelines.api import encode_png
from diffusion_rs_tpu_torch.pipelines.sampling import make_img_ids, make_txt_ids
from diffusion_rs_tpu_torch.serving import FluxServer, ServerBusy, serve_http
from diffusion_rs_tpu_torch.util.tree import tree_map
from torch_port_util import (  # noqa: F401
    JParams, TParams, TPipeline, i2i_build, jax_draws, jax_interpreted_module, summed_rel,
    to_np)

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the server runs torch on three threads of a
    worker that shares the host's cores with the suite's other workers, and
    oversubscribed thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


I2I_STRENGTH = 0.5
# (prompt, steps, seed, img2img): lanes that finish at different ticks
REQUESTS = [("a cat", 2, 1, False), ("a dog", 4, 2, False), ("a fox", 4, 9, True)]


def _params(steps, seed, cls=TParams, height=64, width=64):
    return cls(height=height, width=width, num_steps=steps, guidance_scale=3.5, seed=seed,
               max_sequence_length=64)


def _init_image():
    return np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)


def _band(got, want):
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    return float(d.mean()), float(d.max())


def _assert_band(got, want, what):
    mean, mx = _band(got, want)
    assert mean < 1.0 and mx <= 16, (what, mean, mx)


def _submit_all(server, cls):
    init = _init_image()
    return [server.submit(p, _params(n, seed, cls),
                          **(dict(init_image=init, strength=I2I_STRENGTH) if i2i else {}))
            for p, n, seed, i2i in REQUESTS]


@pytest.fixture(scope="module")
def pipes(jax_interpreted_module):
    jpipe, kw = i2i_build("float32", dense_flux=True)
    return jpipe, TPipeline(**kw)


@pytest.fixture(scope="module")
def tpipe(pipes):
    return pipes[1]


@pytest.fixture(scope="module")
def served(pipes):
    """REQUESTS through the JAX server and the port's server (both with the
    JAX package's draws), and through the port's offline pipeline with the
    same draws. A long poll lets every lane join the first tick."""
    jpipe, tp = pipes
    server = JServer(jpipe, max_batch=4, poll_ms=500.0)
    try:
        j_out = [f.result(timeout=600) for f in _submit_all(server, JParams)]
    finally:
        server.shutdown()
    noise, encode_noise = jax_draws(jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tserving, sys.modules[TPipeline.__module__]):
            mp.setattr(mod, "get_noise", noise)
            mp.setattr(mod, "get_encode_noise", encode_noise)
        server = FluxServer(tp, max_batch=4, poll_ms=500.0)
        try:
            t_out = [f.result(timeout=600) for f in _submit_all(server, TParams)]
        finally:
            server.shutdown()
        init = _init_image()
        offline = [tp.forward_arrays([p], _params(n, seed),
                                     **(dict(init_image=init, strength=I2I_STRENGTH)
                                        if i2i else {}))[0]
                   for p, n, seed, i2i in REQUESTS]
    return dict(jax=j_out, port=t_out, offline=offline, stats=server.stats())


def test_cb_step_matches_jax(pipes):
    """The batched step: four lanes at distinct t and dt plus a padding lane
    (dt = 0), through both packages' ``_cb_step`` on the same inputs."""
    jpipe, tp = pipes
    cfg = tp.flux_cfg
    rng = np.random.default_rng(0)
    b, t_len, h2 = 5, 64, 4
    lat = rng.standard_normal((b, h2 * h2, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((b, t_len, cfg.joint_attention_dim)).astype(np.float32)
    y = rng.standard_normal((b, cfg.pooled_projection_dim)).astype(np.float32)
    ts = np.array([1.0, 0.8, 0.55, 0.3, 1.0], np.float32)
    dts = np.array([-0.2, -0.25, -0.25, -0.3, 0.0], np.float32)
    gs = np.array([3.5, 3.5, 2.0, 4.0, 3.5], np.float32)
    j_out = np.asarray(JServer._cb_step(
        SimpleNamespace(pipe=jpipe), jpipe.flux_params, *map(jnp.asarray, (lat, txt, y, ts, dts,
                                                                            gs)),
        j_compute_pe(jpipe.flux_cfg, j_txt_ids(1, t_len), j_img_ids(1, h2, h2))))
    with torch.no_grad():
        t_out = FluxServer._cb_step(
            SimpleNamespace(pipe=tp), tp.flux_params, *map(torch.from_numpy, (lat, txt, y, ts,
                                                                             dts, gs)),
            compute_pe(cfg, make_txt_ids(b, t_len, "cpu"), make_img_ids(b, h2, h2, "cpu")))
    err = summed_rel(to_np(t_out[:4]), j_out[:4])
    assert err <= 1e-5, err
    # the padding lane comes back exactly
    assert torch.equal(t_out[4], torch.from_numpy(lat[4]))
    np.testing.assert_array_equal(j_out[4], lat[4])


def test_server_matches_jax_server(served):
    bands = {}
    for (prompt, *_), got, want in zip(REQUESTS, served["port"], served["jax"]):
        assert got.shape == (64, 64, 3) and got.dtype == np.uint8
        bands[prompt] = _band(got, want)
        _assert_band(got, want, prompt)
    print(f"port server vs JAX server (u8 mean, max): {bands}")


def test_continuous_batching_matches_sequential(served):
    """Each lane equals the port's offline image for its seed; the lanes
    shared forwards (fewer forwards than lane steps)."""
    bands = {}
    for (prompt, _, _, i2i), got, want in zip(REQUESTS, served["port"], served["offline"]):
        if not i2i:
            bands[prompt] = _band(got, want)
            _assert_band(got, want, prompt)
    print(f"server vs offline (u8 mean, max): {bands}")
    s = served["stats"]
    assert s["lane_steps"] == 2 + 4 + 2 and s["forwards"] < s["lane_steps"]


def test_server_img2img_lane_matches_offline(served):
    got, want = served["port"][2], served["offline"][2]
    print(f"img2img lane vs offline (u8 mean, max): {_band(got, want)}")
    _assert_band(got, want, "img2img lane")


def test_server_queues_beyond_batch(tpipe):
    """More requests than lanes: the queue drains as lanes retire."""
    server = FluxServer(tpipe, max_batch=2)
    try:
        futs = [server.submit(f"req {i}", _params(2, 10 + i)) for i in range(5)]
        outs = [f.result(timeout=600) for f in futs]
    finally:
        server.shutdown()
    assert len(outs) == 5
    assert all(o.shape == (64, 64, 3) for o in outs)
    assert (outs[0] != outs[1]).any()  # different seeds


def test_server_mixed_resolutions_and_metrics(tpipe):
    """Mixed resolutions in one server (a lane group each), each image equal
    to its offline generation, and the counters add up."""
    server = FluxServer(tpipe, max_batch=4)
    p64, p96 = _params(2, 1), _params(3, 2, height=96)
    try:
        futs = [server.submit("a cat", p64), server.submit("a dog", p96),
                server.submit("a bird", p64)]
        outs = [f.result(timeout=600) for f in futs]
    finally:
        server.shutdown()
    assert outs[0].shape == (64, 64, 3) and outs[1].shape == (96, 64, 3)
    for prompt, gp, img in [("a cat", p64, outs[0]), ("a dog", p96, outs[1])]:
        _assert_band(img, tpipe.forward_arrays([prompt], gp)[0], prompt)
    s = server.stats()
    assert s["submitted"] == 3 and s["completed"] == 3 and s["failed"] == 0
    assert s["lane_steps"] == 7
    assert 0.0 < s["occupancy"] <= 1.0 and s["mean_latency_s"] > 0
    text = server.metrics_text()
    assert "# TYPE drs_server_completed_total counter" in text
    assert "drs_server_completed_total 3" in text
    assert "# TYPE drs_server_queue_depth gauge" in text


def test_server_bucket_padding_compiles_small_batches(tpipe):
    """A lone request runs in the 1-lane bucket, not padded to max_batch."""
    server = FluxServer(tpipe, max_batch=4)
    try:
        out = server.submit("solo", _params(2, 5)).result(timeout=600)
    finally:
        server.shutdown()
    assert out.shape == (64, 64, 3)
    s = server.stats()
    assert s["lane_steps"] == 2 and s["padded_lane_steps"] == 0


def _with_mesh(pipe, dp):
    meshed = copy.copy(pipe)
    meshed.mesh = SimpleNamespace(shape={"dp": dp, "sp": 1, "tp": 1})
    return meshed


def test_server_dp_mesh_sharded(tpipe):
    """A pipeline with a mesh is served, as the JAX server serves one: here
    a mesh of one rank (``make_mesh`` without a process group), so the
    server runs its command stream (admit, step, retire) with no followers.
    Each lane is within JAX's band of its offline image, and the three
    lanes step at bucket 4. The dp=2 x tp=2 and dp=2 x sp=2 worlds
    (followers, images against JAX's offline ones, failures) are in
    tests/test_torch_mesh.py."""
    from diffusion_rs_tpu_torch.parallel import make_mesh

    meshed = copy.copy(tpipe)
    meshed.mesh = make_mesh(device="cpu")
    server = FluxServer(meshed, max_batch=4, poll_ms=300.0)
    prompts = ["a cat", "a dog", "a fox"]
    try:
        futs = [server.submit(p, _params(2, 1 + i)) for i, p in enumerate(prompts)]
        outs = [f.result(timeout=600) for f in futs]
    finally:
        server.shutdown()
    assert server.leader
    for i, (p, img) in enumerate(zip(prompts, outs)):
        _assert_band(img, tpipe.forward_arrays([p], _params(2, 1 + i))[0], p)
    s = server.stats()
    assert (s["forwards"], s["lane_steps"], s["padded_lane_steps"]) == (2, 6, 2)


def test_server_rejects_indivisible_dp_batch(tpipe):
    with pytest.raises(ValueError, match="multiple of the mesh dp"):
        FluxServer(_with_mesh(tpipe, 2), max_batch=3)


def test_server_rejects_streamed_pipeline(tpipe):
    """Offloading.Stream has no resident transformer to batch (the JAX
    server fails every lane there: ROADMAP Queue 3 item 3)."""
    streamed = copy.copy(tpipe)
    streamed.streamed, streamed.flux_params = object(), None
    with pytest.raises(ValueError, match="Offloading.Stream"):
        FluxServer(streamed)


def test_http_server_generate_and_metrics(tpipe):
    """POST /generate returns a PNG (also for an img2img body with
    init_image_b64); /metrics and /healthz respond; concurrent requests
    batch; a body without a prompt answers 400."""
    server = FluxServer(tpipe, max_batch=4)
    httpd = serve_http(server, "127.0.0.1", 0, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def post(body):
            req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                assert r.headers["Content-Type"] == "image/png"
                return r.read()

        common = dict(height=64, width=64, num_steps=2, guidance_scale=3.5,
                      max_sequence_length=64)
        with ThreadPoolExecutor(2) as ex:
            pngs = list(ex.map(lambda s: post({"prompt": f"img {s}", "seed": s, **common}),
                               [1, 2]))
        assert all(p[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)
        assert pngs[0] != pngs[1]
        i2i = post({"prompt": "img 1", "seed": 1, **common, "strength": 0.5,
                    "init_image_b64": base64.b64encode(encode_png(_init_image())).decode()})
        assert i2i[:8] == b"\x89PNG\r\n\x1a\n" and i2i != pngs[0]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert "drs_server_completed_total 3" in r.read().decode()
        req = urllib.request.Request(base + "/generate", data=b"{}",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()


def test_server_request_timeout(tpipe):
    """A lane past request_timeout_s fails with TimeoutError; later requests
    still serve."""
    server = FluxServer(tpipe, max_batch=2, request_timeout_s=0.0)
    try:
        fut = server.submit("too slow", _params(50, 1))
        with pytest.raises(TimeoutError, match="exceeded"):
            fut.result(timeout=600)
        server.request_timeout_s = None
        assert server.submit("ok", _params(2, 2)).result(timeout=600).shape == (64, 64, 3)
    finally:
        server.shutdown()
    assert server.stats()["failed"] == 1


def test_server_backpressure_bound(tpipe):
    """Submits past max_queue raise ServerBusy before any encode work; the
    rejected counter ticks and earlier requests still complete."""
    server = FluxServer(tpipe, max_batch=1, poll_ms=200.0, max_queue=1)
    try:
        futs = [server.submit("a", _params(2, 1))]
        with pytest.raises(ServerBusy, match="queue full"):
            for _ in range(3):
                futs.append(server.submit("b", _params(2, 1)))
        for f in futs:
            assert f.result(timeout=600).shape == (64, 64, 3)
    finally:
        server.shutdown()
    assert server.stats()["rejected"] >= 1
    assert "drs_server_rejected_total" in server.metrics_text()


def test_server_stats_inflight_consistent(tpipe):
    """in_flight settles to 0 when idle."""
    server = FluxServer(tpipe, max_batch=2)
    try:
        assert server.submit("x", _params(2, 1)).result(timeout=600).shape == (64, 64, 3)
        for _ in range(100):
            if server.stats()["in_flight"] == 0:
                break
            time.sleep(0.05)
        assert server.stats()["in_flight"] == 0
    finally:
        server.shutdown()


def test_server_encode_cache(tpipe):
    """Repeat prompts skip the encode: the LRU serves (txt, y), the hit
    counter ticks, and the image is the uncached one's."""
    server = FluxServer(tpipe, max_batch=2, encode_cache=2)
    try:
        a1 = server.submit("same prompt", _params(2, 5)).result(timeout=600)
        assert server.stats()["encode_cache_hits"] == 0
        a2 = server.submit("same prompt", _params(2, 5)).result(timeout=600)
        assert server.stats()["encode_cache_hits"] == 1
        np.testing.assert_array_equal(a1, a2)
        server.submit("p2", _params(2, 6)).result(timeout=600)
        server.submit("p3", _params(2, 7)).result(timeout=600)
        server.submit("same prompt", _params(2, 5)).result(timeout=600)
        assert server.stats()["encode_cache_hits"] == 1  # evicted
        assert "drs_server_encode_cache_hits_total" in server.metrics_text()
    finally:
        server.shutdown()


def test_server_encode_stampede(tpipe, monkeypatch):
    """Four concurrent submits of one new prompt pay one encode; the
    duplicates wait on it and count as hits."""
    calls = []
    real = tpipe._encode

    def counting(*a, **kw):
        calls.append(1)
        time.sleep(0.05)  # widen the race window
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "_encode", counting)
    server = FluxServer(tpipe, max_batch=4, encode_cache=4)
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(lambda: server.submit("burst prompt", _params(2, 9))
                              .result(timeout=600)) for _ in range(4)]
            outs = [f.result(timeout=600) for f in futs]
        assert len(calls) == 1, f"{len(calls)} encodes for 4 identical submits"
        assert server.stats()["encode_cache_hits"] == 3
        for o in outs[1:]:
            assert np.abs(outs[0].astype(int) - o.astype(int)).max() <= 8
    finally:
        server.shutdown()


def test_server_encode_cache_disabled(tpipe):
    server = FluxServer(tpipe, max_batch=1, encode_cache=0)
    try:
        server.submit("q", _params(2, 1)).result(timeout=600)
        server.submit("q", _params(2, 1)).result(timeout=600)
        assert server.stats()["encode_cache_hits"] == 0
        assert not server._encode_lru
    finally:
        server.shutdown()


def test_worker_outputs_carry_no_graph(tpipe):
    """Grad mode is per thread: with transformer weights that require grad,
    the worker's latents still come back without an autograd graph."""
    graded = copy.copy(tpipe)
    graded.flux_params = tree_map(
        lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), tpipe.flux_params)
    server = FluxServer(graded, max_batch=2)
    seen = []
    retire = server._retire

    def record(ln):
        seen.append((ln.latent.requires_grad, ln.latent.grad_fn))
        retire(ln)

    server._retire = record
    try:
        futs = [server.submit("x", _params(2, 1)), server.submit("y", _params(3, 2))]
        assert all(f.result(timeout=600).shape == (64, 64, 3) for f in futs)
    finally:
        server.shutdown()
    assert seen == [(False, None), (False, None)]


# -- ops/_cuda.py under threads: no card needed (the build and the library
# are stand-ins) ----------------------------------------------------------


class _FakeLib:
    """A loaded library whose every entry point returns 0 (success)."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        def fn(*args):
            return 0

        setattr(self, name, fn)
        return fn


@pytest.fixture
def fresh_cuda(monkeypatch, tmp_path):
    """_cuda's process-global state, fresh and pointed at ``tmp_path``."""
    import ctypes

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "_FNS", {})
    monkeypatch.setattr(_cuda, "LAUNCHES", dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(ctypes, "CDLL", _FakeLib)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield monkeypatch
    finally:
        sys.setswitchinterval(switch)


def _run_threads(n, target):
    errors = []

    def body(i):
        try:
            target(i)
        except Exception as e:  # collected and asserted by the caller
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_cuda_library_builds_once_and_counts_exactly_under_threads(fresh_cuda):
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # every thread asks while the build runs
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in _cuda.SOURCES:
            _cuda._lib_path(name).write_bytes(b"")
        return {}

    fresh_cuda.setattr(_cuda, "build_all", slow_build)
    names = list(_cuda.KERNELS)
    n_threads, per_thread = 8, 400

    def launch_many(i):
        for j in range(per_thread):
            _cuda.call(names[(i + j) % len(names)], (), None)

    assert _run_threads(n_threads, launch_many) == []
    assert len(builds) == 1
    assert set(_cuda._LIBS) == set(_cuda.SOURCES)
    assert sum(_cuda.launch_counts().values()) == n_threads * per_thread
    want = dict.fromkeys(names, 0)
    for i in range(n_threads):
        for j in range(per_thread):
            want[names[(i + j) % len(names)]] += 1
    assert _cuda.launch_counts() == want


def test_cuda_failed_build_raises_on_every_thread(fresh_cuda):
    builds = []

    def failing_build():
        builds.append(1)
        time.sleep(0.05)
        raise RuntimeError("nvcc failed for qmm_s8")

    fresh_cuda.setattr(_cuda, "build_all", failing_build)
    errors = _run_threads(4, lambda i: _cuda.library("qmm_s8"))
    assert len(errors) == 4 and all("nvcc failed" in str(e) for e in errors)
    assert len(builds) == 4 and not _cuda._LIBS
