"""Port parity for serve/: the micro-batcher, the job queue and the HTTP
server run the reference's own scenarios against both packages' modules
with fake device callbacks (each case holds the port's copy to the
reference's behaviour); the metrics render the same text for the same
observations; `request_to_config` and `export_config_from_request` agree
with the reference's on a table of valid and invalid bodies, down to the
error type and message; `build_app` end to end on the tiny port pipeline
with gen_batch 2, the pixels it hands the MP4 writer equal
`frames_to_uint8` of `SeededPipeline.generate_videos` at the same seeds,
bit for bit (compared before the lossy encoder); `warmup_pipeline` raises
the reference's ValueError without an upscaler."""

import dataclasses
import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

PACKAGES = ("ltx_tpu", "ltx_tpu_torch")


@pytest.fixture(params=PACKAGES, ids=["reference", "port"])
def serve(request):
    """The package's serve modules: batcher, jobs, server, metrics."""
    mods = {m: importlib.import_module(f"{request.param}.serve.{m}")
            for m in ("batcher", "jobs", "server", "metrics")}
    return type("Serve", (), mods)


# ---------------------------------------------------------------------------
# MicroBatcher
# ---------------------------------------------------------------------------


def test_batcher_coalesces_concurrent_submissions(serve):
    sizes = []

    def run(batch):
        sizes.append(len(batch))
        time.sleep(0.02)
        return [p * 2 for p in batch]

    b = serve.batcher.MicroBatcher(run, max_batch=8, batch_window_s=0.25)
    futs = [b.submit(i) for i in range(6)]
    assert [f.result(timeout=10) for f in futs] == [0, 2, 4, 6, 8, 10]
    b.close()
    assert len(sizes) <= 2 and sum(sizes) == 6
    st = b.stats()
    assert st["requests_done"] == 6 and st["requests_failed"] == 0
    assert set(st) == {"pending", "batches_run", "requests_done", "requests_failed",
                       "recent_batch_sizes", "max_batch"}


def test_batcher_max_batch_and_groups(serve):
    sizes, batches = [], []

    def run(batch):
        sizes.append(len(batch))
        batches.append(list(batch))
        return [p["v"] for p in batch]

    b = serve.batcher.MicroBatcher(run, max_batch=3, batch_window_s=0.1,
                                   group_key=lambda p: p["k"])
    payloads = [{"k": "ab"[i % 2], "v": i} for i in range(9)]
    futs = b.submit_many(payloads)
    assert [f.result(timeout=10) for f in futs] == list(range(9))
    b.close()
    assert max(sizes) <= 3 and sum(sizes) == 9
    assert all(len({p["k"] for p in batch}) == 1 for batch in batches)
    with pytest.raises(ValueError, match="max_batch"):
        serve.batcher.MicroBatcher(run, max_batch=0)


def test_batcher_failures_stay_in_their_batch(serve):
    def run(batch):
        if any(p == "bad" for p in batch):
            raise RuntimeError("device OOM")
        return batch

    seen = []
    b = serve.batcher.MicroBatcher(run, max_batch=4, batch_window_s=0.05,
                                   group_key=lambda p: p,
                                   on_batch=lambda s, n, ok: seen.append((n, ok)))
    bad, good = b.submit("bad"), b.submit("good")
    with pytest.raises(RuntimeError, match="device OOM"):
        bad.result(timeout=10)
    assert good.result(timeout=10) == "good"
    b.close()
    assert sorted(seen) == [(1, False), (1, True)]
    st = b.stats()
    assert st["requests_failed"] == 1 and st["requests_done"] == 1
    short = serve.batcher.MicroBatcher(lambda batch: batch[:-1], batch_window_s=0.05)
    for f in short.submit_many([1, 2]):
        with pytest.raises(RuntimeError, match="results"):
            f.result(timeout=10)
    short.close()
    with pytest.raises(RuntimeError, match="closed"):
        short.submit(1)


# ---------------------------------------------------------------------------
# JobQueue
# ---------------------------------------------------------------------------


def test_jobqueue_lifecycle_failure_and_cancel(serve):
    release, started = threading.Event(), threading.Event()

    def run(job):
        if job.request.get("boom"):
            raise ValueError("bad request payload")
        if job.request.get("hold"):
            started.set()
            release.wait(10)
        return {"echo": job.request["x"]}

    finished = []
    q = serve.jobs.JobQueue(run, on_job=lambda k, s, t: finished.append((k, s)))
    ok = q.submit("t2v", {"x": 7})
    bad = q.submit("i2v", {"x": 0, "boom": True})
    d_ok, d_bad = q.wait(ok, timeout=10), q.wait(bad, timeout=10)
    assert d_ok["state"] == "done" and d_ok["result"] == {"echo": 7}
    assert d_ok["submitted_at"] <= d_ok["started_at"] <= d_ok["finished_at"]
    assert d_bad["state"] == "failed" and "bad request payload" in d_bad["error"]
    assert [j["job_id"] for j in q.list_jobs()] == [bad, ok]
    first = q.submit("t2v", {"x": 1, "hold": True})
    assert started.wait(10)
    second = q.submit("t2v", {"x": 2})
    assert q.cancel(second) is True and q.cancel(first) is False
    release.set()
    assert q.wait(first, timeout=10)["state"] == "done"
    q.close()
    assert q.get(second)["state"] == "cancelled" and q.get("nope") is None
    assert q.stats() == {"jobs": {"done": 2, "failed": 1, "cancelled": 1}, "queued": 0}
    assert finished == [("t2v", "done"), ("i2v", "failed"), ("t2v", "done")]


def test_jobqueue_shares_the_device_lock_with_the_batcher(serve):
    lock, active = threading.Lock(), []

    def enter(tag):
        active.append(tag)
        assert len(active) == 1, f"device overlap: {active}"
        time.sleep(0.005)
        active.remove(tag)

    b = serve.batcher.MicroBatcher(lambda batch: (enter("enhance"), batch)[1],
                                   max_batch=4, batch_window_s=0, device_lock=lock)
    q = serve.jobs.JobQueue(lambda job: (enter("job"), {})[1], device_lock=lock)
    futs = b.submit_many(list(range(4)))
    ids = [q.submit("t2v", {}) for _ in range(4)]
    for f in futs:
        f.result(timeout=10)
    assert all(q.wait(i, timeout=10)["state"] == "done" for i in ids)
    b.close()
    q.close()


def test_jobqueue_coalesces_same_key_and_isolates_failures(serve):
    calls, gate = [], {"open": False}

    def run_one(job):
        while job.request.get("gate") and not gate["open"]:
            time.sleep(0.005)
        calls.append(("one", [job.request["p"]]))
        return {"v": job.request["p"]}

    def run_batch(batch):
        ps = [j.request["p"] for j in batch]
        if "boom" in ps:
            raise RuntimeError("boom")
        calls.append(("batch", ps))
        return [{"v": p} for p in ps]

    q = serve.jobs.JobQueue(run_one, run_batch=run_batch, max_batch=3,
                            batch_key=lambda j: j.request.get("k"))
    try:
        ids = [q.submit("t2v", {"p": "hold", "gate": True})]
        ids += [q.submit("t2v", {"p": f"a{i}", "k": "A"}) for i in range(4)]
        ids.append(q.submit("t2v", {"p": "b0", "k": "B"}))
        ids += [q.submit("t2v", {"p": p, "k": "C"}) for p in ("boom", "c1")]
        ids.append(q.submit("t2v", {"p": "d"}))
        gate["open"] = True
        recs = [q.wait(i, timeout=30) for i in ids]
    finally:
        q.close()
    assert [r["state"] for r in recs] == ["done"] * 6 + ["failed"] * 2 + ["done"]
    assert [r["result"]["v"] for r in recs[:6]] == ["hold", "a0", "a1", "a2", "a3", "b0"]
    assert "boom" in recs[6]["error"] and "boom" in recs[7]["error"]
    assert ("batch", ["a0", "a1", "a2"]) in calls
    assert ("one", ["a3"]) in calls and ("one", ["b0"]) in calls


# ---------------------------------------------------------------------------
# HTTP server (fake device callables)
# ---------------------------------------------------------------------------


@pytest.fixture()
def http_app(serve):
    batcher = serve.batcher.MicroBatcher(
        lambda batch: [p["prompt"].upper() for p in batch], max_batch=4,
        batch_window_s=0.05, group_key=serve.server.enhance_group_key, name="enhance")

    def run_job(job):
        if job.request.get("boom"):
            raise RuntimeError("synthetic failure")
        return {"output": f"out/{job.job_id}.mp4"}

    jobs = serve.jobs.JobQueue(run_job)
    metrics = serve.metrics.ServeMetrics()
    srv = serve.server.make_server(
        jobs, batcher=batcher, info_fn=lambda: {"model": "tiny"},
        validate_fn=lambda body: body.get("invalid") and "synthetic validation error",
        port=0, metrics=metrics)
    serve.server.serve_forever_threaded(srv)
    yield "http://%s:%d" % srv.server_address[:2], serve, metrics
    srv.shutdown()
    srv.server_close()
    batcher.close()
    jobs.close()


def _call(url, obj=None, raw=None, method=None):
    data = raw if raw is not None else (None if obj is None else json.dumps(obj).encode())
    req = urllib.request.Request(url, data=data, method=method or ("GET" if data is None
                                                                   else "POST"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read()
            return r.status, json.loads(body) if r.headers["Content-Type"] == \
                "application/json" else body.decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(base, jid):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        code, job = _call(f"{base}/v1/jobs/{jid}")
        assert code == 200
        if job["state"] not in ("pending", "running"):
            return job
        time.sleep(0.01)
    raise AssertionError(f"job {jid} did not finish")


def test_http_routes_and_status_codes(http_app):
    base, serve, metrics = http_app
    assert _call(base + "/healthz") == (200, {"status": "ok"})
    assert _call(base + "/v1/models") == (200, {"model": "tiny"})
    code, stats = _call(base + "/v1/stats")
    assert code == 200 and set(stats) == {"enhance", "jobs"}
    assert _call(base + "/nope")[0] == 404
    assert _call(base + "/v1/enhance", {"prompts": ["a cat", "a dog"]}) == \
        (200, {"prompts": ["A CAT", "A DOG"]})
    ok = {"prompts": ["a"]}
    for bad in ({"prompts": []}, {"prompts": [3]}, {**ok, "max_tokens": "512"},
                {**ok, "max_tokens": 0}, {**ok, "temperature": -1}, {**ok, "seed": -1},
                {**ok, "i2v": "yes"},
                {"prompts": ["p"] * (serve.server.MAX_PROMPTS_PER_REQUEST + 1)}):
        assert _call(base + "/v1/enhance", bad)[0] == 400, bad
    assert _call(base + "/v1/enhance", raw=b"{nope")[0] == 400
    assert _call(base + "/v1/enhance", raw=b"[1,2]")[0] == 400
    assert _call(base + "/v1/generate", {})[0] == 400
    assert _call(base + "/v1/generate", {"prompt": "x", "kind": "zzz"})[0] == 400
    code, out = _call(base + "/v1/generate", {"prompt": "x", "invalid": True})
    assert code == 400 and "synthetic validation error" in out["error"]

    code, out = _call(base + "/v1/generate", {"prompt": "hello"})
    assert code == 202
    job = _wait(base, out["job_id"])
    assert job["state"] == "done" and job["result"]["output"].endswith(".mp4")
    _, out2 = _call(base + "/v1/generate", {"prompt": "x", "boom": True})
    job2 = _wait(base, out2["job_id"])
    assert job2["state"] == "failed" and "synthetic failure" in job2["error"]
    code, lst = _call(base + "/v1/jobs")
    assert {j["job_id"] for j in lst["jobs"]} >= {job["job_id"], job2["job_id"]}
    assert _call(base + "/v1/jobs/zzz")[0] == 404
    assert _call(f"{base}/v1/jobs/{job['job_id']}", method="DELETE")[0] == 409
    code, text = _call(base + "/metrics")
    assert code == 200
    assert 'ltx_http_requests_total{route="/v1/generate",method="POST",code="202"} 2' in text
    assert 'ltx_http_requests_total{route="/v1/jobs/{id}",method="GET",code="404"}' in text
    assert "ltx_jobs_queued 0" in text and "ltx_enhance_pending 0" in text


def test_http_concurrent_enhance_coalesces(http_app):
    base = http_app[0]
    results = {}

    def call(name):
        results[name] = _call(base + "/v1/enhance", {"prompts": [name]})

    threads = [threading.Thread(target=call, args=(n,)) for n in ("alpha", "beta", "gamma")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in ("alpha", "beta", "gamma"):
        assert results[n] == (200, {"prompts": [n.upper()]})
    sizes = _call(base + "/v1/stats")[1]["enhance"]["recent_batch_sizes"]
    assert sum(sizes) == 3 and len(sizes) <= 2


def test_metrics_render_the_reference_text():
    import math

    from ltx_tpu.serve import metrics as jm
    from ltx_tpu_torch.serve import metrics as pm

    def observe(m):
        sm = m.ServeMetrics()
        sm.http_requests_total.inc(route="/v1/generate", method="POST", code="202")
        sm.http_requests_total.inc(2, route='we"ird\\route\n', method="GET", code="200")
        for v in (0.001, 0.3, 7.0, 1e4):
            sm.http_request_seconds.observe(v, route="/healthz")
        sm.on_batch(1.5, 3, True)
        sm.on_batch(0.2, 1, False)
        sm.on_job("t2v", "done", 12.25)
        sm.gauge("ltx_jobs_queued", "Generation jobs waiting", lambda: 3)
        sm.gauge("ltx_broken", "a gauge that raises", lambda: 1 / 0)
        return sm

    got, want = observe(pm), observe(jm)
    assert got.registry.render() == want.registry.render()
    assert got.job_seconds.summary(kind="t2v", state="done") == (1, 12.25)
    assert pm.LATENCY_BUCKETS == jm.LATENCY_BUCKETS and pm.LATENCY_BUCKETS[-1] == math.inf


# ---------------------------------------------------------------------------
# Request validation against the reference's
# ---------------------------------------------------------------------------

BODIES = {
    "t2v_defaults": {"prompt": "x"},
    "t2v_fields": {"prompt": "x", "width": 768, "height": 512, "num_frames": 25,
                   "num_steps": 8, "seed": 7, "cfg_scale": 3.0, "stg_scale": 1.0,
                   "stg_blocks": [28, 29], "negative_prompt": "blur", "fps": 30.0,
                   "ignored_field": 1},
    "two_stage": {"prompt": "x", "kind": "two_stage", "width": 128, "height": 128,
                  "num_frames": 9},
    "audio_two_stage": {"prompt": "x", "kind": "audio_two_stage", "width": 128,
                        "height": 128, "num_frames": 9},
    "two_stage_odd_size": {"prompt": "x", "kind": "two_stage", "width": 96},
    "width_65": {"prompt": "x", "width": 65},
    "frames_10": {"prompt": "x", "num_frames": 10},
    "cfg_30": {"prompt": "x", "cfg_scale": 30.0},
    "i2v_no_image": {"prompt": "x", "kind": "i2v"},
    "i2v": {"prompt": "x", "kind": "i2v", "image_path": "/anywhere/i.png"},
    "v2v_no_video": {"prompt": "x", "kind": "v2v"},
    "v2v_strength": {"prompt": "x", "kind": "v2v", "video_path": "a.mp4", "strength": 1.5},
    "v2v": {"prompt": "x", "kind": "v2v", "video_path": "a.mp4", "strength": 0.4},
    "extend_cond_8": {"prompt": "x", "kind": "extend", "video_path": "a.mp4",
                      "cond_frames": 8},
    "extend_cond_whole": {"prompt": "x", "kind": "extend", "video_path": "a.mp4",
                          "cond_frames": 25, "num_frames": 25},
    "chain_segments": {"prompt": "x", "kind": "chain", "segments": 1},
    "chain_prompts": {"prompt": "x", "kind": "chain", "segments": 2, "prompts": ["a"]},
    "chain_renorm": {"prompt": "x", "kind": "chain", "tail_renorm": 2.0},
    "chain_audio_cond": {"prompt": "x", "kind": "chain", "audio_cond": True},
    "chain_anchor_segment": {"prompt": "x", "kind": "chain", "segments": 2,
                             "anchors": {"2": [{"frame": 16, "image_path": "a.png"}]}},
    "chain_anchor_tail": {"prompt": "x", "kind": "chain", "segments": 2,
                          "anchors": {"1": [{"frame": 0, "image_path": "a.png"}]}},
    "chain_anchor_key": {"prompt": "x", "kind": "chain", "anchors": {"a": []}},
    "chain": {"prompt": "x", "kind": "chain", "segments": 3, "prompts": ["a", "b", "c"],
              "anchors": {"1": [{"frame": 16, "image_path": "a.png"}]}},
    "keyframes_empty": {"prompt": "x", "kind": "keyframes", "keyframes": []},
    "keyframes_unaligned": {"prompt": "x", "kind": "keyframes",
                            "keyframes": [{"frame": 3, "image_path": "a.png"}]},
    "keyframes_outside": {"prompt": "x", "kind": "keyframes", "num_frames": 25,
                          "keyframes": [{"frame": 32, "image_path": "a.png"}]},
    "keyframes_duplicate": {"prompt": "x", "kind": "keyframes",
                            "keyframes": [{"frame": 8, "image_path": "a.png"},
                                          {"frame": 8, "image_path": "b.png"}]},
    "keyframes_no_path": {"prompt": "x", "kind": "keyframes", "keyframes": [{"frame": 0}]},
    "keyframes": {"prompt": "x", "kind": "keyframes",
                  "keyframes": [{"frame": 0, "image_path": "a.png"},
                                {"frame": 16, "image_path": "b.png"}]},
    "codec_vp9": {"prompt": "x", "codec": "vp9"},
    "quality_2": {"prompt": "x", "export_quality": 2.0},
    "hevc": {"prompt": "x", "codec": "hevc", "export_quality": 0.95},
}


def _outcome(pkg, body, image_root=None):
    """("ok", config fields, export fields) or ("error", type name, message)."""
    app = importlib.import_module(f"{pkg}.serve.app")
    try:
        cfg = app.request_to_config(body, image_root=image_root)
        exp = app.export_config_from_request(body, cfg.fps)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("error", type(e).__name__, str(e))
    return ("ok", dataclasses.asdict(cfg),
            (exp.fps, exp.codec, exp.quality, exp.pixel_format))


@pytest.mark.parametrize("name", BODIES)
def test_request_validation_matches_reference(name):
    want = _outcome("ltx_tpu", BODIES[name])
    got = _outcome("ltx_tpu_torch", BODIES[name])
    if want[0] == "ok":
        assert got[0] == "ok" and got[2] == want[2]
        assert {k: got[1][k] for k in want[1]} == want[1]
    else:
        assert got == want


def test_image_root_fence_matches_reference(tmp_path):
    root = tmp_path / "images"
    root.mkdir()
    for path in ("ok.png", "/etc/hostname", "../outside.png", str(tmp_path / "o.png")):
        for body in ({"prompt": "x", "kind": "i2v", "image_path": path},
                     {"prompt": "x", "kind": "v2v", "video_path": path},
                     {"prompt": "x", "kind": "keyframes",
                      "keyframes": [{"frame": 0, "image_path": path}]}):
            assert _outcome("ltx_tpu_torch", body, root) == _outcome("ltx_tpu", body, root)


# ---------------------------------------------------------------------------
# build_app on the tiny port pipeline
# ---------------------------------------------------------------------------


def test_build_app_serves_seeded_batches(tmp_path):
    """gen_batch 2: two same-config T2V jobs coalesce into one batched
    denoise; each MP4 decodes to 9 frames, and the pixels handed to the
    writer are frames_to_uint8 of SeededPipeline.generate_videos at the
    jobs' seeds, bit for bit. The tiny pipeline has no tokenizer: the
    enhancement route answers 503."""
    import cv2

    from ltx_tpu_torch.checks import recorded_mp4
    from ltx_tpu_torch.config import GenerationConfig, MemoryConfig
    from ltx_tpu_torch.io.video import frames_to_uint8
    from ltx_tpu_torch.pipeline.generate import LTXPipeline
    from ltx_tpu_torch.pipeline.seeded import SeededPipeline
    from ltx_tpu_torch.serve.app import build_app
    from ltx_tpu_torch.serve.server import serve_forever_threaded

    pipe = LTXPipeline.random_tiny(device="cpu", seed=0,
                                   memory=MemoryConfig(offload_text_encoder=False))
    bodies = [{"prompt": p, "width": 64, "height": 64, "num_frames": 9, "seed": s}
              for p, s in (("a cat plays piano", 7), ("a dog sings", 11))]
    with recorded_mp4() as written:
        app = build_app(pipe, output_dir=str(tmp_path), port=0, gen_batch=2)
        serve_forever_threaded(app.server)
        base = "http://%s:%d" % app.server.server_address[:2]
        try:
            assert _call(base + "/v1/enhance", {"prompts": ["x"]})[0] == 503
            code, out = _call(base + "/v1/generate", {"prompt": "x", "width": 65})
            assert code == 400 and "divisible by 32" in out["error"]
            with app.device_lock:  # both jobs queue before the worker runs one
                ids = [_call(base + "/v1/generate", b)[1]["job_id"] for b in bodies]
            jobs = [app.jobs.wait(i, timeout=300) for i in ids]
        finally:
            app.close()
    assert [j["state"] for j in jobs] == ["done", "done"], [j.get("error") for j in jobs]
    config = GenerationConfig(width=64, height=64, num_frames=9)
    want = SeededPipeline(pipe).generate_videos([b["prompt"] for b in bodies], config,
                                                seeds=[7, 11])
    for job, w, body in zip(jobs, want, bodies):
        rec = job["result"]
        assert (rec["frames"], rec["width"], rec["height"], rec["seed"]) == \
            (9, 64, 64, body["seed"])
        np.testing.assert_array_equal(written[rec["output"]], frames_to_uint8(w.frames))
        cap = cv2.VideoCapture(rec["output"])
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
        cap.release()
    assert not np.array_equal(written[jobs[0]["result"]["output"]],
                              written[jobs[1]["result"]["output"]])


def test_warmup_without_upscaler_raises_as_the_reference():
    from ltx_tpu.serve.app import warmup_pipeline as jwarm
    from ltx_tpu_torch.serve.app import warmup_pipeline as pwarm

    class NoUpscaler:
        upscaler_params = None
        upscaler = None

    with pytest.raises(ValueError) as want:
        jwarm(NoUpscaler(), [(128, 128, 9, "two_stage")])

    from ltx_tpu_torch.pipeline.generate import LTXPipeline

    pipe = LTXPipeline.random_tiny(device="cpu", seed=0)
    pipe.upscaler = None
    with pytest.raises(ValueError) as got:
        pwarm(pipe, [(128, 128, 9, "two_stage")])
    assert str(got.value) == str(want.value)
