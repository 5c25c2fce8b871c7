"""The port's REST service and request batching.

A port ``SegmentationService(..., device="cpu")`` with batching on answers
``segment`` with the PNG mask of the JAX service for the same image and
checkpoint (class-map mismatch < 2e-2, the engine bound of
tests/test_torch_engine.py); the packed wire format round-trips; the
stdlib server serves the routes over localhost. The ``MicroBatcher``
cases are those of tests/test_batching.py, run on the port's copy.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_models import numpy_variables

from deadtrees_tpu.core import save_checkpoint as jax_save_checkpoint
from deadtrees_tpu.models import create_model as jax_create_model
from deadtrees_tpu.serve import SegmentationService as JaxSegmentationService
from deadtrees_tpu_torch.infer import unpack2
from deadtrees_tpu_torch.serve import SegmentationService, serve_stdlib
from deadtrees_tpu_torch.serve import server as tserver
from deadtrees_tpu_torch.serve.batching import MicroBatcher, bucket_size

HP = dict(
    architecture="efficientunet++",
    encoder_name="timm-efficientnet-b0",
    decoder_channels=[24, 16, 16, 8, 8],
    in_channels=4,
    classes=3,
)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jmodel = jax_create_model(**HP, dtype=jnp.float32)
    variables = numpy_variables(jmodel, 32, seed=21)
    path = tmp_path_factory.mktemp("serve") / "effunetpp_b0.ckpt"
    jax_save_checkpoint(
        path, params=variables["params"], batch_stats=variables["batch_stats"],
        hparams=HP,
    )
    return path


def _png(seed, size=32):
    img = np.random.default_rng(seed).integers(0, 255, (size, size, 4), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, "PNG")
    return buf.getvalue()


def _mask(png_bytes):
    return np.asarray(Image.open(io.BytesIO(png_bytes)))


def test_service_matches_jax_service(ckpt):
    upload = _png(1)
    want, want_headers = JaxSegmentationService(ckpt).segment(upload)
    service = SegmentationService(ckpt, batch_wait_ms=5, max_batch=4, device="cpu")
    try:
        engine = service.engines["torch"]
        assert engine.fused_decoder == "auto" and engine.device.type == "cpu"
        got, headers = service.segment(upload)
        assert service.batchers["torch"].dispatches == 1
        a, b = _mask(got), _mask(want)
        assert a.shape == b.shape == (32, 32)
        assert set(np.unique(a)) <= {0, 255, 254}  # class id × 255 as uint8
        assert (a != b).mean() < 2e-2
        assert headers["X-model-type"] == "torch"
        assert set(headers) == set(want_headers)

        body, headers = service.segment(upload, packed=True)
        h, w = map(int, headers["X-Packed-Shape"].split(","))
        classes = unpack2(np.frombuffer(body, np.uint8).reshape(h, -1), w)
        np.testing.assert_array_equal(classes.astype(np.uint8) * 255, a)
    finally:
        service.close()


def test_stdlib_server_routes(ckpt):
    service = SegmentationService(ckpt, batch_wait_ms=2, max_batch=4, device="cpu")
    server = serve_stdlib(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert b"DeadTrees" in urllib.request.urlopen(f"{base}/", timeout=30).read()
        results = [None] * 2

        def post(i):
            req = urllib.request.Request(
                f"{base}/segmentation", data=_png(10 + i), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                results[i] = (resp.status, resp.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for status, body in results:
            assert status == 200 and _mask(body).shape == (32, 32)

        req = urllib.request.Request(
            f"{base}/segmentation?model_type=jax", data=_png(3), method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400

        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "model_name": "bestmodel",
                          "models": ["torch"], "batching": True, "tta": 0}
        with urllib.request.urlopen(f"{base}/metrics?x=1", timeout=30) as resp:
            text = resp.read().decode()
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert 'deadtrees_requests_total{model_type="torch"} 2' in text
        assert "deadtrees_request_errors_total 1" in text
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)


def test_service_needs_cuda_unless_told(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentationService(ckpt)
    monkeypatch.setattr("sys.argv", ["server", "--checkpoint", str(ckpt)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.main()  # --device defaults to cuda


def test_service_unported_options_raise(ckpt, tmp_path):
    """Every option of the JAX service is ported: ``exported=`` loads its
    artifact (a missing file raises; tests/test_torch_export.py serves one)
    and ``tta`` serves the plain model over its views, as the JAX service
    does. With neither a checkpoint nor an artifact the service raises."""
    with pytest.raises(FileNotFoundError):
        SegmentationService(None, exported=tmp_path / "missing.ptexp", device="cpu")
    with pytest.raises(ValueError, match="checkpoint and/or exported"):
        SegmentationService(None, device="cpu")
    service = SegmentationService(ckpt, tta=4, device="cpu")
    engine = service.engines["torch"]
    assert engine.tta_views == 4 and not engine.fused_decoder
    assert service.health()["tta"] == 4
    got, headers = service.segment(_png(3))
    assert _mask(got).shape == (32, 32) and headers["X-model-type"] == "torch"


# --------------------------------------------------------------------------
# MicroBatcher (the cases of tests/test_batching.py)
# --------------------------------------------------------------------------


def test_bucket_size():
    assert [bucket_size(n, 32) for n in (1, 2, 3, 4, 5, 9, 31, 32, 40)] == [
        1, 2, 4, 4, 8, 16, 32, 32, 32,
    ]
    assert bucket_size(7, 4) == 4


def _recording_runner(record, delay=0.0):
    def run_batch(stacked):
        if delay:
            time.sleep(delay)
        record.append(stacked.shape[0])
        return stacked[:, :, :, 0]

    return run_batch


def _submit_wave(batcher, images, timeout=20.0):
    results = [None] * len(images)
    errors = [None] * len(images)

    def worker(i):
        try:
            results[i] = batcher.submit(images[i])
        except BaseException as e:  # noqa: BLE001 - test harness
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "submit() hung"
    return results, errors


@pytest.mark.parametrize(
    "shapes,max_batch,wait_ms,dispatched",
    [
        ([(8, 8, 4)] * 3, 3, 2000, [3]),  # coalesced, already at max_batch
        ([(4, 4, 1)] * 3, 8, 150, [4]),  # flushed by the window, padded to 4
        ([(8, 8, 4), (16, 16, 4), (8, 8, 4)], 8, 100, None),  # shapes never mix
    ],
    ids=["coalesces", "pads_to_power_of_two", "shape_groups_never_mix"],
)
def test_batcher_groups_requests(shapes, max_batch, wait_ms, dispatched):
    record = []
    batcher = MicroBatcher(_recording_runner(record), max_batch=max_batch,
                           max_wait_ms=wait_ms)
    try:
        images = [np.full(s, i, np.uint8) for i, s in enumerate(shapes)]
        results, errors = _submit_wave(batcher, images)
        assert errors == [None] * len(images)
        for img, out in zip(images, results):
            np.testing.assert_array_equal(out, img[:, :, 0])
        if dispatched is not None:
            assert record == dispatched
        else:
            assert batcher.dispatches == 2  # the (8, 8) pair + the (16, 16) one
        assert batcher.requests == len(images)
    finally:
        batcher.close()


def test_wave_larger_than_max_batch_splits():
    record = []
    batcher = MicroBatcher(_recording_runner(record, delay=0.05), max_batch=4,
                           max_wait_ms=100)
    try:
        images = [np.full((4, 4, 2), i, np.uint8) for i in range(6)]
        results, errors = _submit_wave(batcher, images)
        assert errors == [None] * 6
        for img, out in zip(images, results):
            np.testing.assert_array_equal(out, img[:, :, 0])
        assert sum(record) >= 6 and max(record) <= 4
        assert record[0] == 4
    finally:
        batcher.close()


def test_error_fans_out_and_serving_continues():
    calls = {"n": 0}

    def run_batch(stacked):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fell over")
        return stacked[:, :, :, 0]

    batcher = MicroBatcher(run_batch, max_batch=2, max_wait_ms=1000)
    try:
        _, errors = _submit_wave(batcher, [np.zeros((4, 4, 1), np.uint8)] * 2)
        assert all(isinstance(e, RuntimeError) for e in errors)
        out = batcher.submit(np.ones((4, 4, 1), np.uint8))
        np.testing.assert_array_equal(out, np.ones((4, 4)))
    finally:
        batcher.close()


def test_submit_after_close_raises():
    batcher = MicroBatcher(lambda b: b[:, :, :, 0], max_batch=2, max_wait_ms=1)
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(np.zeros((2, 2, 1), np.uint8))
