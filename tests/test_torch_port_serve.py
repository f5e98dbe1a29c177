"""The port's serving stack on the CPU: bucketing, the micro-batching
service, the wire format and the HTTP front.

Service masks must equal the lanes of ``Predictor.predict_batch`` (1e-5:
the bucket pads to another batch shape, so float32 reassociation only);
the wire format must be the JAX package's, byte for byte.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributedpytorch_tpu.serve import batching as jax_batching
from distributedpytorch_tpu.serve import client as jax_client
from distributedpytorch_tpu_torch.predict import Predictor
from distributedpytorch_tpu_torch.serve import batching
from distributedpytorch_tpu_torch.serve.__main__ import main, make_server
from distributedpytorch_tpu_torch.serve.client import (
    ServeClient,
    decode_array,
    encode_array,
)
from distributedpytorch_tpu_torch.serve.service import (
    DeadlineExceededError,
    InferenceService,
    QueueFullError,
    ServiceUnhealthyError,
)

IMAGE = np.random.default_rng(0).integers(0, 255, (80, 100, 3), np.uint8)
CLICKS = [np.array([[10.0, 40.0], [50.0, 8.0], [90.0, 40.0], [50.0, 70.0]]) + d
          for d in (0.0, 3.0, -4.0, 6.0, 1.0)]


@pytest.fixture(scope="module")
def predictor():
    return Predictor.fresh(64, "resnet18", seed=0, device="cpu", relax=10)


class TestBatchingMatchesJax:
    @pytest.mark.parametrize("max_batch", [1, 2, 8, 16])
    def test_bucket_sizes(self, max_batch):
        assert batching.bucket_sizes(max_batch) == \
            jax_batching.bucket_sizes(max_batch)

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
    def test_bucket_for(self, n):
        ladder = batching.bucket_sizes(8)
        assert batching.bucket_for(n, ladder) == jax_batching.bucket_for(n, ladder)

    def test_bad_ladders_raise(self):
        for bad in (0, 6):
            with pytest.raises(ValueError):
                batching.bucket_sizes(bad)
        with pytest.raises(ValueError):
            batching.bucket_for(9, (1, 2, 4, 8))

    def test_pad_and_unpad(self):
        stack = np.ones((3, 2, 2, 4), np.float32)
        padded = batching.pad_to_bucket(stack, 4)
        np.testing.assert_array_equal(padded, jax_batching.pad_to_bucket(stack, 4))
        assert padded[3].sum() == 0
        assert batching.unpad(padded, 3).shape[0] == 3
        with pytest.raises(ValueError):
            batching.pad_to_bucket(stack, 2)


class TestWire:
    @pytest.mark.parametrize("dtype", ["float32", "uint8", "float64"])
    def test_round_trip_with_jax_client(self, dtype):
        arr = (np.arange(24).reshape(2, 3, 4) * 3).astype(dtype)
        ours = encode_array(arr)
        assert ours == jax_client.encode_array(arr)
        np.testing.assert_array_equal(jax_client.decode_array(ours), arr)
        np.testing.assert_array_equal(decode_array(jax_client.encode_array(arr)), arr)

    def test_refuses_bad_payloads(self):
        with pytest.raises(ValueError):
            encode_array(np.zeros(2, np.complex64))
        bad = encode_array(np.zeros(4, np.float32))
        with pytest.raises(ValueError, match="refusing"):
            decode_array({**bad, "dtype": "object"})
        with pytest.raises(ValueError, match="byte count"):
            decode_array({**bad, "shape": [5]})


class TestService:
    def test_masks_equal_predict_batch_lanes(self, predictor):
        want = predictor.predict_batch(IMAGE, CLICKS)
        svc = InferenceService(predictor, max_batch=4, max_wait_s=0.05)
        futures = [svc.submit(IMAGE, c) for c in CLICKS]  # queued before start
        with svc:
            got = [f.result(timeout=60) for f in futures]
        for g, w in zip(got, want):
            assert g.shape == IMAGE.shape[:2]
            assert float(np.abs(g - w).max()) <= 1e-5
        stats = svc.metrics.snapshot()
        assert stats["counts"]["completed"] == len(CLICKS)
        assert stats["batches_by_bucket"] == {"1": 1, "4": 1}

    def test_concurrent_submits_all_resolve(self, predictor):
        svc = InferenceService(predictor, max_batch=4).start()
        try:
            results = [None] * 8

            def client(i):
                results[i] = svc.predict(IMAGE, CLICKS[i % len(CLICKS)],
                                         timeout=60)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
                assert not th.is_alive()
        finally:
            svc.stop()
        assert all(r is not None and np.isfinite(r).all() for r in results)

    def test_queue_full_sheds(self, predictor):
        svc = InferenceService(predictor, queue_depth=1)
        svc.submit(IMAGE, CLICKS[0])
        with pytest.raises(QueueFullError):
            svc.submit(IMAGE, CLICKS[1])
        assert svc.metrics.snapshot()["counts"]["shed_queue_full"] == 1
        svc.stop()

    def test_deadline_sheds_at_drain(self, predictor):
        svc = InferenceService(predictor)
        fut = svc.submit(IMAGE, CLICKS[0], deadline_s=0.0)
        with svc:
            with pytest.raises(DeadlineExceededError):
                fut.result(timeout=60)
        assert svc.metrics.snapshot()["counts"]["shed_deadline"] == 1

    def test_stop_fails_queued_and_refuses_new(self, predictor):
        svc = InferenceService(predictor)
        fut = svc.submit(IMAGE, CLICKS[0])
        svc.stop()
        with pytest.raises(ServiceUnhealthyError):
            fut.result(timeout=5)
        with pytest.raises(ServiceUnhealthyError):
            svc.submit(IMAGE, CLICKS[0])

    def test_bad_input_raises_before_queueing(self, predictor):
        svc = InferenceService(predictor)
        with pytest.raises(ValueError):
            svc.submit(IMAGE, CLICKS[0][:3])
        assert svc.health()["queue_depth"] == 0

    def test_health_and_warmup(self, predictor):
        svc = InferenceService(predictor, max_batch=2)
        assert svc.health()["ok"] is False
        warm = svc.warmup()
        assert [e["program"] for e in warm["programs"]] == ["forward_b1",
                                                            "forward_b2"]
        assert warm["aot_cache"] == "off" and warm["programs_compiled"] == 2
        with svc:
            health = svc.health()
            assert health["ok"] and health["state"] == "running"
            assert health["device"] == "cpu" and health["buckets"] == [1, 2]


class TestHttp:
    @pytest.fixture()
    def server(self, predictor):
        svc = InferenceService(predictor, max_batch=2).start()
        httpd = make_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        yield svc, f"http://127.0.0.1:{httpd.server_port}"
        httpd.shutdown()
        httpd.server_close()
        svc.stop()
        thread.join(timeout=30)

    def test_round_trip(self, server, predictor):
        svc, url = server
        mask = ServeClient(url).predict(IMAGE, CLICKS[0])
        want = predictor.predict(IMAGE, CLICKS[0])
        assert mask.shape == IMAGE.shape[:2]
        assert float(np.abs(mask - want).max()) <= 1e-5
        client = ServeClient(url)
        assert client.health()["ok"] is True
        assert client.stats()["counts"]["completed"] == 1

    def test_jax_client_talks_to_port_server(self, server):
        _, url = server
        mask = jax_client.ServeClient(url).predict(IMAGE, CLICKS[1])
        assert mask.shape == IMAGE.shape[:2]

    def test_error_codes(self, server):
        _, url = server
        with pytest.raises(ValueError):
            ServeClient(url).predict(IMAGE, CLICKS[0][:3])
        req = urllib.request.Request(url + "/v1/predict", data=b"not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "/nope", timeout=30)
        assert err.value.code == 404
        assert json.loads(err.value.read())["error"].startswith("no such path")

    def test_deadline_is_504(self, server):
        svc, url = server
        with pytest.raises(DeadlineExceededError):
            ServeClient(url).predict(IMAGE, CLICKS[0], deadline_s=0.0)


def test_cli_rejects_bad_fresh_init_spec():
    with pytest.raises(SystemExit):
        main(["--fresh-init", "64:resnet18", "--device", "cpu"])
