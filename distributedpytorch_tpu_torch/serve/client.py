"""The serve wire format and a minimal client.

Arrays travel as ``{"shape": [...], "dtype": "...", "b64": <base64 of the
raw C-order bytes>}`` — the JAX package's wire format
(``distributedpytorch_tpu/serve/client.py``), so either package's client
talks to either package's server.  No pickle: the dtype set is closed.

:class:`ServeClient` posts to a running HTTP front and maps its status codes
back to the service's exceptions (429 -> :class:`QueueFullError`, or
:class:`SessionLaneFullError` when the body's ``code`` is
``session_lane``; 504 -> :class:`DeadlineExceededError`, 503 ->
:class:`ServiceUnhealthyError`, 400 -> ``ValueError``).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Any

import numpy as np

from .service import (
    DeadlineExceededError,
    QueueFullError,
    ServiceUnhealthyError,
    SessionLaneFullError,
)

#: dtypes the wire accepts — a closed set, so a payload cannot name an
#: object dtype
_WIRE_DTYPES = ("uint8", "float32", "float64", "int32", "int64", "bool")

_STATUS_ERRORS = {
    429: QueueFullError,
    504: DeadlineExceededError,
    503: ServiceUnhealthyError,
    400: ValueError,
}

#: an error body's ``code`` -> the exception, refining the status: both
#: sheds are 429, but a session-lane shed means only that session should
#: back off
_CODE_ERRORS = {"session_lane": SessionLaneFullError}


def encode_array(arr: np.ndarray) -> dict:
    """numpy array -> JSON-safe {shape, dtype, b64(raw C-order bytes)}."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _WIRE_DTYPES:
        raise ValueError(f"dtype {arr.dtype.name} not wire-encodable "
                         f"({'|'.join(_WIRE_DTYPES)})")
    return {"shape": list(arr.shape), "dtype": arr.dtype.name,
            "b64": base64.b64encode(arr.tobytes()).decode("ascii")}


def decode_array(obj: dict) -> np.ndarray:
    """Inverse of :func:`encode_array`, validating dtype and byte count."""
    dtype = str(obj["dtype"])
    if dtype not in _WIRE_DTYPES:
        raise ValueError(f"refusing wire dtype {dtype!r}")
    shape = tuple(int(d) for d in obj["shape"])
    raw = base64.b64decode(obj["b64"])
    expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if len(raw) != expected:
        raise ValueError(
            f"wire array byte count {len(raw)} != shape/dtype "
            f"implied {expected}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


class ServeClient:
    """Client of ``python -m distributedpytorch_tpu_torch.serve``.

    >>> client = ServeClient("http://127.0.0.1:8801")
    >>> mask = client.predict(image, points)           # (H, W) float32
    >>> mask = client.predict(image, points, session_id="u1")  # a session
    """

    def __init__(self, url: str, timeout_s: float = 60.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def predict(self, image: np.ndarray, points: Any,
                deadline_s: float | None = None,
                session_id: str | None = None) -> np.ndarray:
        """One mask; ``session_id`` makes the click part of a session (a
        split predictor's server only), absent it is stateless."""
        body: dict = {"image": encode_array(np.asarray(image)),
                      "points": np.asarray(points, np.float64).tolist()}
        if deadline_s is not None:
            body["deadline_ms"] = deadline_s * 1e3
        if session_id is not None:
            body["session_id"] = str(session_id)
        data = json.dumps(body).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/v1/predict", data=data, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                reply = json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                reply = json.loads(e.read().decode("utf-8"))
            except ValueError:
                reply = {}
            detail = reply.get("error", "")
            exc = _CODE_ERRORS.get(reply.get("code")) or \
                _STATUS_ERRORS.get(e.code)
            if exc is None:
                raise RuntimeError(f"serve endpoint returned HTTP {e.code}: "
                                   f"{detail}") from e
            raise exc(detail or f"HTTP {e.code}") from None
        return decode_array(reply["mask"])

    def health(self) -> dict:
        """``GET /healthz``; an unhealthy 503 body is returned, not raised."""
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/stats")

    def _get(self, path: str) -> dict:
        try:
            with urllib.request.urlopen(self.url + path,
                                        timeout=self.timeout_s) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            return json.loads(e.read().decode("utf-8"))
