"""Typed cloud REST client.

Counterpart of `spacedrive_tpu/cloud/api.py` (ref:crates/cloud-api/src/lib.rs
— `library::{create,get}` (:120,203), `library::instances` (:359),
`sync::messageCollections::{request_add(push), get}` (:448,485)) against
the relay's REST surface. One `utils.http.HttpClient` per client where
JAX keeps one aiohttp session; all methods raise `CloudApiError` on
non-2xx like the reference's `Result<_, rspc::Error>` surface.

Every request rides the shared relay resilience policy: bounded
decorrelated-jitter retries on network failures and 5xx, a per-origin
circuit breaker (a dead relay costs one fast ``BreakerOpen`` per
cycle, not a timeout ladder), and ambient-deadline clipping. A 4xx is
the CLIENT's error — it neither retries nor feeds the breaker. A
mid-body EOF (a ``ClientError`` while reading the response) trips the
breaker like any transport failure: a relay that truncates bodies is
as dead as one that refuses connections.
"""

from __future__ import annotations

import json as _json
from typing import Any

from ..telemetry import tenants as _tenants
from ..telemetry import trace as _trace
from ..utils import http
from ..utils.resilience import (
    PASS,
    RETRY,
    ResiliencePolicy,
    RetryPolicy,
)
from .relay import INSTANCE_HEADER, TRACE_HEADER, b64, unb64


class CloudApiError(Exception):
    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status  # None = transport-level failure


def _relay_classify(exc: BaseException) -> str:
    if isinstance(exc, CloudApiError) and exc.status is not None \
            and exc.status < 500:
        return PASS  # the relay answered; the request was bad — ours
    return RETRY


RELAY_POLICY = ResiliencePolicy(
    "relay",
    RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=2.0,
                attempt_timeout=30.0),
    failure_threshold=5,
    reset_timeout=30.0,
    classify=_relay_classify,
)


class CloudClient:
    def __init__(self, api_origin: str):
        self.origin = api_origin.rstrip("/")
        self._session: http.HttpClient | None = None

    async def _request(
        self, method: str, path: str, json: Any = None,
        headers: dict[str, str] | None = None,
    ) -> Any:
        return await RELAY_POLICY.call(
            self.origin,
            lambda: self._request_once(method, path, json, headers),
        )

    async def _request_once(
        self, method: str, path: str, json: Any = None,
        headers: dict[str, str] | None = None,
    ) -> Any:
        if self._session is None:
            self._session = http.HttpClient()
        # trace context rides an HTTP header so relay-side spans join
        # the pushing/pulling node's trace
        wire = _trace.wire_current()
        if wire:
            headers = {**(headers or {}), TRACE_HEADER: _json.dumps(wire)}
        try:
            # the body is read whole before the status is looked at: a
            # mid-stream EOF is a transport failure (status=None), so it
            # retries AND feeds the per-origin breaker
            resp = await self._session.request(
                method, f"{self.origin}{path}", json=json, headers=headers
            )
            if resp.status >= 400:
                raise CloudApiError(
                    f"{method} {path} -> {resp.status}: {resp.text()}",
                    status=resp.status,
                )
            return resp.json()
        except http.ClientError as e:
            raise CloudApiError(f"{method} {path} failed: {e}") from e

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    # --- libraries (ref:lib.rs:120,203) --------------------------------

    async def create_library(self, library_uuid: str, name: str) -> Any:
        return await self._request(
            "POST", "/api/libraries", {"uuid": library_uuid, "name": name}
        )

    async def get_library(self, library_uuid: str) -> Any:
        return await self._request("GET", f"/api/libraries/{library_uuid}")

    # --- instances (ref:lib.rs:359) ------------------------------------

    async def add_instance(
        self, library_uuid: str, instance_uuid: str, identity: str = "",
        node_name: str = "",
    ) -> Any:
        return await self._request(
            "POST",
            f"/api/libraries/{library_uuid}/instances",
            {"uuid": instance_uuid, "identity": identity, "node_name": node_name},
        )

    async def list_instances(self, library_uuid: str) -> list[Any]:
        return await self._request(
            "GET", f"/api/libraries/{library_uuid}/instances"
        )

    # --- message collections (ref:lib.rs:448,485) ----------------------

    async def push_ops(
        self, library_uuid: str, instance_uuid: str, packed_ops: bytes
    ) -> int:
        out = await self._request(
            "POST",
            f"/api/libraries/{library_uuid}/messageCollections",
            {"instance_uuid": instance_uuid, "contents": b64(packed_ops)},
        )
        # node-side mirror of the relay's accounting: which of OUR
        # libraries spends the relay link, in raw payload bytes
        _tenants.observe_bytes(library_uuid, len(packed_ops),
                               outbound=True)
        return out["id"]

    async def pull_ops(
        self,
        library_uuid: str,
        instance_uuid: str,
        cursors: dict[str, int],
        count: int = 100,
    ) -> list[dict[str, Any]]:
        out = await self._request(
            "POST",
            f"/api/libraries/{library_uuid}/messageCollections/get",
            {"instance_uuid": instance_uuid, "cursors": cursors, "count": count},
        )
        for c in out:
            c["contents"] = unb64(c["contents"])
        _tenants.observe_bytes(
            library_uuid, sum(len(c["contents"]) for c in out),
            outbound=False)
        return out

    # --- telemetry federation fallback (telemetry/federation.py) -------

    async def push_telemetry(
        self, library_uuid: str, instance_uuid: str, snapshot: dict[str, Any]
    ) -> Any:
        return await self._request(
            "POST",
            f"/api/libraries/{library_uuid}/telemetry",
            {"instance_uuid": instance_uuid, "snapshot": snapshot},
            headers={INSTANCE_HEADER: instance_uuid},
        )

    async def pull_telemetry(
        self, library_uuid: str, instance_uuid: str
    ) -> list[dict[str, Any]]:
        return await self._request(
            "POST",
            f"/api/libraries/{library_uuid}/telemetry/get",
            {"instance_uuid": instance_uuid},
            headers={INSTANCE_HEADER: instance_uuid},
        )
