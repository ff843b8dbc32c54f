"""Debug bundle — one redacted JSON artifact for support/diagnosis.

An owned copy of `spacedrive_tpu/telemetry/bundle.py`. Everything a
"my index pass stalled" report needs, collected from the live process:
node config (secrets stripped), metrics snapshot, recent spans + the
trace ring summary, every flight-recorder ring, the host profile, and
versions/env. Produced by the ``telemetry.debug_bundle`` rspc procedure
and ``python -m spacedrive_tpu_torch debug-bundle``.

Redaction is two layered passes, both applied before the bundle leaves
the process:

1. key-name based and recursive — any mapping key containing a
   secret-ish token (``identity``, ``key``, ``secret``, ``password``,
   ``token``, ``master``, …) has its value replaced. Applied to the
   node config, env, AND the event rings' fields.
2. value based — every string that was redacted by key in the config
   or the environment (the node identity hex, planted API tokens, …)
   is additionally scrubbed out of every string in the whole bundle,
   because secrets travel: an exception message or traceback captured
   by the error ring may embed the very value the config redaction hid.

Where the JAX bundle lists ``jax`` and ``jaxlib``, this one lists
``torch`` and the CUDA version torch was built with. The per-tenant
plane is not ported yet: ``tenants`` is what the JAX plane returns with
no tenant recorded.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any

REDACTED = "[redacted]"

# substrings that mark a mapping key as secret-bearing
SECRET_KEY_TOKENS = (
    "identity", "key", "secret", "password", "token", "master",
    "credential", "private",
)

# env vars worth shipping; everything else stays home (env is a classic
# secret-leak vector: SD_CLOUD_TOKEN=… must never ride a bundle)
ENV_PREFIXES = ("SD_", "TORCH_", "PYTORCH_", "CUDA_")


def _key_is_secret(key: str) -> bool:
    low = key.lower()
    return any(tok in low for tok in SECRET_KEY_TOKENS)


def redact(obj: Any) -> Any:
    """Deep-copy ``obj`` with secret-keyed values replaced. Lists and
    tuples recurse; scalar leaves pass through untouched."""
    if isinstance(obj, dict):
        return {
            k: (REDACTED if _key_is_secret(str(k)) else redact(v))
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [redact(v) for v in obj]
    return obj


MIN_SECRET_LEN = 8  # don't value-scrub trivially short strings


def collect_secret_values(obj: Any) -> set[str]:
    """Every string a key-based ``redact`` of ``obj`` would hide —
    the concrete secret VALUES, for the second scrub pass."""
    out: set[str] = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            if _key_is_secret(str(k)):
                if isinstance(v, str) and len(v) >= MIN_SECRET_LEN:
                    out.add(v)
            else:
                out |= collect_secret_values(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out |= collect_secret_values(v)
    return out


def scrub_values(obj: Any, secrets: set[str]) -> Any:
    """Replace every occurrence of a known secret value inside every
    string of ``obj`` — exception messages and tracebacks in the error
    ring can embed secrets no key-based pass can see."""
    if not secrets:
        return obj
    if isinstance(obj, str):
        for s in secrets:
            if s in obj:
                obj = obj.replace(s, REDACTED)
        return obj
    if isinstance(obj, dict):
        return {k: scrub_values(v, secrets) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [scrub_values(v, secrets) for v in obj]
    return obj


def _versions() -> dict[str, Any]:
    out: dict[str, Any] = {
        "python": sys.version,
        "platform": platform.platform(),
        "machine": platform.machine(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch"] = getattr(torch, "__version__", "?")
        out["torch.version.cuda"] = getattr(getattr(torch, "version", None), "cuda", None)
    for mod in ("numpy", "aiohttp", "msgpack", "PIL"):
        m = sys.modules.get(mod)
        if m is not None:
            out[mod] = getattr(m, "__version__", "?")
    return out


def _env() -> dict[str, str]:
    return redact({
        k: v for k, v in os.environ.items()
        if k.startswith(ENV_PREFIXES)
    })


def _raw_node_config(node: Any = None, data_dir: str | None = None) -> Any:
    """The node's config dict, UNredacted (internal: the raw values
    seed the value-scrub pass). With no live node, read ``node.json``
    straight off the data dir (offline CLI path)."""
    if node is not None:
        try:
            return node.config.config.to_dict()
        except Exception:  # noqa: BLE001 - bundles degrade, never fail
            return None
    if data_dir:
        path = os.path.join(os.fspath(data_dir), "node.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None
    return None


def _libraries(node: Any) -> list[dict[str, Any]]:
    out = []
    for lib in getattr(getattr(node, "libraries", None), "libraries",
                       {}).values():
        try:
            out.append({
                "id": str(lib.id),
                "name": lib.name,
                "file_paths": lib.db.count("file_path"),
                "objects": lib.db.count("object"),
                "jobs": lib.db.count("job"),
            })
        except Exception:  # noqa: BLE001 - a closing DB must not kill bundles
            out.append({"id": str(lib.id), "name": lib.name})
    return out


#: what the JAX tenant plane's ``snapshot()`` returns with no tenant
#: recorded, at its defaults; the port's own comes with plane 6.2b
NO_TENANTS: dict[str, Any] = {"enabled": True, "k": 8, "surfaces": {}}


def build_bundle(node: Any = None, data_dir: str | None = None) -> dict[str, Any]:
    """Assemble the bundle dict (JSON-serializable, already redacted)."""
    from . import trace as _trace
    from .events import all_events
    from .events import drop_counts as _drop_counts
    from .snapshot import snapshot as _snapshot

    from . import sampler as _sampler

    trace_events = _trace.recent()
    snap = _snapshot()
    raw_config = _raw_node_config(node, data_dir)
    bundle: dict[str, Any] = {
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "versions": _versions(),
        "env": _env(),
        "node_config": redact(raw_config) if raw_config else raw_config,
        "metrics": snap["metrics"],
        "spans": snap["spans"],
        "trace_summary": {
            "spans": len(trace_events),
            "traces": len({r.get("trace_id") for r in trace_events}),
        },
        # key-based pass over ring fields too (a field literally named
        # "token"/"key" gets hidden even before the value scrub)
        "events": redact(all_events()),
        # per-ring overflow drops: a ring that displaced events is a
        # suffix of the story, and the bundle must say so
        "ring_drops": _drop_counts(),
        # host-profiler evidence: the full profile document plus the
        # bounded folded collapsed-stack text (frame names only —
        # module:function, never filesystem paths or values), so a
        # support bundle answers "what was Python doing" offline
        "profile": {
            "doc": _sampler.SAMPLER.profile(),
            "folded": _sampler.SAMPLER.folded(max_bytes=64 * 1024),
        },
        # per-tenant accounting snapshot (the plane is not ported yet)
        "tenants": dict(NO_TENANTS),
    }
    if node is not None:
        bundle["libraries"] = _libraries(node)
    # second pass: the concrete secret VALUES the key-based passes hid
    # (identity keypair hex, tokens, secret-keyed env vars) are
    # scrubbed out of every string in the bundle — tracebacks in the
    # error ring included
    secrets = collect_secret_values(raw_config)
    secrets |= collect_secret_values(dict(os.environ))
    return scrub_values(bundle, secrets)


def render_bundle(node: Any = None, data_dir: str | None = None) -> str:
    return json.dumps(build_bundle(node, data_dir), indent=2, default=str)
