"""Generated JS client — the `packages/client` analogue.

The reference ships a typed rspc client generated from the Rust router
(ref:packages/client/src/core.ts — 599 generated lines — consumed via
the hooks in ref:packages/client/src/rspc.tsx:11-40, which split
library-scoped from node-scoped procedures). Here the same artifact is
generated from the live `Router.manifest()` and served at
`/rspc/client.js`: a namespaced ES module whose call tree mirrors the
procedure keys, with JSDoc types, library-scope enforcement, and a
reconnecting subscription socket.

Counterpart of `spacedrive_tpu/api/client_gen.py`: the same module text
for the same manifest, but for the generator's name in its first line.
"""

from __future__ import annotations

import json
from typing import Any

_PRELUDE = """\
// GENERATED by spacedrive_tpu_torch.api.client_gen — do not edit.
// Mirrors packages/client (typed rspc client) for this node's router.

/** @typedef {{code:number,message:string}} RspcError */

export class SdError extends Error {
  constructor(code, message) { super(message); this.code = code; }
}

async function call(kind, key, arg = null, libraryId = null) {
  const res = await fetch(`/rspc/${key}`, {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ arg, library_id: libraryId }),
  });
  let body = null;
  try { body = await res.json(); } catch { /* non-json error */ }
  if (!res.ok) {
    throw new SdError(res.status, (body && body.error) || `${res.status}`);
  }
  return body.result;
}

/** One multiplexed subscription socket with auto-reconnect; mirrors
 *  the ws transport in apps/server (subscriptionAdd/Remove frames). */
export class SdSocket {
  constructor(url = `ws://${location.host}/rspc/ws`) {
    this.url = url;
    this.subs = new Map(); // id -> {key, libraryId, arg, onEvent}
    this.nextId = 1;
    this._connect();
  }
  _connect() {
    this.ws = new WebSocket(this.url);
    this.ws.onopen = () => {
      for (const [id, s] of this.subs) this._add(id, s);
    };
    this.ws.onmessage = (m) => {
      const msg = JSON.parse(m.data);
      const sub = this.subs.get(msg.id);
      if (sub && msg.event !== undefined) sub.onEvent(msg.event);
    };
    this.ws.onclose = () => setTimeout(() => this._connect(), 2000);
  }
  _add(id, s) {
    if (this.ws.readyState !== WebSocket.OPEN) return;
    this.ws.send(JSON.stringify({
      id, type: "subscriptionAdd", key: s.key,
      library_id: s.libraryId ?? null, arg: s.arg ?? null,
    }));
  }
  /** @returns {() => void} unsubscribe */
  subscribe(key, onEvent, { libraryId = null, arg = null } = {}) {
    const id = String(this.nextId++);
    const sub = { key, libraryId, arg, onEvent };
    this.subs.set(id, sub);
    this._add(id, sub);
    return () => {
      this.subs.delete(id);
      if (this.ws.readyState === WebSocket.OPEN) {
        this.ws.send(JSON.stringify({ id, type: "subscriptionRemove" }));
      }
    };
  }
}
"""


def _tree_from_manifest(manifest: dict[str, list[dict[str, Any]]]) -> dict:
    tree: dict = {}
    for kind, plural in (("query", "queries"), ("mutation", "mutations")):
        for proc in manifest[plural]:
            parts = proc["key"].split(".")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            leaf = node.setdefault(parts[-1], {})
            leaf["__proc__"] = {
                "key": proc["key"], "kind": kind, "library": proc["library"],
            }
    return tree


def _emit(node: dict, indent: int) -> str:
    pad = "  " * indent
    lines = []
    proc = node.get("__proc__")
    children = {k: v for k, v in node.items() if k != "__proc__"}
    if proc and not children:
        lib = proc["library"]
        doc = (f"/** {proc['kind']}{' (library-scoped)' if lib else ''}: "
               f"{proc['key']} */")
        if lib:
            fn = (f"(arg = null, libraryId) => {{ if (libraryId == null) "
                  f"throw new SdError(400, \"libraryId required for "
                  f"{proc['key']}\"); return call({proc['kind']!r}, "
                  f"{proc['key']!r}, arg, libraryId); }}")
        else:
            fn = (f"(arg = null) => call({proc['kind']!r}, "
                  f"{proc['key']!r}, arg)")
        return f"{doc}\n{pad}{fn}"
    body = []
    for name in sorted(children):
        emitted = _emit(children[name], indent + 1)
        body.append(f"{pad}  {json.dumps(name)}: {emitted},")
    obj = "{\n" + "\n".join(body) + f"\n{pad}}}"
    if proc:
        # a namespace that is ALSO callable (rare); expose as .$call
        call_leaf = _emit({"__proc__": proc}, indent + 1)
        obj = ("{\n" + f"{pad}  \"$call\": {call_leaf},\n"
               + "\n".join(body) + f"\n{pad}}}")
    return obj


def generate_js(manifest: dict[str, list[dict[str, Any]]]) -> str:
    tree = _tree_from_manifest(manifest)
    subs = [p["key"] for p in manifest["subscriptions"]]
    out = [_PRELUDE]
    out.append(f"export const subscriptions = {json.dumps(subs)};")
    out.append(f"export const manifest = {json.dumps(manifest)};")
    out.append("export const client = " + _emit(tree, 0) + ";")
    out.append("export default client;")
    return "\n".join(out) + "\n"
