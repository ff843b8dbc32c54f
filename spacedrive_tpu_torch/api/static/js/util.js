// Shared state + tiny DOM helpers (role parity: packages/client stores).

import { openDialog } from "/static/js/ui.js";

export const KIND_ICON = {0:"📄",1:"📑",2:"📁",3:"📝",4:"📦",5:"🖼️",6:"🎵",
                          7:"🎬",8:"🗜️",9:"⚙️",10:"🔗",11:"🔒",12:"🔑",
                          13:"🔗",14:"🌐"};

export const ORDER_FIELDS =
  ["name", "sizeInBytes", "dateCreated", "dateModified", "dateAccessed"];

// persisted values are validated: a stale/hand-edited key must not
// make every search.paths call 400 with no visible error
function persisted(key, allowed, fallback) {
  const v = localStorage.getItem(key);
  return allowed.includes(v) ? v : fallback;
}

export const state = {
  lib: null, loc: null, tag: null, search: "", cursor: null,
  path: "/",                       // materialized path inside the location
  mode: "browse",                  // browse | search | duplicates
  view: persisted("sd-view", ["grid", "list", "media"], "grid"),
  orderBy: persisted("sd-order", ORDER_FIELDS, "name"),
  orderDir: persisted("sd-orderdir", ["asc", "desc"], "asc"),
  nodes: [], selected: null, selectedIds: new Set(),
  locPaths: {}, locNames: {}, allTags: [],
};

// late-bound cross-module calls (registered by app.js; avoids cycles)
export const bus = {};

export function el(tag, cls, text) {
  const e = document.createElement(tag);
  if (cls) e.className = cls;
  if (text !== undefined) e.textContent = text;
  return e;
}

export const $ = (id) => document.getElementById(id);

export function fmtBytes(n) {
  if (!n && n !== 0) return "";
  const u = ["B","KB","MB","GB","TB"]; let i = 0;
  while (n >= 1024 && i < u.length-1) { n /= 1024; i++; }
  return n.toFixed(n < 10 && i ? 1 : 0) + " " + u[i];
}

export const thumbUrl = (n) =>
  `/spacedrive/thumbnail/${n.ephemeral ? "ephemeral" : state.lib}` +
  `/${n.cas_id.slice(0,3)}/${n.cas_id}.webp`;

/** location-relative path of a row ("/dir/name.ext") */
export const relPath = (n) =>
  (n.materialized_path || "/") + n.name +
  (n.extension ? "." + n.extension : "");

export const fullPath = (n) => (state.locPaths[n.location_id] || "") + relPath(n);

/** Modal helper — thin wrapper over the ui kit's Dialog so every
 *  existing call site gets focus trapping + Escape + focus restore.
 *  (util ⇄ ui is a call-time-only ES-module cycle — both sides touch
 *  the other's exports inside functions, never at eval time.) */
export function modal(title, build) {
  return openDialog(title, build);
}
