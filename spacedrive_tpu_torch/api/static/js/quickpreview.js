// QuickPreview — space-bar full-size preview of the selected item,
// arrows step through the current listing while open (role parity:
// ref:interface/app/$libraryId/Explorer/QuickPreview/index.tsx over
// the range-served original, ref:core/src/custom_uri).

import client from "/rspc/client.js";
import { $, KIND_ICON, bus, el, fmtBytes, relPath, state } from "/static/js/util.js";

export const fileUrl = (n) => {
  if (n.ephemeral) {
    // non-indexed rows serve over the raw-path route (same trust
    // surface as the ephemeralFiles.* procedures)
    return `/spacedrive/local?path=${encodeURIComponent(n.path)}`;
  }
  // per-segment encoding: "#"/"?" in filenames must not become
  // fragment/query separators (encodeURI leaves them bare)
  const path = relPath(n).split("/").map(encodeURIComponent).join("/");
  return `/spacedrive/file/${state.lib}/${n.location_id}${path}`;
};

const TEXT_EXTS = new Set([
  "txt", "md", "json", "py", "js", "ts", "rs", "toml", "yaml", "yml",
  "c", "h", "cpp", "css", "html", "xml", "csv", "log", "sh", "ini",
]);

let current = null; // node being previewed

export const previewOpen = () => !!current;

export function openPreview(n) {
  if (!n || n.is_dir) return;
  current = n;
  render();
  $("preview-back").classList.add("open");
  stampAccess(n);  // no-op for ephemeral rows (no db id to stamp)
}

/** opening a preview counts as opening the file — feeds the recents
 *  route (ref:core/src/api/files.rs:298 updateAccessTime) */
function stampAccess(n) {
  if (n.ephemeral) return;
  n.object_date_accessed = new Date().toISOString();
  client.files.updateAccessTime({ids: [n.id]}, state.lib).catch(() => {});
}

export function closePreview() {
  current = null;
  $("preview-back").classList.remove("open");
  $("preview-body").innerHTML = ""; // stops <video>/<audio> playback
}

/** step to the previous/next non-directory row of the listing */
export function stepPreview(delta) {
  if (!current) return;
  const files = state.nodes.filter((x) => !x.is_dir);
  const idx = files.findIndex((x) => x.id === current.id);
  const next = files[idx + delta];
  if (next) {
    current = next;
    bus.select(next);
    render();
    stampAccess(next);
  }
}

async function render() {
  const n = current;
  const body = $("preview-body");
  body.innerHTML = "";
  $("preview-name").textContent =
    n.name + (n.extension ? "." + n.extension : "") +
    (n.size_in_bytes ? ` · ${fmtBytes(n.size_in_bytes)}` : "");
  const url = fileUrl(n);
  const kind = n.object_kind;
  const ext = (n.extension || "").toLowerCase();  // stored verbatim
  if (kind === 5) {
    const img = el("img");
    img.src = url;
    img.onerror = () => { img.replaceWith(el("div", "meta", "✗ load failed")); };
    body.appendChild(img);
  } else if (kind === 7) {
    const v = el("video");
    v.controls = true;
    v.src = url;
    body.appendChild(v);
  } else if (kind === 6) {
    const a = el("audio");
    a.controls = true;
    a.src = url;
    body.appendChild(a);
  } else if (ext === "pdf") {
    // the browser's own viewer over the range-served original
    const f = el("iframe");
    f.src = url;
    body.appendChild(f);
  } else if ([3, 9].includes(kind) || TEXT_EXTS.has(ext)) {
    const pre = el("pre", "", "loading…");
    body.appendChild(pre);
    try {
      // head only — a 2 GB log must not be pulled into the page
      const resp = await fetch(url, { headers: { Range: "bytes=0-65535" } });
      if (!resp.ok) throw new Error(`HTTP ${resp.status}`);
      const text = await resp.text();
      if (current === n)
        pre.textContent =
          text + (resp.status === 206 && n.size_in_bytes > 65536
            ? "\n… (first 64 KiB)" : "");
    } catch (e) {
      pre.textContent = "✗ " + e.message;
    }
  } else {
    body.appendChild(el("div", "bigicon", KIND_ICON[kind] || "📄"));
    body.appendChild(el("div", "meta", "no preview for this kind"));
  }
}

export function wireQuickPreview() {
  $("preview-back").onclick = (e) => {
    if (e.target.id === "preview-back") closePreview();
  };
  $("preview-close").onclick = closePreview;
  // capture phase: while the preview is open it owns the WHOLE
  // keyboard — any key leaking through would drive the grid underneath
  // (move the selection, open a dir, switch view) and leave `current`
  // pointing at a listing that no longer exists
  document.addEventListener("keydown", (e) => {
    if (!current) return;
    e.stopPropagation();
    if ([" ", "Escape", "ArrowLeft", "ArrowRight"].includes(e.key)) {
      e.preventDefault();
      if (e.key === " " || e.key === "Escape") closePreview();
      else stepPreview(e.key === "ArrowRight" ? 1 : -1);
    }
  }, true);
}
