// Explorer entry point: boot, library selection, nav, subscriptions,
// keyboard navigation (role parity: ref:interface/app + apps/web entry).

import client, { SdSocket } from "/rspc/client.js";
import { $, bus, el, fmtBytes, state } from "/static/js/util.js";
import { clearSelection, loadContent, moveSelection, openDir, setView, upDir } from "/static/js/views.js";
import { closeInspector, select } from "/static/js/inspector.js";
import { onJobProgress, renderJobs, wireJobsPanel } from "/static/js/jobs.js";
import { openDropPanel, rejectPendingOffer, showDropOffer, wireDropPanel } from "/static/js/spacedrop.js";
import { addLocationModal, wireSettingsPanel } from "/static/js/settings.js";
import { showEphemeralMenu, showMenu, wireContextMenu } from "/static/js/contextmenu.js";
import { showOnboarding } from "/static/js/onboarding.js";
import { attachDropdown, confirmDialog, initTooltips, promptDialog, toast } from "/static/js/ui.js";
import { initI18n, t } from "/static/js/i18n.js";
import { openPreview, previewOpen, wireQuickPreview } from "/static/js/quickpreview.js";
import { droppable, guardTarget } from "/static/js/dnd.js";

const sock = new SdSocket();
let unsubJobs = null;

// late-bound hooks for the other modules
bus.select = select;
bus.openDropPanel = openDropPanel;
bus.loadContent = loadContent;
bus.clearSelection = clearSelection;
bus.reloadLibraries = loadLibraries;
bus.refreshNav = () => state.lib && refreshNav();
bus.refreshHeader = async () => {
  const ns = await client.nodeState();
  $("device").textContent = `${ns.name} · ${ns.device_model}`;
};

// ---------- libraries / nav ----------
export async function loadLibraries() {
  const libs = await client.library.list();
  if (!libs.length) { showOnboarding(); return; }
  $("onboard").classList.remove("open");
  const sel = $("libsel");
  sel.innerHTML = "";
  for (const l of libs) {
    const o = el("option", "", l.config.name);
    o.value = l.uuid; sel.appendChild(o);
  }
  sel.onchange = () => selectLibrary(sel.value);
  const keep = libs.some(l => l.uuid === state.lib) ? state.lib : libs[0].uuid;
  sel.value = keep;
  // a rename/new-library invalidation must NOT reset browsing state
  // when the selected library is unchanged — just refresh the chrome
  if (keep === state.lib) await refreshNav();
  else await selectLibrary(keep);
  bus.refreshHeader();
}

async function selectLibrary(id) {
  // overview is the landing page, like the reference's $libraryId index
  Object.assign(state, { lib:id, loc:null, tag:null, search:"", cursor:null,
                         path:"/", mode:"overview", selected:null,
                         selectedIds:new Set() });
  if (unsubJobs) unsubJobs();
  unsubJobs = sock.subscribe("jobs.progress", onJobProgress, {libraryId:id});
  await refreshNav();
  loadContent(true);
}

function renderRoutes() {
  // overview / favorites / recents (ref:interface/app/$libraryId/
  // {overview,favorites.tsx,recents.tsx} sidebar routes)
  const routes = $("routes");
  routes.innerHTML = "";
  const route = (label, mode) => {
    const item = el("div", "item", label);
    if (state.mode === mode) item.classList.add("active");
    item.onclick = () => { setActive(item);
      Object.assign(state, {mode, loc: null, tag: null, cursor: null});
      clearSelection();
      loadContent(true); };
    routes.appendChild(item);
  };
  route("🏠 " + t("overview"), "overview");
  route("★ " + t("favorites"), "favorites");
  route("🕘 " + t("recents"), "recents");
  route("🌐 " + t("network"), "network");
}

async function refreshNav() {
  renderRoutes();
  const [locs, tags, labels, stats, saved] = await Promise.all([
    client.locations.list(null, state.lib),
    client.tags.list(null, state.lib),
    client.labels.list(null, state.lib),
    client.library.statistics(null, state.lib),
    client.search.saved.list(null, state.lib),
  ]);
  state.locPaths = {};
  state.locNames = {};
  const locDiv = $("locs");
  locDiv.innerHTML = "";
  for (const n of locs.nodes) {
    state.locPaths[n.id] = n.path;
    state.locNames[n.id] = n.name || n.path;
    const item = el("div", "item",
      (n.online === false ? "⚠️ " : "📂 ") + (n.name || n.path));
    if (n.online === false) {
      item.style.opacity = "0.55";
      item.title = t("location_offline_tip");
    }
    item.onclick = () => { setActive(item);
      Object.assign(state, {loc:n.id, tag:null, cursor:null, path:"/",
                            mode:"browse"});
      clearSelection();
      loadContent(true); };
    // sidebar locations are move targets (drop = move to its root)
    droppable(item, () => guardTarget(n.id, "/"));
    locDiv.appendChild(item);
  }
  // "This device" volumes → ephemeral (non-indexed) browse
  // (ref:interface/app/$libraryId/ephemeral.tsx via the sidebar)
  try {
    const vols = await client.volumes.list();
    const volDiv = $("volumes");
    volDiv.innerHTML = "";
    for (const v of vols) {
      const item = el("div", "item", "💻 " + (v.name || v.mount_point));
      item.onclick = () => { setActive(item);
        Object.assign(state, {mode: "ephemeral", ephPath: v.mount_point,
                              ephRoot: v.mount_point,
                              ephRootName: v.name || v.mount_point,
                              loc: null, tag: null, cursor: null});
        clearSelection();
        loadContent(true); };
      volDiv.appendChild(item);
    }
  } catch { /* volumes are best-effort chrome */ }

  state.allTags = tags.nodes;
  const tagDiv = $("tags");
  tagDiv.innerHTML = "";
  for (const n of tags.nodes) {
    const item = el("div", "item", "🏷️ " + (n.name || "?"));
    item.onclick = () => { setActive(item);
      Object.assign(state, {tag:n.id, loc:null, cursor:null, mode:"browse"});
      clearSelection();
      loadContent(true); };
    tagDiv.appendChild(item);
  }
  // AI labels route (ref:interface/app/$libraryId/labels.tsx): the
  // labeler's vocabulary as clickable filters
  const labDiv = $("labels");
  labDiv.innerHTML = "";
  for (const n of labels.nodes) {
    const item = el("div", "item", "🤖 " + (n.name || "?"));
    item.onclick = () => { setActive(item);
      Object.assign(state, {mode: "label", labelFilter: n.id,
                            labelName: n.name, loc: null, tag: null,
                            cursor: null});
      clearSelection();
      loadContent(true); };
    labDiv.appendChild(item);
  }
  if (!labels.nodes.length)
    labDiv.appendChild(el("div", "meta", t("no_labels_yet")));

  const savDiv = $("saved");
  savDiv.innerHTML = "";
  for (const s of saved.nodes) {
    const item = el("div", "item", `🔖 ${s.name || s.search || "?"}`);
    item.onclick = () => { setActive(item);
      Object.assign(state, {mode:"search", search:s.search || "",
                            loc:null, tag:null, cursor:null});
      $("search").value = state.search;
      clearSelection();
      loadContent(true); };
    item.oncontextmenu = async (e) => {
      e.preventDefault();
      const ok = await confirmDialog(t("delete_search_title"),
        t("delete_search_body", {name: s.name || s.search}),
        {danger: true, actionLabel: t("delete")});
      if (ok) {
        await client.search.saved.delete(s.id, state.lib);
        refreshNav();
      }
    };
    savDiv.appendChild(item);
  }

  const tools = $("tools");
  tools.innerHTML = "";
  const dup = el("div", "item", "♊ " + t("duplicates"));
  dup.onclick = () => { setActive(dup);
    Object.assign(state, {mode:"duplicates", loc:null, tag:null});
    clearSelection();
    loadContent(true); };
  tools.appendChild(dup);
  $("stats").textContent =
    `${stats.total_object_count} objects · ${fmtBytes(+stats.total_bytes_used)} indexed`;
}

function setActive(item) {
  document.querySelectorAll("nav .item.active")
    .forEach(e => e.classList.remove("active"));
  if (item) item.classList.add("active");
}

// ---------- header wiring ----------
const SORT_FIELDS = [
  ["name", "sort_name"], ["sizeInBytes", "sort_size"],
  ["dateModified", "sort_modified"], ["dateCreated", "sort_created"],
  ["dateAccessed", "sort_accessed"],
];
attachDropdown($("btn-sort"), () => {
  // these views pin their own ordering (recents = last-opened,
  // ephemeral = dirs-first walker order) or have none — a selectable
  // menu would silently no-op
  if (["recents", "duplicates", "overview", "ephemeral", "network"]
      .includes(state.mode)) {
    return [{label: t("sort_unavailable"), disabled: true}];
  }
  return [
  ...SORT_FIELDS.map(([field, key]) => ({
    label: (state.orderBy === field ? "✓ " : "\u2007 ") + t(key),
    onClick: () => {
      state.orderBy = field;
      localStorage.setItem("sd-order", field);
      clearSelection();
      loadContent(true);
    },
  })),
  {separator: true},
  ...[["asc", "sort_asc"], ["desc", "sort_desc"]].map(([dir, key]) => ({
    label: (state.orderDir === dir ? "✓ " : "\u2007 ") + t(key),
    onClick: () => {
      state.orderDir = dir;
      localStorage.setItem("sd-orderdir", dir);
      clearSelection();
      loadContent(true);
    },
  })),
  ];
});
document.querySelectorAll("#viewsw button").forEach(b =>
  b.onclick = () => setView(b.dataset.view));
$("search").addEventListener("keydown", (e) => {
  if (e.key === "Enter") {
    state.search = e.target.value;
    state.mode = state.search ? "search" : "browse";
    clearSelection();
    loadContent(true);
  }
  if (e.key === "Escape") e.target.blur();
});
$("btn-save-search").onclick = async () => {
  // commit whatever is in the box first — the button must never save
  // a stale query or silently no-op on un-entered text
  const text = $("search").value.trim();
  if (!text) return;
  if (text !== state.search || state.mode !== "search") {
    state.search = text;
    state.mode = "search";
    clearSelection();
    loadContent(true);
  }
  const name = await promptDialog(t("save_search_title"), {
    value: text, message: t("save_search_body"),
    actionLabel: t("save"),
  });
  if (!name) return;
  await client.search.saved.create({name, search: text}, state.lib);
  toast(t("search_saved_toast"), {kind: "ok"});
  refreshNav();
};
$("btn-addloc").onclick = () => addLocationModal();
bus.showMenu = showMenu;
bus.showEphemeralMenu = showEphemeralMenu;
wireJobsPanel();
wireDropPanel();
wireSettingsPanel();
wireContextMenu();
wireQuickPreview();
initTooltips();

// ---------- keyboard navigation ----------
const VIEWS = ["grid", "list", "media"];
document.addEventListener("keydown", (e) => {
  const typing = ["INPUT", "TEXTAREA", "SELECT"]
    .includes(document.activeElement?.tagName);
  if (typing) return;
  switch (e.key) {
    case "/":
      e.preventDefault();
      $("search").focus();
      break;
    case "ArrowRight": e.preventDefault(); moveSelection(1, 0); break;
    case "ArrowLeft": e.preventDefault(); moveSelection(-1, 0); break;
    case "ArrowDown": e.preventDefault(); moveSelection(0, 1); break;
    case "ArrowUp": e.preventDefault(); moveSelection(0, -1); break;
    case "j": moveSelection(1, 0); break;
    case "k": moveSelection(-1, 0); break;
    case "Enter":
      if (state.selected?.is_dir) openDir(state.selected);
      break;
    case " ":
      // space = QuickPreview of the selection (the preview's own
      // capture handler owns the key while open)
      if (state.selected && !previewOpen()) {
        e.preventDefault();
        openPreview(state.selected);
      }
      break;
    case "Backspace": upDir(); break;
    case "v":
      setView(VIEWS[(VIEWS.indexOf(state.view) + 1) % VIEWS.length]);
      break;
    case "Escape":
      // a pending spacedrop offer must be answered, not dismissed
      // (other dialogs handle their own Escape in openDialog)
      if (rejectPendingOffer()) break;
      document.querySelectorAll(".panel.open")
        .forEach(p => p.classList.remove("open"));
      closeInspector();
      break;
  }
});

// ---------- live events ----------
sock.subscribe("p2p.events", (ev) => {
  if (ev.kind === "SpacedropRequest") showDropOffer(ev);
  if (ev.kind === "SpacedropProgress")
    $("events").textContent = `📡 transfer ${ev.percent}%`;
  if (ev.kind && ev.kind.startsWith("Peer") &&
      $("drop-panel").classList.contains("open")) openDropPanel();
});
sock.subscribe("notifications.listen", (ev) => {
  // persisted job-outcome notifications (ref:lib.rs emit_notification)
  const d = ev.data || {};
  const what = d.job || "job";
  const kind = d.kind === "error" ? "error"
             : d.kind === "warning" ? "info" : "ok";
  toast(
    d.message ? `${what}: ${d.message}`
              : `${what} ${t(d.kind === "error" ? "job_failed" : "job_done")}`,
    {kind});
});
sock.subscribe("invalidation.listen", (ev) => {
  $("events").textContent = `↻ ${ev.key}`;
  if (["search.paths", "locations.list", "tags.list"].includes(ev.key))
    loadContent(true);
  if (["locations.list", "tags.list", "labels.list",
       "search.saved.list"].includes(ev.key))
    refreshNav();
  if (ev.key === "library.list") loadLibraries();
  if (ev.key === "jobs.reports" &&
      $("jobs-panel").classList.contains("open")) renderJobs();
});

// ---------- deep links ----------
// `sdx desktop --open-path P` lands here as "#/ephemeral?path=P"
function applyDeepLink() {
  const m = location.hash.match(/^#\/ephemeral\?path=(.+)$/);
  if (!m) return false;
  const path = decodeURIComponent(m[1]);
  Object.assign(state, {mode: "ephemeral", ephPath: path, ephRoot: "/",
                        ephRootName: "/", loc: null, tag: null,
                        cursor: null});
  clearSelection();
  loadContent(true);
  return true;
}
window.addEventListener("hashchange", applyDeepLink);

// ---------- boot ----------
await initI18n();  // catalogs before first render (top-level await)
setView(state.view);
loadLibraries().then(() => { applyDeepLink(); }).catch(e => {
  $("stats").textContent = "error: " + e.message;
});
