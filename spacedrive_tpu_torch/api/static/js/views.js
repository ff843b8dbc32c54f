// Content area: grid/list/media views, breadcrumbs + directory
// drill-down, pagination, duplicates groups
// (role parity: ref:interface/app/$libraryId/Explorer views).

import client from "/rspc/client.js";
import { $, KIND_ICON, bus, el, fmtBytes, state, thumbUrl } from "/static/js/util.js";
import { dirTarget, draggable, droppable, guardTarget } from "/static/js/dnd.js";
import { t } from "/static/js/i18n.js";
import { loadOverview } from "/static/js/overview.js";

export function setView(view) {
  state.view = view;
  localStorage.setItem("sd-view", view);
  document.querySelectorAll("#viewsw button").forEach(b =>
    b.classList.toggle("active", b.dataset.view === view));
  loadContent(true);
}

let loadSeq = 0;  // drop stale responses when loads overlap

export async function loadContent(reset) {
  if (state.mode === "duplicates") return loadDuplicates();
  if (state.mode === "ephemeral") return loadEphemeral();
  if (state.mode === "network") {
    ++loadSeq;
    state.nodes = [];
    state.cursor = null;
    renderCrumbs();
    const { loadNetwork } = await import("/static/js/network.js");
    return loadNetwork();
  }
  if (state.mode === "overview") {
    // invalidate any in-flight listing and drop its rows: a stale
    // response must not paint over the landing page, and keyboard
    // selection must not walk invisible nodes
    ++loadSeq;
    state.nodes = [];
    state.cursor = null;
    renderCrumbs();
    return loadOverview();
  }
  if (reset) { state.cursor = null; state.nodes = []; }
  const seq = ++loadSeq;
  const before = state.nodes.length;
  const filter = {};
  const extra = {};
  if (state.mode === "search") {
    if (state.search) filter.search = state.search;
    if (state.loc) filter.locationId = state.loc;
  } else if (state.mode === "favorites") {
    filter.favorite = true;           // ref:favorites.tsx fixed filter
  } else if (state.mode === "recents") {
    filter.accessed = true;           // ref:recents.tsx dateAccessed filter
    extra.orderBy = "dateAccessed";
    extra.orderDir = "desc";
  } else if (state.mode === "kind") {
    filter.kinds = [state.kindFilter];
  } else if (state.mode === "label") {
    filter.labels = [state.labelFilter];  // ref:labels.tsx route
  } else {
    if (state.loc) {
      filter.locationId = state.loc;
      filter.path = state.path;     // non-recursive directory listing
    }
  }
  if (state.tag) filter.tags = [state.tag];
  if (state.view === "media" && state.mode !== "kind") filter.kinds = [5, 7];
  if (!extra.orderBy) {  // recents pins its own dateAccessed ordering
    extra.orderBy = state.orderBy;
    extra.orderDir = state.orderDir;
  }
  const page = await client.search.paths(
    {filter, take: 60, cursor: state.cursor, ...extra}, state.lib);
  if (seq !== loadSeq) return;  // a newer load superseded this one
  state.cursor = page.cursor;
  state.nodes = state.nodes.concat(page.nodes);
  renderCrumbs();
  if (before === 0) render();
  else appendFrom(before);  // keep scroll position on "load more"
}

// ---------- ephemeral (non-indexed) browse ----------
// (ref:interface/app/$libraryId/ephemeral.tsx — browse any path on
// this device without indexing; thumbs are generated on the fly into
// the ephemeral namespace by the backend walker)
async function loadEphemeral() {
  const seq = ++loadSeq;
  state.cursor = null;
  renderCrumbs();
  let page;
  try {
    page = await client.ephemeralFiles.list({ path: state.ephPath });
  } catch (e) {
    if (seq !== loadSeq) return;
    $("content").innerHTML = "";
    $("content").appendChild(el("div", "meta", t("ephemeral_error", {error: e.message})));
    return;
  }
  if (seq !== loadSeq) return;
  state.nodes = page.entries.map((en, i) => ({
    ...en,
    id: "eph:" + en.path,
    object_kind: en.kind,
    date_created: new Date(en.date_created * 1000).toISOString(),
    date_modified: new Date(en.date_modified * 1000).toISOString(),
    materialized_path: null,
    ephemeral: true,
  }));
  render();
}

export function renderCrumbs() {
  const c = $("crumbs");
  c.innerHTML = "";
  const seg = (label, onclick) => {
    const s = el("span", "seg", label);
    s.onclick = onclick;
    c.appendChild(s);
    return s;
  };
  if (state.mode === "ephemeral") {
    // device-absolute crumb trail: every segment is navigable
    const root = state.ephRoot || "/";
    seg("💻 " + (state.ephRootName || root), () => {
      state.ephPath = root; clearSelection(); loadContent(true);
    });
    const rel = state.ephPath.startsWith(root)
      ? state.ephPath.slice(root.length) : state.ephPath;
    let acc = root.endsWith("/") ? root : root + "/";
    for (const p of rel.split("/").filter(Boolean)) {
      c.appendChild(el("span", "sep", "›"));
      acc += p + "/";
      const target = acc.slice(0, -1);
      seg(p, () => { state.ephPath = target; clearSelection();
        loadContent(true); });
    }
    return;
  }
  if (state.mode === "network") {
    c.appendChild(el("span", "", t("network_crumb")));
    return;
  }
  if (state.mode === "search") {
    c.appendChild(el("span", "", t("search_crumb", {query: state.search})));
    const back = el("button", "mini", t("clear"));
    back.style.marginLeft = "8px";
    back.onclick = () => { state.mode = "browse"; state.search = "";
      $("search").value = ""; clearSelection(); loadContent(true); };
    c.appendChild(back);
    return;
  }
  if (state.mode === "duplicates") {
    c.appendChild(el("span", "", t("duplicate_groups")));
    return;
  }
  if (state.mode === "overview") {
    c.appendChild(el("span", "", t("library_overview")));
    return;
  }
  if (state.mode === "favorites") {
    c.appendChild(el("span", "", t("favorites_crumb")));
    return;
  }
  if (state.mode === "recents") {
    c.appendChild(el("span", "", t("recents_crumb")));
    return;
  }
  if (state.mode === "kind") {
    c.appendChild(el("span", "", t("kind_crumb", {kind: state.kindName || state.kindFilter})));
    const back = el("button", "mini", t("back_to_overview"));
    back.style.marginLeft = "8px";
    back.onclick = () => { state.mode = "overview"; clearSelection();
      loadContent(true); };
    c.appendChild(back);
    return;
  }
  if (state.mode === "label") {
    c.appendChild(el("span", "", t("label_crumb", {name: state.labelName || ""})));
    return;
  }
  if (state.tag) {
    c.appendChild(el("span", "", t("tagged_files")));
    return;
  }
  if (!state.loc) {
    c.appendChild(el("span", "", t("select_location")));
    return;
  }
  const crumbDrop = (s, path) =>
    droppable(s, () => guardTarget(state.loc, path));
  crumbDrop(
    seg("📂 " + (state.locNames[state.loc] || "location"), () => {
      state.path = "/"; clearSelection(); loadContent(true);
    }), "/");
  const parts = state.path.split("/").filter(Boolean);
  let acc = "/";
  for (const p of parts) {
    c.appendChild(el("span", "sep", "›"));
    acc += p + "/";
    const target = acc;
    crumbDrop(
      seg(p, () => { state.path = target; clearSelection(); loadContent(true); }),
      target);
  }
}

export function openDir(n) {
  if (n.ephemeral) {
    state.ephPath = n.path;
    clearSelection();
    loadContent(true);
    return;
  }
  state.path = (n.materialized_path || "/") + n.name + "/";
  state.selected = null;
  state.selectedIds = new Set();
  loadContent(true);
}

/** Navigation context changed (folder/search/tag): drop the selection
 *  so stale per-folder ids can't feed batch operations. */
export function clearSelection() {
  state.selected = null;
  state.selectedIds = new Set();
}

export function upDir() {
  if (state.mode === "ephemeral") {
    const root = state.ephRoot || "/";
    if (state.ephPath === root) return;
    const parent = state.ephPath.replace(/\/[^/]+$/, "") || root;
    state.ephPath = parent.length < root.length ? root : parent;
    clearSelection();
    loadContent(true);
    return;
  }
  if (state.mode !== "browse" || !state.loc || state.path === "/") return;
  clearSelection();
  const parts = state.path.split("/").filter(Boolean);
  parts.pop();
  state.path = "/" + parts.map(p => p + "/").join("");
  if (state.path === "") state.path = "/";
  loadContent(true);
}

function render() {
  const c = $("content");
  c.className = state.view;
  c.innerHTML = "";
  appendFrom(0);
}

function appendFrom(start) {
  const c = $("content");
  $("more")?.remove();
  let listBody = c.querySelector("table.listing");
  if (state.view === "list") {
    if (!listBody) {
      listBody = el("table", "listing");
      const head = el("tr");
      for (const h of ["name", "kind", "size", "modified", "path"])
        head.appendChild(el("th", "", t(h)));
      listBody.appendChild(head);
      c.appendChild(listBody);
    }
    renderListRows(listBody, state.nodes.slice(start));
  } else {
    // kind mode already filters server-side; the media-view client
    // filter would blank non-media kinds
    renderCards(c, state.view === "media" && state.mode !== "kind",
                state.nodes.slice(start));
  }
  if (state.cursor) {
    const btn = el("button", "", t("load_more"));
    btn.id = "more";
    btn.onclick = () => loadContent(false);
    c.appendChild(btn);
  }
}

function activate(n) {
  if (n.is_dir) openDir(n);
  else bus.select(n);
}

function renderCards(c, mediaOnly, nodes) {
  for (const n of nodes) {
    if (mediaOnly && ![5,7].includes(n.object_kind)) continue;
    const card = el("div", "card");
    card.dataset.fp = String(n.id);
    if (state.selectedIds.has(n.id))
      card.classList.add("selected");
    const thumb = el("div", "thumb");
    if (n.cas_id && [5,7].includes(n.object_kind)) {
      const img = el("img");
      img.loading = "lazy";
      img.src = thumbUrl(n);
      img.onerror = () => { thumb.textContent = KIND_ICON[n.object_kind] || "📄"; };
      thumb.appendChild(img);
    } else {
      thumb.textContent = n.is_dir ? "📁" : (KIND_ICON[n.object_kind] || "📄");
    }
    card.appendChild(thumb);
    card.appendChild(el("div", "name",
      n.name + (n.extension ? "." + n.extension : "")));
    card.appendChild(el("div", "meta",
      n.is_dir ? t("folder") : fmtBytes(n.size_in_bytes)));
    card.onclick = (e) => bus.select(n, e);
    card.ondblclick = () => activate(n);
    if (!n.ephemeral) {
      // db-backed affordances: tag/favorite menus, move-by-drag
      card.oncontextmenu = (e) => { e.preventDefault();
        if (!state.selectedIds.has(n.id)) bus.select(n);
        bus.showMenu(e.clientX, e.clientY, n); };
      draggable(card, n);
      if (n.is_dir) droppable(card, dirTarget(n));
    } else {
      card.oncontextmenu = (e) => { e.preventDefault();
        if (!state.selectedIds.has(n.id)) bus.select(n);
        bus.showEphemeralMenu(e.clientX, e.clientY, n); };
    }
    c.appendChild(card);
  }
}

function renderListRows(table, nodes) {
  for (const n of nodes) {
    const tr = el("tr");
    tr.dataset.fp = String(n.id);
    if (state.selectedIds.has(n.id))
      tr.classList.add("selected");
    const icon = n.is_dir ? "📁" : (KIND_ICON[n.object_kind] || "📄");
    tr.appendChild(el("td", "",
      `${icon} ${n.name}${n.extension ? "." + n.extension : ""}`));
    tr.appendChild(el("td", "", n.is_dir ? t("folder") : (n.extension || "")));
    tr.appendChild(el("td", "", n.is_dir ? "" : fmtBytes(n.size_in_bytes)));
    tr.appendChild(el("td", "", (n.date_modified || "").slice(0, 16)));
    tr.appendChild(el("td", "", n.materialized_path || ""));
    tr.onclick = (e) => bus.select(n, e);
    tr.ondblclick = () => activate(n);
    if (!n.ephemeral) {
      tr.oncontextmenu = (e) => { e.preventDefault();
        if (!state.selectedIds.has(n.id)) bus.select(n);
        bus.showMenu(e.clientX, e.clientY, n); };
      draggable(tr, n);
      if (n.is_dir) droppable(tr, dirTarget(n));
    } else {
      tr.oncontextmenu = (e) => { e.preventDefault();
        if (!state.selectedIds.has(n.id)) bus.select(n);
        bus.showEphemeralMenu(e.clientX, e.clientY, n); };
    }
    table.appendChild(tr);
  }
}

// ---------- duplicates (config-5 flow surfaced in the UI) ----------
async function loadDuplicates() {
  renderCrumbs();
  const c = $("content");
  c.className = "";
  c.innerHTML = "";
  c.appendChild(el("div", "meta", t("scanning")));
  const groups = await client.search.duplicates({threshold: 8}, state.lib);
  c.innerHTML = "";
  if (!groups.length) {
    const box = el("div", "dupgroup");
    box.appendChild(el("div", "meta", t("no_duplicates")));
    c.appendChild(box);
    return;
  }
  for (const g of groups) {
    const box = el("div", "dupgroup");
    box.appendChild(el("b", "",
      `${g.files.length} files (${g.kind === "exact" ? "identical" : "near-duplicate"})`));
    const files = el("div", "files");
    for (const p of g.files) {
      files.appendChild(el("div", "meta",
        `${p.materialized_path || "/"}${p.name}`
        + `${p.extension ? "." + p.extension : ""} · ${fmtBytes(p.size_in_bytes)}`));
    }
    box.appendChild(files);
    c.appendChild(box);
  }
}

// ---------- keyboard navigation ----------
export function moveSelection(dx, dy) {
  const nodes = state.nodes;
  if (!nodes.length) return;
  let idx = state.selected
    ? nodes.findIndex(n => n.id === state.selected.id) : -1;
  let cols = 1;
  if (state.view !== "list") {
    const c = $("content");
    const card = c.querySelector(".card");
    if (card) cols = Math.max(1, Math.floor(
      c.clientWidth / (card.offsetWidth + 12)));
  }
  const delta = dx + dy * cols;
  idx = idx < 0 ? 0 : Math.max(0, Math.min(nodes.length - 1, idx + delta));
  bus.select(nodes[idx]);
  document.querySelector(`#content [data-fp="${nodes[idx].id}"]`)
    ?.scrollIntoView({block: "nearest"});
}
