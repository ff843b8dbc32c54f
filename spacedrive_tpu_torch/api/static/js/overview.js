// Overview landing page: library stat cards, per-kind breakdown,
// location cards (role parity: ref:interface/app/$libraryId/overview/
// — LibraryStats.tsx, FileKindStats.tsx, LocationCard.tsx).

import client from "/rspc/client.js";
import { $, KIND_ICON, bus, el, fmtBytes, state } from "/static/js/util.js";
import { t } from "/static/js/i18n.js";

function statCard(label, value, tip) {
  const card = el("div", "stat-card");
  if (tip) card.setAttribute("data-tip", tip);
  card.appendChild(el("div", "value", value));
  card.appendChild(el("div", "meta", label));
  return card;
}

export async function loadOverview() {
  const c = $("content");
  c.className = "overview";
  c.innerHTML = "";
  const [stats, kinds, locs] = await Promise.all([
    client.library.statistics(null, state.lib),
    client.library.kindStatistics(null, state.lib),
    client.locations.list(null, state.lib),
  ]);
  if (state.mode !== "overview") return;  // superseded by navigation

  // --- library stats row (ref:overview/LibraryStats.tsx) -------------
  const row = el("div", "stat-row");
  row.appendChild(statCard(t("objects"), String(stats.total_object_count ?? 0)));
  row.appendChild(statCard(t("indexed"), fmtBytes(+stats.total_bytes_used || 0), t("indexed_tip")));
  row.appendChild(statCard(t("capacity"), fmtBytes(+stats.total_bytes_capacity || 0), t("capacity_tip")));
  row.appendChild(statCard(t("free"), fmtBytes(+stats.total_bytes_free || 0)));
  row.appendChild(statCard(t("database"), fmtBytes(+stats.library_db_size || 0), t("database_tip")));
  row.appendChild(statCard(t("previews"), fmtBytes(+stats.preview_media_bytes || 0), t("previews_tip")));
  c.appendChild(row);

  // --- per-kind breakdown (ref:overview/FileKindStats.tsx) -----------
  c.appendChild(el("h4", "ov-head", t("by_kind")));
  const kindRow = el("div", "kind-row");
  for (const k of kinds.statistics) {
    if (!k.count) continue;
    const card = el("div", "kind-card");
    card.appendChild(el("div", "icon", KIND_ICON[k.kind] || "📄"));
    card.appendChild(el("div", "", k.name));
    card.appendChild(el("div", "meta",
      `${k.count}${+k.total_bytes ? " · " + fmtBytes(+k.total_bytes) : ""}`));
    card.onclick = () => {
      Object.assign(state, {mode: "kind", kindFilter: k.kind,
                            kindName: k.name, loc: null, tag: null,
                            cursor: null});
      bus.clearSelection?.();
      bus.loadContent(true);
    };
    kindRow.appendChild(card);
  }
  if (!kindRow.children.length)
    kindRow.appendChild(el("div", "meta", t("nothing_indexed")));
  c.appendChild(kindRow);

  // --- locations (ref:overview/LocationCard.tsx) ---------------------
  c.appendChild(el("h4", "ov-head", t("locations")));
  const locRow = el("div", "kind-row");
  for (const n of locs.nodes) {
    const card = el("div", "kind-card loc");
    card.appendChild(el("div", "icon", "📂"));
    card.appendChild(el("div", "", n.name || n.path));
    card.appendChild(el("div", "meta", n.path));
    card.onclick = () => {
      Object.assign(state, {mode: "browse", loc: n.id, tag: null,
                            path: "/", cursor: null});
      bus.clearSelection?.();
      bus.loadContent(true);
      bus.refreshNav?.();
    };
    locRow.appendChild(card);
  }
  if (!locRow.children.length)
    locRow.appendChild(el("div", "meta", t("no_locations_yet")));
  c.appendChild(locRow);
}
