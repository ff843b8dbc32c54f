// Inspector panel: file details, favorite, note, tag chips + editor,
// labels (role parity: ref:interface/app/$libraryId/Explorer/Inspector).

import client from "/rspc/client.js";
import { $, bus, el, fmtBytes, fullPath, state } from "/static/js/util.js";
import { t } from "/static/js/i18n.js";

/** dt/dd list builder shared by the details and media sections. */
function makeDl() {
  const dl = el("dl");
  const add = (k, v) => { if (v !== undefined && v !== null && v !== "") {
    dl.appendChild(el("dt", "", k)); dl.appendChild(el("dd", "", String(v))); } };
  return { dl, add };
}

/** EXIF/stream facts for the selected object (ref:Inspector MediaData
 *  section over files.getMediaData). */
async function mediaSection(box, n) {
  // `box` is a placeholder appended synchronously by THIS selection's
  // render: if a newer selection supersedes us, the box is already
  // detached and these appends are invisible — no staleness hazard,
  // and the favorite/note/tags render is never serialized behind the
  // media RPC.
  let md = null;
  try {
    md = await client.files.getMediaData(n.object_id, state.lib);
  } catch {
    return;
  }
  if (!md) return;
  const { dl, add } = makeDl();
  const res = md.resolution;
  if (res && res[0]) add(t("media_resolution"), `${res[0]} × ${res[1]}`);
  const cam = md.camera_data || {};
  if (cam.video) {
    if (cam.duration_seconds)
      add(t("media_duration"), `${cam.duration_seconds.toFixed(1)} s`);
    if (cam.fps) add("fps", cam.fps.toFixed(2));
    if (cam.codec) add(t("media_codec"), cam.codec);
  } else {
    add(t("media_taken"), md.media_date);
    const device = [cam.device_make, cam.device_model]
      .filter(Boolean).join(" ");
    if (device) add(t("media_camera"), device);
    if (cam.focal_length) add(t("media_focal"), `${cam.focal_length} mm`);
    if (cam.iso) add("ISO", cam.iso);
    if (cam.aperture) add(t("media_aperture"), `f/${cam.aperture}`);
    if (cam.shutter_speed) add(t("media_shutter"), cam.shutter_speed);
  }
  const loc = md.media_location;
  if (loc && loc.latitude !== undefined)
    add("GPS", `${(+loc.latitude).toFixed(5)}, ${(+loc.longitude).toFixed(5)}`);
  if (md.artist) add(t("media_artist"), md.artist);
  if (!dl.children.length) return;
  const head = el("h4", "", t("media_section"));
  head.style.margin = "12px 0 4px";
  box.appendChild(head);
  box.appendChild(dl);
}

export function updateSelection() {
  const ids = state.selectedIds;
  document.querySelectorAll("#content .card, #content tr[data-fp]")
    .forEach(e => e.classList.toggle("selected", ids.has(+e.dataset.fp)));
}

/** Selection model: plain click = single; ctrl/cmd = toggle; shift =
 *  range from the anchor (ref:interface Explorer multi-select). */
let selGen = 0;  // bumped per select(); stale awaits bail

export async function select(n, ev = null) {
  const gen = ++selGen;
  if (ev && (ev.ctrlKey || ev.metaKey)) {
    if (state.selectedIds.has(n.id) && state.selectedIds.size > 1) {
      state.selectedIds.delete(n.id);
      n = state.nodes.find(x => state.selectedIds.has(x.id)) || n;
    } else {
      state.selectedIds.add(n.id);
    }
  } else if (ev && ev.shiftKey && state.selected) {
    const a = state.nodes.findIndex(x => x.id === state.selected.id);
    const b = state.nodes.findIndex(x => x.id === n.id);
    if (a >= 0 && b >= 0) {
      state.selectedIds = new Set(
        state.nodes.slice(Math.min(a, b), Math.max(a, b) + 1).map(x => x.id)
      );
    } else {
      // stale anchor (nodes were reloaded): degrade to single-select
      // so the inspector never disagrees with the highlight
      state.selectedIds = new Set([n.id]);
    }
  } else {
    state.selectedIds = new Set([n.id]);
  }
  state.selected = n;
  updateSelection();
  const insp = $("inspector");
  insp.classList.add("open");
  insp.innerHTML = "";
  if (state.selectedIds.size > 1) {
    insp.appendChild(el("h3", "", `${state.selectedIds.size} items selected`));
    const chosen = state.nodes.filter(x => state.selectedIds.has(x.id));
    const bytes = chosen.reduce(
      (s, x) => s + (x.is_dir ? 0 : (x.size_in_bytes || 0)), 0);
    insp.appendChild(el("div", "meta", `${fmtBytes(bytes)} total`));
    return;
  }
  insp.appendChild(el("h3", "",
    n.name + (n.extension ? "." + n.extension : "")));
  const { dl, add } = makeDl();
  add("kind", n.is_dir ? "folder" : (n.object_kind ?? ""));
  add("size", n.is_dir ? "" : fmtBytes(n.size_in_bytes));
  add("created", (n.date_created || "").slice(0, 19));
  add("modified", (n.date_modified || "").slice(0, 19));
  add("path", (n.materialized_path || "") + n.name);
  add("cas_id", n.cas_id);
  insp.appendChild(dl);

  if (n.object_id) {
    // media facts fill in asynchronously alongside the controls below
    if ([5, 7].includes(n.object_kind)) {
      const mediaBox = el("div");
      insp.appendChild(mediaBox);
      mediaSection(mediaBox, n);
    }
    // favorite + note (files.setFavorite/setNote take the file_path id)
    const favBtn = el("button", "",
      n.object_favorite ? "★ favorited" : "☆ favorite");
    favBtn.onclick = async () => {
      n.object_favorite = n.object_favorite ? 0 : 1;
      await client.files.setFavorite(
        {id: n.id, favorite: !!n.object_favorite}, state.lib);
      select(n);
    };
    insp.appendChild(favBtn);
    insp.appendChild(el("h4", "", " "));
    const note = el("textarea");
    note.id = "note";
    note.placeholder = "note…";
    note.value = n.object_note || "";
    note.onblur = async () => {
      if (note.value !== (n.object_note || "")) {
        n.object_note = note.value;
        await client.files.setNote(
          {id: n.id, note: note.value}, state.lib);
      }
    };
    insp.appendChild(note);

    // tags (chips + editor)
    const tagHead = el("h4", "", "Tags");
    tagHead.style.margin = "12px 0 4px";
    insp.appendChild(tagHead);
    const chipBox = el("div");
    insp.appendChild(chipBox);
    const myTags = (await client.tags.getForObject(n.object_id, state.lib)).nodes;
    if (gen !== selGen) return;  // superseded while fetching tags
    for (const tg of myTags) {
      const chip = el("span", "chip");
      const dot = el("i", "dot");
      dot.style.background = tg.color || "#5a7bfc";
      chip.appendChild(dot);
      chip.appendChild(document.createTextNode(tg.name || "?"));
      const x = el("span", "x", "×");
      x.onclick = async () => {
        await client.tags.assign(
          {tag_id: tg.id, object_ids: [n.object_id], unassign: true}, state.lib);
        select(n);
      };
      chip.appendChild(x);
      chipBox.appendChild(chip);
    }
    const addBox = el("div", "addtag");
    const sel = el("select");
    sel.appendChild(el("option", "", "+ tag…"));
    for (const tg of state.allTags) {
      if (myTags.some(m => m.id === tg.id)) continue;
      const o = el("option", "", tg.name || "?");
      o.value = tg.id;
      sel.appendChild(o);
    }
    const newOpt = el("option", "", "new tag…");
    newOpt.value = "__new__";
    sel.appendChild(newOpt);
    sel.onchange = async () => {
      if (sel.value === "__new__") {
        const name = prompt("tag name");
        if (!name) { sel.selectedIndex = 0; return; }
        const color = "#" + Math.floor(Math.random()*0xffffff)
          .toString(16).padStart(6, "0");
        const tid = await client.tags.create({name, color}, state.lib);
        await client.tags.assign(
          {tag_id: tid, object_ids: [n.object_id]}, state.lib);
      } else if (sel.value) {
        await client.tags.assign(
          {tag_id: +sel.value, object_ids: [n.object_id]}, state.lib);
      }
      const tags = await client.tags.list(null, state.lib);
      state.allTags = tags.nodes;
      bus.refreshNav?.();
      select(n);
    };
    addBox.appendChild(sel);
    insp.appendChild(addBox);

    // labels (read-only; written by the image labeler)
    const labels =
      (await client.labels.getForObject(n.object_id, state.lib)).nodes;
    if (gen !== selGen) return;  // superseded while fetching labels
    if (labels.length) {
      const lh = el("h4", "", "Labels");
      lh.style.margin = "12px 0 4px";
      insp.appendChild(lh);
      const lb = el("div");
      for (const l of labels)
        lb.appendChild(el("span", "chip", l.name));
      insp.appendChild(lb);
    }

    // spacedrop shortcut
    const dropBtn = el("button", "", "📡 spacedrop this file");
    dropBtn.style.marginTop = "12px";
    dropBtn.onclick = () => bus.openDropPanel([fullPath(n)]);
    insp.appendChild(dropBtn);
  }
}

export function closeInspector() {
  state.selected = null;
  state.selectedIds = new Set();  // a dismissed selection must not
  // stay live for batch context-menu operations
  updateSelection();
  $("inspector").classList.remove("open");
}
