// Settings panel: node, library, locations, volumes — a tabbed panel
// built on the ui kit (role parity: ref:interface/app/$libraryId/
// settings screens over ref:packages/ui Tabs/Dialog/Toast).

import client from "/rspc/client.js";
import { $, bus, el, fmtBytes, state } from "/static/js/util.js";
import {
  confirmDialog, openDialog, tabs, toast,
} from "/static/js/ui.js";
import { LOCALES, locale, setLocale, t } from "/static/js/i18n.js";

let activeTab = "node";

export function renderSettings() {
  const p = $("settings-panel");
  p.innerHTML = "";
  p.appendChild(el("h2", "", t("settings")));
  tabs(p, [
    {id: "node", label: t("tab_node"), render: renderNodeTab},
    {id: "library", label: t("tab_library"), render: renderLibraryTab},
    {id: "locations", label: t("tab_locations"), render: renderLocationsTab},
    {id: "volumes", label: t("tab_volumes"), render: renderVolumesTab},
    {id: "keys", label: t("tab_keys"), render: renderKeysTab},
    {id: "rules", label: t("tab_rules"), render: renderRulesTab},
  ], {initial: activeTab, onSelect: (id) => { activeTab = id; }});
}

async function renderNodeTab(body) {
  const ns = await client.nodeState();
  body.appendChild(el("h4", "", t("this_node")));
  const nameRow = el("div", "row");
  const nameIn = el("input");
  nameIn.value = ns.name || "";
  const nameBtn = el("button", "mini", t("rename"));
  nameBtn.onclick = async () => {
    await client.nodes.edit({name: nameIn.value});
    toast(t("node_renamed"), {kind: "ok"});
    bus.refreshHeader?.();
  };
  nameRow.appendChild(nameIn);
  nameRow.appendChild(nameBtn);
  body.appendChild(nameRow);

  const bgRow = el("div", "row");
  bgRow.appendChild(el("span", "", t("bg_thumb_pct")));
  const bgIn = el("input");
  bgIn.type = "number";
  bgIn.min = 1; bgIn.max = 100;
  bgIn.style.width = "70px";
  bgIn.value = ns.thumbnailer_background_percentage ?? 50;
  bgIn.onchange = () => client.nodes.updateThumbnailerPreferences(
    {background_processing_percentage: +bgIn.value});
  bgRow.appendChild(bgIn);
  body.appendChild(bgRow);

  body.appendChild(el("h4", "", t("language")));
  const langRow = el("div", "row");
  const sel = el("select");
  for (const [code, label] of Object.entries(LOCALES)) {
    const o = el("option", "", label);
    o.value = code;
    sel.appendChild(o);
  }
  sel.value = locale();
  sel.onchange = () => setLocale(sel.value);
  langRow.appendChild(sel);
  body.appendChild(langRow);

  body.appendChild(el("h4", "", t("features")));
  for (const feat of ["filesOverP2P", "cloudSync"]) {
    const row = el("div", "row");
    row.appendChild(el("span", "", feat));
    const cb = el("input");
    cb.type = "checkbox";
    cb.checked = (ns.features || []).includes(feat);
    cb.onchange = () =>
      client.toggleFeatureFlag({feature: feat, enabled: cb.checked});
    row.appendChild(cb);
    body.appendChild(row);
  }
}

async function renderLibraryTab(body) {
  const libs = await client.library.list();
  const cur = libs.find(l => l.uuid === state.lib);
  if (!cur) return;
  const rn = el("div", "row");
  const libIn = el("input");
  libIn.value = cur.config.name;
  const rb = el("button", "mini", t("rename"));
  rb.onclick = async () => {
    await client.library.edit({id: state.lib, name: libIn.value});
    toast(t("library_renamed"), {kind: "ok"});
    bus.reloadLibraries?.();
  };
  rn.appendChild(libIn);
  rn.appendChild(rb);
  body.appendChild(rn);

  const act = el("div", "row");
  const newBtn = el("button", "mini", t("new_library"));
  newBtn.onclick = () => createLibraryModal();
  const delBtn = el("button", "mini danger", t("delete_library"));
  delBtn.onclick = async () => {
    const ok = await confirmDialog(t("delete_library_title"),
      t("delete_library_body", {name: cur.config.name}),
      {danger: true, actionLabel: t("delete")});
    if (!ok) return;
    await client.library.delete({id: state.lib});
    bus.reloadLibraries?.();
  };
  act.appendChild(newBtn);
  act.appendChild(delBtn);
  body.appendChild(act);

  // Backups (ref:core/src/api/backups.rs + interface settings/node/
  // backups): snapshot now, restore or delete existing snapshots
  body.appendChild(el("h4", "", t("backups_heading")));
  const mk = el("div", "row");
  const bk = el("button", "mini", t("backup_now"));
  const rerender = async () => { body.innerHTML = ""; await renderLibraryTab(body); };
  bk.onclick = async () => {
    try {
      await client.backups.backup(null, state.lib);
      toast(t("backup_done_toast"), {kind: "ok"});
      rerender();
    } catch (e) { toast(e.message, {kind: "error"}); }
  };
  mk.appendChild(bk);
  body.appendChild(mk);
  // only THIS library's snapshots: restore targets the backup's own
  // library_id, so listing others here would roll back a library the
  // user isn't even looking at
  const backups = (await client.backups.getAll())
    .filter(b => b.library_id === state.lib);
  if (!backups.length)
    body.appendChild(el("p", "meta", t("backups_empty")));
  for (const b of backups) {
    const row = el("div", "row");
    row.dataset.backup = b.id;
    row.appendChild(el("span", "", "🗄 " + (b.library_name || b.id)));
    row.appendChild(el("span", "meta", (b.timestamp || "").slice(0, 19)));
    const rs = el("button", "mini", t("backup_restore"));
    rs.onclick = async () => {
      const ok = await confirmDialog(t("backup_restore_title"),
        t("backup_restore_body", {ts: (b.timestamp || "").slice(0, 19)}),
        {danger: true, actionLabel: t("backup_restore")});
      if (!ok) return;
      try {
        await client.backups.restore({path: b.path});
        toast(t("backup_restored_toast"), {kind: "ok"});
        bus.reloadLibraries?.();
      } catch (e) { toast(e.message, {kind: "error"}); }
    };
    row.appendChild(rs);
    const del = el("button", "mini", t("delete"));
    del.onclick = async () => {
      const ok = await confirmDialog(t("backup_delete_title"),
        t("backup_delete_body", {ts: (b.timestamp || "").slice(0, 19)}),
        {danger: true, actionLabel: t("delete")});
      if (!ok) return;
      try {
        await client.backups.delete(b.path);
        rerender();
      } catch (e) { toast(e.message, {kind: "error"}); }
    };
    row.appendChild(del);
    body.appendChild(row);
  }
}

async function renderLocationsTab(body) {
  const locs = await client.locations.list(null, state.lib);
  for (const n of locs.nodes) {
    const row = el("div", "loc-row");
    row.appendChild(el("b", "", n.name || n.path));
    row.appendChild(el("div", "meta", n.path));
    const act = el("div", "actions");
    const rescan = el("button", "mini", t("rescan"));
    rescan.setAttribute("data-tip", t("rescan_tip"));
    rescan.onclick = async () => {
      await client.locations.fullRescan(
        {location_id: n.id, reidentify_objects: false}, state.lib);
      rescan.textContent = t("rescanning");
      toast(t("rescan_started"), {kind: "ok"});
    };
    const del = el("button", "mini danger", t("remove"));
    del.setAttribute("data-tip", t("remove_tip"));
    del.onclick = async () => {
      await client.locations.delete(n.id, state.lib);
      renderSettings();
      bus.refreshNav?.();
    };
    act.appendChild(rescan);
    act.appendChild(del);
    row.appendChild(act);
    body.appendChild(row);
  }
  const addBtn = el("button", "", t("add_location"));
  addBtn.onclick = () => addLocationModal();
  body.appendChild(addBtn);
}

async function renderVolumesTab(body) {
  const vols = await client.volumes.list();
  for (const v of vols) {
    const row = el("div", "row");
    row.appendChild(el("span", "", `${v.name || v.mount_point}`));
    row.appendChild(el("span", "meta",
      `${fmtBytes(v.available_capacity)} free of ${fmtBytes(v.total_capacity)}`));
    body.appendChild(row);
  }
}

// Indexer rules (ref:interface settings/library/rules over
// core/src/api/locations.rs indexer_rules): list system + custom
// rules, create glob-based accept/reject rules, delete custom ones.
async function renderRulesTab(body) {
  const rules = await client.locations.indexerRules.list(null, state.lib);
  const rerender = async () => { body.innerHTML = ""; await renderRulesTab(body); };
  for (const r of rules) {
    const row = el("div", "row");
    row.dataset.rule = String(r.id);
    row.appendChild(el("span", "", "📑 " + r.name));
    row.appendChild(el("span", "meta",
      r.default ? t("rule_system") : t("rule_custom")));
    if (!r.default) {
      const del = el("button", "mini", t("delete"));
      del.onclick = async () => {
        const ok = await confirmDialog(t("rule_delete_title"),
          t("rule_delete_body", {name: r.name}),
          {danger: true, actionLabel: t("delete")});
        if (!ok) return;
        try {
          await client.locations.indexerRules.delete(r.id, state.lib);
          rerender();
        } catch (e) { toast(e.message, {kind: "error"}); }
      };
      row.appendChild(del);
    }
    body.appendChild(row);
  }
  const mk = el("div", "row");
  const name = el("input");
  name.placeholder = t("rule_name_placeholder");
  const globs = el("input");
  globs.placeholder = t("rule_globs_placeholder");
  const kind = el("select");
  for (const [value, key] of [["REJECT_FILES_BY_GLOB", "rule_reject"],
                              ["ACCEPT_FILES_BY_GLOB", "rule_accept"]]) {
    const o = el("option", "", t(key));
    o.value = value;
    kind.appendChild(o);
  }
  const add = el("button", "mini", "+");
  add.onclick = async () => {
    const patterns = globs.value.split(",").map(s => s.trim()).filter(Boolean);
    if (!name.value.trim() || !patterns.length) return;
    try {
      await client.locations.indexerRules.create({
        name: name.value.trim(), kind: kind.value, parameters: patterns,
      }, state.lib);
      toast(t("rule_created_toast"), {kind: "ok"});
      rerender();
    } catch (e) { toast(e.message, {kind: "error"}); }
  };
  mk.appendChild(name);
  mk.appendChild(kind);
  mk.appendChild(globs);
  mk.appendChild(add);
  body.appendChild(mk);
  body.appendChild(el("p", "meta", t("rules_hint")));
}

// Key manager (ref:interface/app/$libraryId/KeyManager/ over
// core/src/api/keys.rs): unlock the per-library vault with the master
// password, then add/mount/unmount/delete stored keys.
async function renderKeysTab(body) {
  const st = await client.keys.state(null, state.lib);
  const rerender = async () => { body.innerHTML = ""; await renderKeysTab(body); };

  if (!st.unlocked) {
    body.appendChild(el("p", "meta", t("keys_locked_body")));
    const row = el("div", "row");
    const pw = el("input");
    pw.type = "password";
    pw.id = "km-password";
    pw.placeholder = t("master_password");
    const go = el("button", "", t("unlock"));
    go.onclick = async () => {
      if (!pw.value) return;
      try {
        const res = await client.keys.unlock(
          {password: pw.value}, state.lib);
        toast(t("keys_unlocked_toast", {n: res.automounted}), {kind: "ok"});
        rerender();
      } catch (e) {
        // wrong password is a 400 — the form must say so, not go dead
        toast(e.message, {kind: "error"});
        pw.select();
      }
    };
    pw.onkeydown = (e) => { if (e.key === "Enter") go.onclick(); };
    row.appendChild(pw);
    row.appendChild(go);
    body.appendChild(row);
    return;
  }

  const failToast = (e) => toast(e.message, {kind: "error"});
  const bar = el("div", "row");
  const addBtn = el("button", "", t("key_add"));
  addBtn.onclick = async () => {
    try {
      await client.keys.add({}, state.lib);
      toast(t("key_added_toast"), {kind: "ok"});
      rerender();
    } catch (e) { failToast(e); }
  };
  const lockBtn = el("button", "", t("keys_lock"));
  lockBtn.onclick = async () => {
    await client.keys.lock(null, state.lib);
    rerender();
  };
  bar.appendChild(addBtn);
  bar.appendChild(lockBtn);
  body.appendChild(bar);

  if (!st.keys.length)
    body.appendChild(el("p", "meta", t("keys_empty")));
  for (const k of st.keys) {
    const row = el("div", "row");
    row.dataset.key = k.uuid;
    row.appendChild(el("span", "", "🔑 " + k.uuid.slice(0, 8)));
    row.appendChild(el("span", "meta",
      k.mounted ? t("key_mounted") : t("key_unmounted")));
    const mnt = el("button", "mini",
      k.mounted ? t("key_unmount") : t("key_mount"));
    mnt.onclick = async () => {
      try {
        await (k.mounted
          ? client.keys.unmount(k.uuid, state.lib)
          : client.keys.mount(k.uuid, state.lib));
        rerender();
      } catch (e) { failToast(e); }
    };
    row.appendChild(mnt);
    const del = el("button", "mini", t("delete"));
    del.onclick = async () => {
      const ok = await confirmDialog(t("key_delete_title"),
        t("key_delete_body"), {danger: true, actionLabel: t("delete")});
      if (!ok) return;
      try {
        await client.keys.delete(k.uuid, state.lib);
        rerender();
      } catch (e) { failToast(e); }
    };
    row.appendChild(del);
    body.appendChild(row);
  }
}

export function addLocationModal() {
  openDialog(t("add_location_title"), (m, close) => {
    m.appendChild(el("p", "meta", t("add_location_body")));
    const path = el("input");
    path.placeholder = t("add_location_path");
    m.appendChild(path);
    const name = el("input");
    name.placeholder = t("add_location_name");
    m.appendChild(name);
    const err = el("div", "meta");
    err.style.color = "var(--err)";
    m.appendChild(err);
    const actions = el("div", "modal-actions");
    const cancel = el("button", "", t("cancel"));
    cancel.onclick = close;
    const go = el("button", "primary", t("add_and_index"));
    go.onclick = async () => {
      try {
        await client.locations.create(
          {path: path.value, name: name.value || null}, state.lib);
        close();
        toast(t("location_added"), {kind: "ok"});
        bus.refreshNav?.();
      } catch (e) {
        err.textContent = e.message;
      }
    };
    actions.appendChild(cancel); actions.appendChild(go);
    m.appendChild(actions);
    path.focus();
  });
}

export function createLibraryModal() {
  openDialog(t("new_library_title"), (m, close) => {
    const name = el("input");
    name.placeholder = t("library_name_placeholder");
    m.appendChild(name);
    const actions = el("div", "modal-actions");
    const cancel = el("button", "", t("cancel"));
    cancel.onclick = close;
    const go = el("button", "primary", t("create"));
    go.onclick = async () => {
      if (!name.value) return;
      await client.library.create({name: name.value});
      close();
      bus.reloadLibraries?.();
    };
    actions.appendChild(cancel); actions.appendChild(go);
    m.appendChild(actions);
    name.focus();
  });
}

export function wireSettingsPanel() {
  $("btn-settings").onclick = () => {
    const p = $("settings-panel");
    $("jobs-panel").classList.remove("open");
    $("drop-panel").classList.remove("open");
    p.classList.toggle("open");
    if (p.classList.contains("open")) renderSettings();
  };
}
