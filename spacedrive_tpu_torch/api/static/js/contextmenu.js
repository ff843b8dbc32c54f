// Right-click context menu: rename, delete, copy/cut/paste, validate
// (role parity: ref:interface Explorer ContextMenu over the files.*
// jobs — core/src/object/fs). Menu/dialog/toast primitives come from
// the ui kit (ui.js), matching ref:packages/ui/src/ContextMenu.tsx.

import client from "/rspc/client.js";
import { $, bus, el, fullPath, state } from "/static/js/util.js";
import {
  confirmDialog, initMenus, openDialog, openMenu, promptDialog, toast,
} from "/static/js/ui.js";
import { t } from "/static/js/i18n.js";

let clipboard = null;  // {op, ids, location_id, lib} — lib-scoped:
// file_path ids are per-library, so a stale clipboard must never
// paste across a library switch

function pasteItem() {
  if (clipboard && clipboard.lib !== state.lib) clipboard = null;
  if (!clipboard || !state.loc || state.mode !== "browse") return null;
  return {
    label: t("menu_paste"),
    onClick: async () => {
      const arg = {
        source_location_id: clipboard.location_id,
        target_location_id: state.loc,
        sources_file_path_ids: clipboard.ids,
        target_relative_path: state.path,
      };
      await (clipboard.op === "cut"
        ? client.files.cutFiles(arg, state.lib)
        : client.files.copyFiles(arg, state.lib));
      if (clipboard.op === "cut") clipboard = null;
    },
  };
}

// Tag assignment from the item menu (ref:interface Explorer
// ContextMenu AssignTagMenuItems): checkbox per tag, immediate
// assign/unassign over tags.assign, plus inline new-tag creation.
async function tagsDialog(chosen) {
  const objIds = [...new Set(chosen.map(x => x.object_id).filter(Boolean))];
  if (!objIds.length) { toast(t("tags_need_identify"), {kind: "info"}); return; }
  // per-object tag sets: a multi-selection renders checked only when
  // EVERY object carries the tag, indeterminate when some do —
  // toggling from indeterminate assigns to all (never blind-unassigns
  // from objects whose state the checkbox didn't show)
  const perObject = await Promise.all(objIds.map(async (oid) =>
    new Set((await client.tags.getForObject(oid, state.lib))
      .nodes.map(tg => tg.id))));
  const countFor = (tagId) =>
    perObject.reduce((s, set) => s + (set.has(tagId) ? 1 : 0), 0);
  openDialog(t("assign_tags_title"), (m, close) => {
    const list = el("div");
    const row = (tag) => {
      const lab = el("label", "row");
      const cb = el("input");
      cb.type = "checkbox";
      const cnt = countFor(tag.id);
      cb.checked = cnt === objIds.length && cnt > 0;
      cb.indeterminate = cnt > 0 && cnt < objIds.length;
      cb.onchange = async () => {
        const assign = cb.checked || cb.indeterminate;
        cb.indeterminate = false;
        cb.checked = assign;
        await client.tags.assign({tag_id: tag.id, object_ids: objIds,
                                  unassign: !assign}, state.lib);
        for (const set of perObject)
          assign ? set.add(tag.id) : set.delete(tag.id);
        toast(assign ? t("tag_assigned", {name: tag.name})
                     : t("tag_unassigned", {name: tag.name}),
              {kind: "ok"});
      };
      lab.appendChild(cb);
      lab.appendChild(el("span", "", " 🏷️ " + (tag.name || "?")));
      return lab;
    };
    for (const tag of state.allTags) list.appendChild(row(tag));
    if (!state.allTags.length)
      list.appendChild(el("p", "meta", t("no_tags_yet")));
    m.appendChild(list);
    const mk = el("div", "row");
    const name = el("input");
    name.placeholder = t("new_tag_placeholder");
    const add = el("button", "mini", "+");
    add.onclick = async () => {
      if (!name.value.trim()) return;
      const createdId = await client.tags.create(
        {name: name.value.trim()}, state.lib);
      const created = {id: createdId, name: name.value.trim()};
      await client.tags.assign(
        {tag_id: created.id, object_ids: objIds}, state.lib);
      state.allTags.push(created);
      list.appendChild(row(created));
      const cb = list.lastChild.querySelector("input");
      cb.checked = true;
      name.value = "";
      bus.refreshNav();
    };
    name.onkeydown = (e) => { if (e.key === "Enter") add.onclick(); };
    mk.appendChild(name);
    mk.appendChild(add);
    m.appendChild(mk);
  });
}

// Batch rename (ref:interface Explorer RenameDialog multi form):
// pattern with {n} (counter) and {name} (old stem); extensions are
// preserved; a live preview shows the first few results before apply.
function batchRenameDialog(chosen, refresh) {
  openDialog(t("batch_rename_title", {n: chosen.length}), (m, close) => {
    m.appendChild(el("p", "meta", t("batch_rename_body")));
    const pat = el("input");
    pat.value = "{name}";
    pat.style.width = "100%";
    const preview = el("p", "meta");
    const names = () => chosen.map((x, i) =>
      pat.value.replaceAll("{n}", String(i + 1))
               .replaceAll("{name}", x.name)
      + (x.extension ? "." + x.extension : ""));
    const update = () => {
      preview.textContent =
        names().slice(0, 3).join(" · ") + (chosen.length > 3 ? " …" : "");
    };
    pat.oninput = update;
    update();
    const go = el("button", "", t("rename"));
    go.onclick = async () => {
      const out = names();
      if (new Set(out).size !== out.length) {
        toast(t("batch_rename_collision"), {kind: "error"});
        return;
      }
      // sequential with an honest partial-failure report: a target
      // that already exists (400) must not abort silently mid-batch
      let done = 0;
      let firstErr = null;
      for (let i = 0; i < chosen.length; i++) {
        try {
          await client.files.renameFile(
            {id: chosen[i].id, new_name: out[i]}, state.lib);
          done++;
        } catch (e) {
          firstErr = firstErr || e;
        }
      }
      if (firstErr) {
        toast(t("batch_rename_partial",
                {done, n: chosen.length, error: firstErr.message}),
              {kind: "error"});
      } else {
        toast(t("batch_renamed_toast", {n: chosen.length}), {kind: "ok"});
      }
      close();
      refresh();
    };
    m.appendChild(pat);
    m.appendChild(preview);
    m.appendChild(go);
  });
}

// Context menu for NON-INDEXED rows (ref:core/src/api/ephemeral_files.rs
// over the ephemeral.tsx menu): rename/delete on raw paths — the
// db-backed affordances (tags, copy jobs, validate) don't apply.
export function showEphemeralMenu(x, y, n) {
  const refresh = () => bus.loadContent(true);
  const displayName = n.name + (n.extension ? "." + n.extension : "");
  // delete covers the whole selection (deleteFiles takes a batch);
  // rename is single-item by nature
  const chosen = state.selectedIds.has(n.id) && state.selectedIds.size > 1
    ? state.nodes.filter(x => state.selectedIds.has(x.id)) : [n];
  const many = chosen.length > 1;
  openMenu(x, y, [
    {
      label: t("menu_rename"),
      onClick: async () => {
        const name = await promptDialog(t("rename_title"), {
          value: displayName, actionLabel: t("rename"),
        });
        if (!name) return;
        try {
          await client.ephemeralFiles.renameFile(
            {path: n.path, new_name: name});
          refresh();
        } catch (e) { toast(e.message, {kind: "error"}); }
      },
    },
    {separator: true},
    {
      label: many
        ? t("menu_n_items", {verb: t("menu_delete"), n: chosen.length})
        : t("menu_delete"),
      danger: true,
      onClick: async () => {
        const what = many ? t("n_items", {n: chosen.length})
                          : `“${displayName}”`;
        const ok = await confirmDialog(t("delete_confirm_title"),
          t("eph_delete_body", {what}),
          {danger: true, actionLabel: t("delete")});
        if (!ok) return;
        try {
          const res = await client.ephemeralFiles.deleteFiles(
            {paths: chosen.map(x => x.path)});
          if (res.errors?.length)
            toast(res.errors[0], {kind: "error"});
          refresh();
        } catch (e) { toast(e.message, {kind: "error"}); }
      },
    },
  ]);
}

/** Empty-space menu in ephemeral mode: new folder in the current dir. */
export function showEphemeralBackgroundMenu(x, y) {
  openMenu(x, y, [
    {
      label: t("menu_new_folder"),
      onClick: async () => {
        const name = await promptDialog(t("new_folder_title"), {
          value: t("new_folder_default"), actionLabel: t("create"),
        });
        if (!name) return;
        try {
          await client.ephemeralFiles.createFolder(
            {path: state.ephPath, name});
          bus.loadContent(true);
        } catch (e) { toast(e.message, {kind: "error"}); }
      },
    },
  ]);
}

export function showMenu(x, y, n) {
  const refresh = () => bus.loadContent(true);
  // when the clicked item is part of a multi-selection, batch ops
  // cover the whole selection (same location only — the jobs are
  // per-location like the reference's)
  const multi = state.selectedIds.has(n.id) && state.selectedIds.size > 1;
  // file jobs are per-location; spacedrop is path-based and takes the
  // WHOLE selection regardless of location
  const chosenAll = multi
    ? state.nodes.filter(x => state.selectedIds.has(x.id)) : [n];
  const chosen = chosenAll.filter(x => x.location_id === n.location_id);
  const many = chosen.length > 1;
  const label = (verb) => many ? t("menu_n_items", {verb, n: chosen.length}) : verb;
  const displayName = n.name + (n.extension ? "." + n.extension : "");

  openMenu(x, y, [
    many ? {
      label: t("menu_batch_rename", {n: chosen.length}),
      onClick: () => batchRenameDialog(chosen, refresh),
    } : {
      label: t("menu_rename"),
      onClick: async () => {
        const name = await promptDialog(t("rename_title"), {
          value: displayName, actionLabel: t("rename"),
        });
        if (!name) return;
        await client.files.renameFile({id: n.id, new_name: name}, state.lib);
        refresh();
      },
    },
    {
      label: label(t("menu_tags")),
      onClick: () => tagsDialog(chosen),
    },
    {
      label: label(t("menu_copy")),
      onClick: () => {
        clipboard = {op: "copy", ids: chosen.map(x => x.id),
                     location_id: n.location_id, lib: state.lib};
        toast(t("copied_items", {n: chosen.length}));
      },
    },
    {
      label: label(t("menu_cut")),
      onClick: () => {
        clipboard = {op: "cut", ids: chosen.map(x => x.id),
                     location_id: n.location_id, lib: state.lib};
        toast(t("cut_items", {n: chosen.length}));
      },
    },
    pasteItem(),
    {separator: true},
    // scoped to the file's folder — a bare location_id would checksum
    // the whole location from a per-file menu item
    n.is_dir ? null : {
      label: t("menu_validate"),
      onClick: () => client.files.validate({
        location_id: n.location_id,
        sub_path: n.materialized_path || "/",
      }, state.lib),
    },
    {
      label: chosenAll.length > 1
        ? `📡 Spacedrop ${chosenAll.length} items` : "📡 Spacedrop",
      onClick: () => bus.openDropPanel(chosenAll.map(fullPath)),
    },
    {separator: true},
    {
      label: label(t("menu_delete")),
      danger: true,
      onClick: async () => {
        const what = many ? t("n_items", {n: chosen.length}) : `“${displayName}”`;
        const ok = await confirmDialog(t("delete_confirm_title"),
          t("delete_confirm_body", {what}),
          {danger: true, actionLabel: t("delete")});
        if (!ok) return;
        await client.files.deleteFiles(
          {location_id: n.location_id,
           file_path_ids: chosen.map(x => x.id)}, state.lib);
      },
    },
  ]);
}

/** Menu for empty space: paste into the current folder. */
export function showBackgroundMenu(x, y) {
  const paste = pasteItem();
  if (paste) openMenu(x, y, [paste]);
}

export function wireContextMenu() {
  initMenus();  // click-outside + capture-phase Escape dismissal
  $("content").addEventListener("contextmenu", (e) => {
    if (e.target.closest(".card, tr[data-fp]")) return;  // item menus
    e.preventDefault();
    if (state.mode === "ephemeral")
      showEphemeralBackgroundMenu(e.clientX, e.clientY);
    else showBackgroundMenu(e.clientX, e.clientY);
  });
}
