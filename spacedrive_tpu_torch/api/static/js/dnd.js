// Drag-and-drop file moves: drag the selection onto a folder card/row,
// a breadcrumb segment, or a sidebar location → files.cutFiles (role
// parity: ref:interface/app/$libraryId/Explorer/useExplorerDnd.tsx,
// DragOverlay.tsx, ExplorerDroppable.tsx over core/src/object/fs/cut).

import client from "/rspc/client.js";
import { bus, state } from "/static/js/util.js";
import { toast } from "/static/js/ui.js";

let drag = null; // {ids, dirPaths, location_id} — the in-flight drag payload

const dirPath = (n) => (n.materialized_path || "/") + n.name + "/";

/** make an item row/card draggable; dragging a selected item drags the
 *  whole (same-location) selection, like the reference's drag overlay */
export function draggable(elem, n) {
  elem.draggable = true;
  elem.addEventListener("dragstart", (e) => {
    const multi = state.selectedIds.has(n.id) && state.selectedIds.size > 1;
    const chosen = multi
      ? state.nodes.filter((x) => state.selectedIds.has(x.id) &&
                                  x.location_id === n.location_id)
      : [n];
    drag = {
      ids: chosen.map((x) => x.id),
      // dragged DIR paths: a dir must never land in its own subtree
      dirPaths: chosen.filter((x) => x.is_dir).map(dirPath),
      location_id: n.location_id,
    };
    e.dataTransfer.effectAllowed = "move";
    e.dataTransfer.setData("text/plain", String(n.id)); // firefox requires data
  });
  elem.addEventListener("dragend", () => { drag = null; });
}

/** register a drop target; `targetFn` returns {location_id, path} or
 *  null when the current drag must not land here (e.g. a folder onto
 *  itself) */
export function droppable(elem, targetFn) {
  elem.addEventListener("dragover", (e) => {
    if (!drag || !targetFn()) return;
    e.preventDefault();
    e.dataTransfer.dropEffect = "move";
    elem.classList.add("drop-ok");
  });
  elem.addEventListener("dragleave", () => elem.classList.remove("drop-ok"));
  elem.addEventListener("drop", async (e) => {
    e.preventDefault();
    elem.classList.remove("drop-ok");
    const target = drag && targetFn();
    if (!target) return;
    const src = drag;
    drag = null;
    try {
      await client.files.cutFiles({
        source_location_id: src.location_id,
        target_location_id: target.location_id,
        sources_file_path_ids: src.ids,
        target_relative_path: target.path,
      }, state.lib);
      toast(`moved ${src.ids.length} item(s)`, {kind: "ok"});
      bus.loadContent(true);
    } catch (err) {
      toast("✗ move: " + err.message, {kind: "error"});
    }
  });
}

/** {location_id, path} if the current drag may land there, else null —
 *  a folder can't be dropped into itself or any of its descendants
 *  (recursive search listings render both in one view) */
export function guardTarget(location_id, path) {
  if (!drag) return null;
  if (drag.location_id === location_id &&
      drag.dirPaths.some((p) => path.startsWith(p))) return null;
  return { location_id, path };
}

/** drop target for a directory NODE in the listing */
export function dirTarget(n) {
  return () => {
    if (!drag || drag.ids.includes(n.id)) return null;
    return guardTarget(n.location_id, dirPath(n));
  };
}