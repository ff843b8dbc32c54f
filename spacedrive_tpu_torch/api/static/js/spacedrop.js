// Spacedrop panel: peer list, staged sends, incoming offer modal
// (role parity: ref:core/src/p2p/operations/spacedrop.rs UI flow).

import client from "/rspc/client.js";
import { $, el, fmtBytes } from "/static/js/util.js";
import { openDialog, toast } from "/static/js/ui.js";
import { t } from "/static/js/i18n.js";

let dropQueue = [];  // file paths staged for sending

export async function openDropPanel(paths) {
  if (paths) dropQueue = paths;
  $("jobs-panel").classList.remove("open");
  $("settings-panel").classList.remove("open");
  const p = $("drop-panel");
  p.classList.add("open");
  const st = await client.p2p.state();
  $("drop-self").textContent = st.enabled
    ? `this node: ${st.identity.slice(0, 20)}…` : "p2p disabled";
  $("drop-status").textContent = dropQueue.length
    ? t("drop_ready", {files: dropQueue.map(x => x.split("/").pop()).join(", ")})
    : t("drop_hint");
  const peers = $("peers");
  peers.innerHTML = "";
  for (const peer of st.peers || []) {
    const row = el("div", "peer");
    const label = el("div", "",
      `${peer.metadata?.name || "node"} · ${peer.identity.slice(0, 16)}…` +
      (peer.connected ? " ✓" : ""));
    row.appendChild(label);
    const send = el("button", dropQueue.length ? "primary" : "", t("send"));
    send.disabled = !dropQueue.length;
    send.onclick = async () => {
      try {
        $("drop-status").textContent = t("drop_sending");
        await client.p2p.spacedrop(
          {identity: peer.identity, file_paths: dropQueue});
        $("drop-status").textContent = t("drop_sent");
        toast(t("drop_sent_toast"), {kind: "ok"});
        dropQueue = [];
      } catch (e) {
        $("drop-status").textContent = "✗ " + e.message;
        toast("✗ spacedrop: " + e.message, {kind: "error"});
      }
    };
    row.appendChild(send);
    peers.appendChild(row);
  }
  if (!(st.peers || []).length)
    peers.appendChild(el("div", "meta", t("no_peers")));
}

let pendingOffer = null;  // {id, close} — offer currently dialogued
let offerQueue = [];      // further offers wait their turn — one
// sticky dialog at a time, so Escape always maps to THE visible offer

/** Escape on a pending offer = explicit reject (a dismissed dialog
 *  would strand the sender). Returns true if an offer was handled. */
export function rejectPendingOffer() {
  if (pendingOffer == null) return false;
  const {id, close} = pendingOffer;
  settleOffer(id);
  client.p2p.rejectSpacedrop(id).catch(() => {});
  close();
  return true;
}

/** Clear pending state for offer `id` (and only it) and surface the
 *  next queued offer, if any. */
function settleOffer(id) {
  if (pendingOffer?.id !== id) return;
  pendingOffer = null;
  const next = offerQueue.shift();
  if (next) showDropOffer(next);
}

export function showDropOffer(ev) {
  if (pendingOffer) { offerQueue.push(ev); return; }
  // sticky: the dialog's own Escape/backdrop dismissal is disabled —
  // the global Escape handler routes to rejectPendingOffer instead
  const close = openDialog(t("incoming_spacedrop"), (m, closeDlg) => {
    m.appendChild(el("div", "meta", t("from_peer", {peer: ev.peer.slice(0, 24)})));
    const list = el("div");
    list.style.margin = "8px 0";
    for (const f of ev.files) list.appendChild(el("div", "", "• " + f));
    m.appendChild(list);
    m.appendChild(el("div", "meta", fmtBytes(ev.total_size)));
    const dir = el("input");
    dir.placeholder = t("target_dir_placeholder");
    m.appendChild(dir);
    const actions = el("div", "modal-actions");
    const reject = el("button", "danger", t("reject"));
    reject.onclick = async () => {
      closeDlg();
      settleOffer(ev.id);
      await client.p2p.rejectSpacedrop(ev.id);
    };
    const accept = el("button", "primary", t("accept"));
    accept.onclick = async () => {
      closeDlg();
      settleOffer(ev.id);
      await client.p2p.acceptSpacedrop(
        {id: ev.id, target_dir: dir.value || null});
      toast(t("drop_accepted_toast"), {kind: "ok"});
    };
    actions.appendChild(reject); actions.appendChild(accept);
    m.appendChild(actions);
  }, {sticky: true});
  pendingOffer = {id: ev.id, close};
}

export function wireDropPanel() {
  $("btn-drop").onclick = () => {
    const p = $("drop-panel");
    if (p.classList.contains("open")) p.classList.remove("open");
    else openDropPanel();
  };
}
