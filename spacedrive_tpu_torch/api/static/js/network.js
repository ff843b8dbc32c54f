// Network page: who's discovered/connected on the mesh, pair action,
// and the node's WAN path telemetry (punched-direct vs relayed).
// Role parity: ref:interface/app/$libraryId/network.tsx (peer grid)
// plus the reference's p2p debug surface.

import client from "/rspc/client.js";
import { $, el, state } from "/static/js/util.js";
import { toast } from "/static/js/ui.js";
import { t } from "/static/js/i18n.js";

export async function loadNetwork() {
  const c = $("content");
  c.className = "";
  c.innerHTML = "";
  const st = await client.p2p.state();
  if (!st.enabled) {
    c.appendChild(el("div", "meta", t("p2p_disabled")));
    return;
  }
  const head = el("div", "dupgroup");
  head.appendChild(el("b", "", t("this_node")));
  head.appendChild(el("div", "meta", `${t("identity")}: ${st.identity}`));
  head.appendChild(el("div", "meta", `${t("p2p_port")}: ${st.port}`));
  if (st.punch) {
    // path-selection telemetry: how dials actually went out
    head.appendChild(el("div", "meta",
      `${t("wan_paths")}: ${st.punch.direct} ${t("path_direct")} · ` +
      `${st.punch.fallback} ${t("path_relayed")}`));
  }
  c.appendChild(head);

  if (!st.peers.length) {
    c.appendChild(el("div", "meta", t("no_peers")));
    return;
  }
  for (const p of st.peers) {
    const box = el("div", "dupgroup");
    box.dataset.peer = p.identity;
    const title = el("b", "", p.metadata.name || p.identity.slice(0, 16));
    box.appendChild(title);
    const badge = el("span", "badge " + (p.connected ? "ok" : ""),
      p.connected ? t("peer_connected") : t("peer_discovered"));
    badge.style.marginLeft = "8px";
    title.appendChild(badge);
    box.appendChild(el("div", "meta", p.identity));
    if (p.addrs.length)
      box.appendChild(el("div", "meta", p.addrs.join("  ")));
    const os = p.metadata.operating_system || p.metadata.os;
    if (os) box.appendChild(el("div", "meta", os));
    const pair = el("button", "mini", t("pair_with_peer"));
    pair.onclick = async () => {
      try {
        await client.p2p.pairLibrary({identity: p.identity});
        toast(t("pair_requested"), {kind: "ok"});
      } catch (e) {
        toast(`${t("pair_failed")}: ${e.message}`, {kind: "error"});
      }
    };
    box.appendChild(pair);
    c.appendChild(box);
  }
}
