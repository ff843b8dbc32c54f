// Onboarding: first-run library creation + first location
// (role parity: ref:interface/app/onboarding).

import client from "/rspc/client.js";
import { $, bus, el } from "/static/js/util.js";
import { t } from "/static/js/i18n.js";

export function showOnboarding() {
  const board = $("onboard");
  board.classList.add("open");
  const box = board.querySelector(".box");
  box.innerHTML = "";
  box.appendChild(el("h1", "", ""));
  box.querySelector("h1").innerHTML = "Welcome to <b>spacedrive-tpu</b>";
  box.appendChild(el("p", "", t("onboard_intro")));
  const name = el("input");
  name.placeholder = t("library_name_placeholder");
  name.value = t("onboard_default_name");
  box.appendChild(name);
  const path = el("input");
  path.placeholder = t("onboard_first_location");
  box.appendChild(path);
  const err = el("div", "meta");
  err.style.color = "var(--err)";
  box.appendChild(err);
  const actions = el("div", "modal-actions");
  const go = el("button", "primary", t("onboard_create"));
  go.onclick = async () => {
    if (!name.value) { err.textContent = t("onboard_name_required"); return; }
    go.disabled = true;
    try {
      const lib = await client.library.create({name: name.value});
      if (path.value) {
        await client.locations.create({path: path.value}, lib.uuid);
      }
      board.classList.remove("open");
      await bus.reloadLibraries?.();
    } catch (e) {
      err.textContent = e.message;
      go.disabled = false;
    }
  };
  actions.appendChild(go);
  box.appendChild(actions);
  name.focus();
}
