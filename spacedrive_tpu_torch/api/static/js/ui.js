// ui.js — behavioral component kit (role parity: ref:packages/ui, the
// reference's React primitives: Dropdown.tsx, DropdownMenu.tsx,
// Dialog.tsx, Toast.tsx, Tooltip.tsx, Tabs.tsx, ContextMenu.tsx).
//
// Dependency-free ES module consumed by the explorer modules; class
// contract + tokens documented in docs/ui.md, styles in ui.css.
// Everything here is accessible by construction: dialogs trap focus
// and restore it on close, menus are keyboard-navigable with ARIA
// roles, toasts announce via role=status, tooltips show on focus as
// well as hover.

import { el } from "/static/js/util.js";
import { t } from "/static/js/i18n.js";

// --- Dialog (ref:packages/ui/src/Dialog.tsx) -------------------------------

const FOCUSABLE =
  'button, [href], input, select, textarea, [tabindex]:not([tabindex="-1"])';

let dialogStack = [];

/** Open a modal dialog. `build(body, close)` fills the body; returns
 *  close(). Focus is trapped inside while open and restored to the
 *  previously focused element on close. Escape closes unless
 *  opts.sticky. */
export function openDialog(title, build, opts = {}) {
  const prev = document.activeElement;
  const back = el("div", "dlg-back open");
  const dlg = el("div", "dlg");
  dlg.setAttribute("role", "dialog");
  dlg.setAttribute("aria-modal", "true");
  if (title) {
    const h = el("h2", "", title);
    dlg.appendChild(h);
  }
  back.appendChild(dlg);

  let closed = false;
  const close = () => {
    if (closed) return;
    closed = true;
    back.remove();
    document.removeEventListener("keydown", onKey, true);
    dialogStack = dialogStack.filter(d => d !== back);
    prev?.focus?.();
    opts.onClose?.();  // fires exactly once on ANY close path
  };

  const onKey = (e) => {
    if (dialogStack[dialogStack.length - 1] !== back) return;
    if (e.key === "Escape" && !opts.sticky) {
      e.stopPropagation();
      close();
    } else if (e.key === "Tab") {
      // focus trap: cycle within the dialog; if focus escaped (e.g.
      // backdrop click on a sticky dialog), pull it back in
      const focusables = [...dlg.querySelectorAll(FOCUSABLE)]
        .filter(n => !n.disabled && n.offsetParent !== null);
      if (!focusables.length) { e.preventDefault(); return; }
      const first = focusables[0], last = focusables[focusables.length - 1];
      const inside = dlg.contains(document.activeElement);
      if (!inside) {
        e.preventDefault(); (e.shiftKey ? last : first).focus();
      } else if (e.shiftKey && document.activeElement === first) {
        e.preventDefault(); last.focus();
      } else if (!e.shiftKey && document.activeElement === last) {
        e.preventDefault(); first.focus();
      }
    }
  };

  back.addEventListener("mousedown", (e) => {
    if (e.target === back && !opts.sticky) close();
  });
  document.addEventListener("keydown", onKey, true);
  build(dlg, close);
  document.body.appendChild(back);
  dialogStack.push(back);
  // initial focus: first focusable in the body, else the dialog itself
  const first = dlg.querySelector(FOCUSABLE);
  (first || dlg).focus?.();
  return close;
}

/** Confirm dialog helper: resolves true (confirmed) / false. */
export function confirmDialog(title, message, opts = {}) {
  return new Promise((resolve) => {
    let result = false;
    openDialog(title, (m, close) => {
      if (message) m.appendChild(el("p", "meta", message));
      const actions = el("div", "modal-actions");
      const cancel = el("button", "", opts.cancelLabel || t("cancel"));
      cancel.onclick = close;
      const go = el("button", opts.danger ? "danger" : "primary",
                    opts.actionLabel || t("ok"));
      go.onclick = () => { result = true; close(); };
      actions.appendChild(cancel);
      actions.appendChild(go);
      m.appendChild(actions);
    }, { onClose: () => resolve(result) });  // Escape/backdrop ⇒ false
  });
}

/** Single-input dialog (Dialog + Input pattern): resolves the entered
 *  string, or null on cancel. */
export function promptDialog(title, opts = {}) {
  return new Promise((resolve) => {
    let result = null;
    openDialog(title, (m, close) => {
      if (opts.message) m.appendChild(el("p", "meta", opts.message));
      const input = el("input");
      input.value = opts.value || "";
      input.placeholder = opts.placeholder || "";
      m.appendChild(input);
      const done = () => { result = input.value; close(); };
      input.addEventListener("keydown", (e) => {
        if (e.key === "Enter") done();
      });
      const actions = el("div", "modal-actions");
      const cancel = el("button", "", t("cancel"));
      cancel.onclick = close;
      const go = el("button", "primary", opts.actionLabel || t("ok"));
      go.onclick = done;
      actions.appendChild(cancel);
      actions.appendChild(go);
      m.appendChild(actions);
      input.focus();
      input.select();
    }, { onClose: () => resolve(result) });  // Escape/backdrop ⇒ null
  });
}

// --- Menu / Dropdown (ref:packages/ui/src/{DropdownMenu,ContextMenu}.tsx) --

let openMenuEl = null;

export function closeMenu() {
  openMenuEl?.remove();
  openMenuEl = null;
}

/** Show a floating menu at (x, y). Items:
 *    {label, onClick, danger?, disabled?} | {separator: true}
 *  Keyboard: arrows/Home/End move, Enter/Space activate, Escape
 *  closes. Click-outside dismisses (wired once in initMenus). */
export function openMenu(x, y, items) {
  closeMenu();
  const menu = el("div", "ctxmenu");
  menu.setAttribute("role", "menu");
  const itemEls = [];
  for (const it of items) {
    if (!it) continue;
    if (it.separator) {
      menu.appendChild(el("div", "ctx-sep"));
      continue;
    }
    const item = el("div",
      "ctx-item" + (it.danger ? " danger" : "") +
      (it.disabled ? " disabled" : ""), it.label);
    item.setAttribute("role", "menuitem");
    item.tabIndex = -1;
    if (!it.disabled) {
      item.onclick = async () => {
        closeMenu();
        try {
          await it.onClick?.();
        } catch (e) {
          toast("✗ " + e.message, { kind: "error" });
        }
      };
      itemEls.push(item);
    }
    menu.appendChild(item);
  }
  menu.addEventListener("keydown", (e) => {
    const idx = itemEls.indexOf(document.activeElement);
    const move = (to) =>
      itemEls[(to + itemEls.length) % itemEls.length]?.focus();
    if (e.key === "ArrowDown") { e.preventDefault(); move(idx + 1); }
    else if (e.key === "ArrowUp") { e.preventDefault(); move(idx - 1); }
    else if (e.key === "Home") { e.preventDefault(); move(0); }
    else if (e.key === "End") { e.preventDefault(); move(-1); }
    else if (e.key === "Enter" || e.key === " ") {
      e.preventDefault(); document.activeElement?.click?.();
    } else if (e.key === "Escape") { e.stopPropagation(); closeMenu(); }
  });
  document.body.appendChild(menu);
  // clamp into the viewport AFTER layout so real size is known
  const r = menu.getBoundingClientRect();
  menu.style.left = Math.min(x, innerWidth - r.width - 6) + "px";
  menu.style.top = Math.min(y, innerHeight - r.height - 6) + "px";
  openMenuEl = menu;
  itemEls[0]?.focus();
  return closeMenu;
}

/** Anchor a dropdown menu to a trigger element: opens below it on
 *  click. `itemsFn()` builds the items lazily per open. */
export function attachDropdown(trigger, itemsFn) {
  trigger.setAttribute("aria-haspopup", "menu");
  trigger.addEventListener("click", (e) => {
    e.stopPropagation();
    if (openMenuEl) { closeMenu(); return; }
    const r = trigger.getBoundingClientRect();
    openMenu(r.left, r.bottom + 4, itemsFn());
  });
}

/** Global dismiss wiring for menus (call once from app boot). */
export function initMenus() {
  document.addEventListener("click", closeMenu);
  document.addEventListener("keydown", (e) => {
    if (e.key === "Escape" && openMenuEl) {
      e.stopPropagation();
      closeMenu();
    }
  }, true);
}

// --- Toast (ref:packages/ui/src/Toast.tsx) ---------------------------------

/** Transient notification. kind: info | ok | error. Errors stay 6s,
 *  the rest 3s (or opts.timeout ms). */
export function toast(message, opts = {}) {
  let holder = document.getElementById("toasts");
  if (!holder) {
    holder = el("div");
    holder.id = "toasts";
    document.body.appendChild(holder);
  }
  const kind = opts.kind || "info";
  const t = el("div", `toast ${kind}`, message);
  t.setAttribute("role", "status");
  holder.appendChild(t);
  const ttl = opts.timeout ?? (kind === "error" ? 6000 : 3000);
  const gone = () => { t.classList.add("out"); setTimeout(() => t.remove(), 300); };
  const timer = setTimeout(gone, ttl);
  t.onclick = () => { clearTimeout(timer); gone(); };
  return t;
}

// --- Tooltip (ref:packages/ui/src/Tooltip.tsx) -----------------------------

let tipEl = null, tipTimer = null;

function showTip(target) {
  const text = target.getAttribute("data-tip");
  if (!text) return;
  hideTip();
  tipEl = el("div", "tooltip", text);
  document.body.appendChild(tipEl);
  const r = target.getBoundingClientRect();
  const tr = tipEl.getBoundingClientRect();
  tipEl.style.left =
    Math.max(4, Math.min(r.left + r.width / 2 - tr.width / 2,
                         innerWidth - tr.width - 4)) + "px";
  tipEl.style.top = (r.top > tr.height + 8
    ? r.top - tr.height - 6 : r.bottom + 6) + "px";
}

function hideTip() {
  clearTimeout(tipTimer);
  tipTimer = null;
  tipEl?.remove();
  tipEl = null;
}

/** Delegated tooltips: any element with `data-tip="…"` gets one on
 *  hover (400 ms delay) or keyboard focus (call once from app boot). */
export function initTooltips() {
  document.addEventListener("mouseover", (e) => {
    const t = e.target.closest?.("[data-tip]");
    if (!t) return;
    clearTimeout(tipTimer);
    tipTimer = setTimeout(() => showTip(t), 400);
  });
  document.addEventListener("mouseout", hideTip);
  document.addEventListener("focusin", (e) => {
    const t = e.target.closest?.("[data-tip]");
    if (t) showTip(t);
  });
  document.addEventListener("focusout", hideTip);
  document.addEventListener("mousedown", hideTip);
}

// --- Tabs (ref:packages/ui/src/Tabs.tsx) -----------------------------------

/** Build an accessible tab strip inside `root`.
 *  defs: [{id, label, render(body)}]. Arrow keys move between tabs;
 *  the active panel re-renders on switch. Returns {select(id)}. */
export function tabs(root, defs, opts = {}) {
  const strip = el("div", "tabs");
  strip.setAttribute("role", "tablist");
  const body = el("div", "tab-body");
  const btns = new Map();
  let generation = 0;

  const select = (id) => {
    for (const [bid, b] of btns) {
      b.classList.toggle("active", bid === id);
      b.setAttribute("aria-selected", bid === id ? "true" : "false");
      b.tabIndex = bid === id ? 0 : -1;
    }
    // async renders fill a detached node and only attach if still the
    // active generation — a slow tab must never leak rows into the
    // tab selected after it
    const gen = ++generation;
    const scratch = el("div");
    Promise.resolve(defs.find(d => d.id === id)?.render(scratch))
      .then(() => {
        if (gen !== generation) return;
        body.innerHTML = "";
        body.append(...scratch.childNodes);
      });
    opts.onSelect?.(id);
  };

  defs.forEach((d, i) => {
    const b = el("button", "tab", d.label);
    b.setAttribute("role", "tab");
    b.onclick = () => select(d.id);
    b.addEventListener("keydown", (e) => {
      const delta = e.key === "ArrowRight" ? 1 : e.key === "ArrowLeft" ? -1 : 0;
      if (!delta) return;
      e.preventDefault();
      const next = defs[(i + delta + defs.length) % defs.length];
      select(next.id);
      btns.get(next.id)?.focus();
    });
    btns.set(d.id, b);
    strip.appendChild(b);
  });

  root.appendChild(strip);
  root.appendChild(body);
  select(opts.initial || defs[0]?.id);
  return { select, body };
}
