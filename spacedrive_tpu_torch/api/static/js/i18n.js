// i18n — string catalog + DOM application (role parity:
// ref:interface/locales/* via i18next; here a dependency-free loader).
//
// Catalogs live at /static/i18n/<locale>.json (flat key → string with
// {param} slots). The active locale comes from localStorage("sd-lang")
// or the browser language, falling back to English key-by-key so a
// partially translated catalog never blanks the UI.
//
// Static DOM: elements carry data-i18n="key" (textContent),
// data-i18n-placeholder / data-i18n-tip for attributes; applyDom()
// rewrites them. Dynamic strings: modules import t().

export const LOCALES = {
  en: "English", de: "Deutsch", es: "Español", fr: "Français",
  it: "Italiano", nl: "Nederlands", ru: "Русский", tr: "Türkçe",
  be: "Беларуская", "zh-CN": "中文（简体）", "zh-TW": "中文（繁體）",
};

let catalog = {};
let fallback = {};
let current = "en";

export function locale() {
  return current;
}

function pick() {
  const saved = localStorage.getItem("sd-lang");
  if (saved && LOCALES[saved]) return saved;
  const nav = navigator.language || "en";
  if (LOCALES[nav]) return nav;
  const short = nav.split("-")[0];
  if (LOCALES[short]) return short;
  // base-language match: zh / zh-Hans-CN / zh-SG → first zh-* catalog
  // (Traditional-script tags prefer zh-TW)
  if (short === "zh") {
    return /hant|tw|hk|mo/i.test(nav) ? "zh-TW" : "zh-CN";
  }
  const prefix = Object.keys(LOCALES).find(l => l.startsWith(short + "-"));
  return prefix || "en";
}

async function fetchCatalog(loc) {
  const resp = await fetch(`/static/i18n/${loc}.json`);
  if (!resp.ok) throw new Error(`no catalog for ${loc}`);
  return resp.json();
}

export async function initI18n() {
  current = pick();
  // both fetches are boot-blocking — run them concurrently
  const [en, cat] = await Promise.all([
    fetchCatalog("en").catch(() => ({})),
    current === "en" ? null : fetchCatalog(current).catch(() => null),
  ]);
  fallback = en;
  catalog = cat || en;
  applyDom(document);
  document.documentElement.lang = current;
}

/** Translate `key`, interpolating {name} params; falls back to English,
 *  then to the key itself (visible = greppable, never blank). */
export function t(key, params) {
  let s = catalog[key] ?? fallback[key] ?? key;
  if (params) {
    for (const [k, v] of Object.entries(params)) {
      // function form: "$&"-style patterns in values must stay literal
      s = s.replaceAll(`{${k}}`, () => String(v));
    }
  }
  return s;
}

export function applyDom(root) {
  root.querySelectorAll("[data-i18n]").forEach((el) => {
    el.textContent = t(el.getAttribute("data-i18n"));
  });
  root.querySelectorAll("[data-i18n-placeholder]").forEach((el) => {
    el.placeholder = t(el.getAttribute("data-i18n-placeholder"));
  });
  root.querySelectorAll("[data-i18n-tip]").forEach((el) => {
    el.setAttribute("data-tip", t(el.getAttribute("data-i18n-tip")));
  });
}

/** Persist the choice and reload — every module re-renders from the
 *  new catalog (the reference also reloads routes on language switch). */
export function setLocale(loc) {
  if (!LOCALES[loc]) return;
  localStorage.setItem("sd-lang", loc);
  location.reload();
}
