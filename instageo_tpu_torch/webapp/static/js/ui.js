/* ui.js — tiny DOM toolkit: element builder, dialogs, drawers, snackbar,
 * sliders, selects. Replaces the reference's MUI components (Dialog,
 * Drawer, Snackbar, Slider...) with framework-free equivalents themed via
 * css/app.css variables. */

export function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "class") node.className = v;
    else if (k === "style" && typeof v === "object") Object.assign(node.style, v);
    else if (k.startsWith("on") && typeof v === "function") {
      node.addEventListener(k.slice(2).toLowerCase(), v);
    } else if (k === "dataset") Object.assign(node.dataset, v);
    else if (v !== null && v !== undefined) node.setAttribute(k, v);
  }
  for (const child of children.flat()) {
    if (child === null || child === undefined) continue;
    node.append(child.nodeType ? child : document.createTextNode(child));
  }
  return node;
}

export function svgIcon(path, size = 20) {
  const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
  svg.setAttribute("viewBox", "0 0 24 24");
  svg.setAttribute("width", size);
  svg.setAttribute("height", size);
  svg.setAttribute("fill", "currentColor");
  const p = document.createElementNS("http://www.w3.org/2000/svg", "path");
  p.setAttribute("d", path);
  svg.appendChild(p);
  return svg;
}

// Material-style icon paths (drawn from scratch against the 24px grid).
export const ICONS = {
  close: "M19 6.41 17.59 5 12 10.59 6.41 5 5 6.41 10.59 12 5 17.59 6.41 19 12 13.41 17.59 19 19 17.59 13.41 12z",
  analytics: "M19 3H5a2 2 0 0 0-2 2v14a2 2 0 0 0 2 2h14a2 2 0 0 0 2-2V5a2 2 0 0 0-2-2zM9 17H7v-7h2v7zm4 0h-2V7h2v10zm4 0h-2v-4h2v4z",
  list: "M3 13h2v-2H3v2zm0 4h2v-2H3v2zm0-8h2V7H3v2zm4 4h14v-2H7v2zm0 4h14v-2H7v2zM7 7v2h14V7H7z",
  dark: "M12 3a9 9 0 1 0 9 9c0-.46-.04-.92-.1-1.36a5.39 5.39 0 0 1-4.4 2.26 5.4 5.4 0 0 1-5.4-5.4c0-1.81.89-3.42 2.26-4.4A9.08 9.08 0 0 0 12 3z",
  light: "M12 7a5 5 0 1 0 0 10 5 5 0 0 0 0-10zM2 13h2a1 1 0 0 0 0-2H2a1 1 0 0 0 0 2zm18 0h2a1 1 0 0 0 0-2h-2a1 1 0 0 0 0 2zM11 2v2a1 1 0 0 0 2 0V2a1 1 0 0 0-2 0zm0 18v2a1 1 0 0 0 2 0v-2a1 1 0 0 0-2 0z",
  refresh: "M17.65 6.35A7.96 7.96 0 0 0 12 4a8 8 0 1 0 7.73 10h-2.08A6 6 0 1 1 12 6c1.66 0 3.14.69 4.22 1.78L13 11h7V4l-2.35 2.35z",
  locate: "M12 8a4 4 0 1 0 0 8 4 4 0 0 0 0-8zm8.94 3A8.99 8.99 0 0 0 13 3.06V1h-2v2.06A8.99 8.99 0 0 0 3.06 11H1v2h2.06A8.99 8.99 0 0 0 11 20.94V23h2v-2.06A8.99 8.99 0 0 0 20.94 13H23v-2h-2.06zM12 19a7 7 0 1 1 0-14 7 7 0 0 1 0 14z",
  layers: "m11.99 18.54-7.37-5.73L3 14.07l9 7 9-7-1.63-1.27-7.38 5.74zM12 16l7.36-5.73L21 9l-9-7-9 7 1.63 1.27L12 16z",
  delete: "M6 19a2 2 0 0 0 2 2h8a2 2 0 0 0 2-2V7H6v12zM19 4h-3.5l-1-1h-5l-1 1H5v2h14V4z",
  zoomIn: "M15.5 14h-.79l-.28-.27A6.47 6.47 0 0 0 16 9.5 6.5 6.5 0 1 0 9.5 16c1.61 0 3.09-.59 4.23-1.57l.27.28v.79l5 4.99L20.49 19l-4.99-5zm-6 0A4.5 4.5 0 1 1 14 9.5 4.49 4.49 0 0 1 9.5 14zM12 10h-2v2H9v-2H7V9h2V7h1v2h2v1z",
  eye: "M12 4.5C7 4.5 2.73 7.61 1 12c1.73 4.39 6 7.5 11 7.5s9.27-3.11 11-7.5c-1.73-4.39-6-7.5-11-7.5zM12 17a5 5 0 1 1 0-10 5 5 0 0 1 0 10zm0-8a3 3 0 1 0 0 6 3 3 0 0 0 0-6z",
  eyeOff: "M12 7a5 5 0 0 1 5 5c0 .65-.13 1.26-.36 1.83l2.92 2.92A11.8 11.8 0 0 0 23 12c-1.73-4.39-6-7.5-11-7.5-1.4 0-2.74.25-3.98.7l2.16 2.16C10.74 7.13 11.35 7 12 7zM2 4.27l2.28 2.28.46.46A11.8 11.8 0 0 0 1 12c1.73 4.39 6 7.5 11 7.5 1.55 0 3.03-.3 4.38-.84l.42.42L19.73 22 21 20.73 3.27 3 2 4.27zM7.53 9.8l1.55 1.55c-.05.21-.08.43-.08.65a3 3 0 0 0 3 3c.22 0 .44-.03.65-.08l1.55 1.55A4.98 4.98 0 0 1 7 12c0-.79.18-1.53.53-2.2z",
  pdf: "M20 2H8a2 2 0 0 0-2 2v12a2 2 0 0 0 2 2h12a2 2 0 0 0 2-2V4a2 2 0 0 0-2-2zm-8.5 7.5a1.5 1.5 0 0 1-1.5 1.5H9v2H7.5V7H10a1.5 1.5 0 0 1 1.5 1.5v1zm5 2a1.5 1.5 0 0 1-1.5 1.5h-2.5V7H15a1.5 1.5 0 0 1 1.5 1.5v3zm4-3H19v1h1.5V11H19v2h-1.5V7h3v1.5zM9 9.5h1v-1H9v1zM4 6H2v14a2 2 0 0 0 2 2h14v-2H4V6zm10 5.5h1v-3h-1v3z",
  expand: "M16.59 8.59 12 13.17 7.41 8.59 6 10l6 6 6-6z",
  collapse: "m12 8-6 6 1.41 1.41L12 10.83l4.59 4.58L18 14z",
  visibility: "M12 4.5C7 4.5 2.73 7.61 1 12c1.73 4.39 6 7.5 11 7.5s9.27-3.11 11-7.5c-1.73-4.39-6-7.5-11-7.5zM12 17a5 5 0 1 1 0-10 5 5 0 0 1 0 10z",
  info: "M11 7h2v2h-2zm0 4h2v6h-2zm1-9a10 10 0 1 0 0 20 10 10 0 0 0 0-20zm0 18a8 8 0 1 1 0-16 8 8 0 0 1 0 16z",
  check: "M9 16.17 4.83 12l-1.42 1.41L9 19 21 7l-1.41-1.41z",
  error: "M12 2a10 10 0 1 0 0 20 10 10 0 0 0 0-20zm1 15h-2v-2h2v2zm0-4h-2V7h2v6z",
  play: "M8 5v14l11-7z",
  schedule: "M11.99 2A10 10 0 1 0 22 12 10 10 0 0 0 11.99 2zM12 20a8 8 0 1 1 8-8 8 8 0 0 1-8 8zm.5-13H11v6l5.25 3.15.75-1.23-4.5-2.67z",
  pause: "M6 19h4V5H6v14zm8-14v14h4V5h-4z",
  map: "m20.5 3-.16.03L15 5.1 9 3 3.36 4.9c-.21.07-.36.25-.36.48V20.5c0 .28.22.5.5.5l.16-.03L9 18.9l6 2.1 5.64-1.9c.21-.07.36-.25.36-.48V3.5c0-.28-.22-.5-.5-.5zM15 19l-6-2.11V5l6 2.11V19z",
  download: "M19 9h-4V3H9v6H5l7 7 7-7zM5 18v2h14v-2H5z",
  person: "M12 12a4 4 0 1 0 0-8 4 4 0 0 0 0 8zm0 2c-2.67 0-8 1.34-8 4v2h16v-2c0-2.66-5.33-4-8-4z",
  help: "M11 18h2v-2h-2v2zm1-16a10 10 0 1 0 0 20 10 10 0 0 0 0-20zm0 18a8 8 0 1 1 0-16 8 8 0 0 1 0 16zm0-14a4 4 0 0 0-4 4h2a2 2 0 1 1 4 0c0 2-3 1.75-3 5h2c0-2.25 3-2.5 3-5a4 4 0 0 0-4-4z",
  login: "M11 7 9.6 8.4l2.6 2.6H2v2h10.2l-2.6 2.6L11 17l5-5-5-5zm9 12h-8v2h8a2 2 0 0 0 2-2V5a2 2 0 0 0-2-2h-8v2h8v14z",
  filter: "M10 18h4v-2h-4v2zM3 6v2h18V6H3zm3 7h12v-2H6v2z",
  search: "M15.5 14h-.79l-.28-.27A6.47 6.47 0 0 0 16 9.5 6.5 6.5 0 1 0 9.5 16c1.61 0 3.09-.59 4.23-1.57l.27.28v.79l5 4.99L20.49 19l-4.99-5zm-6 0A4.5 4.5 0 1 1 14 9.5 4.49 4.49 0 0 1 9.5 14z",
};

export function iconButton(iconName, title, onClick, cls = "") {
  const btn = el("button",
    { class: `icon-btn ${cls}`, title, "aria-label": title, onclick: onClick });
  btn.appendChild(svgIcon(ICONS[iconName] || ICONS.info));
  return btn;
}

// ---------------------------------------------------------------------------
// Dialog (modal)
// ---------------------------------------------------------------------------

export function openDialog({ title, content, actions = [], wide = false,
                             onClose = null, id = "" }) {
  const backdrop = el("div", { class: "dialog-backdrop", id });
  const close = () => {
    backdrop.remove();
    if (onClose) onClose();
  };
  const head = el("div", { class: "dialog-title" },
    el("span", {}, title),
    iconButton("close", "Close", close));
  const body = el("div", { class: "dialog-content" });
  if (content) body.append(content);
  const foot = el("div", { class: "dialog-actions" }, ...actions);
  const dialog = el("div",
    { class: `dialog ${wide ? "dialog-wide" : ""}`, role: "dialog" },
    head, body, foot);
  backdrop.addEventListener("click", (e) => {
    if (e.target === backdrop) close();
  });
  backdrop.append(dialog);
  document.body.append(backdrop);
  return { el: dialog, body, close };
}

// ---------------------------------------------------------------------------
// Snackbar (reference App.js Snackbar/Alert)
// ---------------------------------------------------------------------------

let _snackTimer = null;

export function showSnackbar(message, severity = "warning", ms = 4000) {
  let bar = document.getElementById("snackbar");
  if (!bar) {
    bar = el("div", { id: "snackbar" });
    document.body.append(bar);
  }
  bar.textContent = message;
  bar.className = `show ${severity}`;
  clearTimeout(_snackTimer);
  _snackTimer = setTimeout(() => { bar.className = ""; }, ms);
}

// ---------------------------------------------------------------------------
// Form controls
// ---------------------------------------------------------------------------

export function labeledSelect(label, options, value, onChange) {
  const select = el("select", { class: "input", onchange: (e) =>
    onChange(e.target.value) });
  for (const opt of options) {
    const o = el("option", { value: opt.value }, opt.label);
    if (opt.value === value) o.selected = true;
    select.append(o);
  }
  return el("div", { class: "field" },
    el("label", { class: "field-label" }, label), select);
}

export function slider({ label, min, max, step = 1, value, onChange,
                         helpText = null, onHelp = null }) {
  const valueSpan = el("span", { class: "slider-value" }, String(value));
  const input = el("input", {
    type: "range", min, max, step, value, class: "slider",
    oninput: (e) => {
      valueSpan.textContent = e.target.value;
      onChange(Number(e.target.value));
    },
  });
  const labelRow = el("div", { class: "slider-label-row" },
    el("span", {}, label,
       onHelp ? iconButton("info", "More info", onHelp, "inline") : null),
    el("span", { class: "slider-range" }, `${min} - ${max}`));
  const help = helpText
    ? el("div", { class: "param-help hidden" }, helpText)
    : null;
  const wrap = el("div", { class: "field slider-field" },
    labelRow, el("div", { class: "slider-row" }, input, valueSpan), help);
  if (help && onHelp === "toggle") {
    labelRow.querySelector(".icon-btn").onclick = () =>
      help.classList.toggle("hidden");
  }
  return wrap;
}

export function chip(text, color = null) {
  const c = el("span", { class: "chip" }, text);
  if (color) {
    c.style.background = color;
    c.style.color = "#fff";
  }
  return c;
}

export function progressBar(pct) {
  return el("div", { class: "progress" },
    el("div", { class: "progress-fill", style: { width: `${pct}%` } }));
}

export function spinner(size = 24) {
  return el("div", {
    class: "spinner",
    style: { width: `${size}px`, height: `${size}px` },
  });
}

export function formatDate(dateInput) {
  if (!dateInput) return "N/A";
  const d = typeof dateInput === "number"
    ? new Date(dateInput * 1000)
    : new Date(dateInput);
  if (isNaN(d)) return "N/A";
  return d.toLocaleString(undefined, {
    year: "numeric", month: "short", day: "numeric",
    hour: "2-digit", minute: "2-digit",
  });
}
