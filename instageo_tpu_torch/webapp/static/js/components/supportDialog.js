/* supportDialog.js — help/contact dialog (reference
 * components/SupportDialog.js + constants.HELP_DIALOG). */

import { el, openDialog } from "../ui.js";

const SECTIONS = [
  {
    title: "Documentation",
    description:
      "Check out the repository for source code, examples, and issue " +
      "tracking.",
    button: "View Repository",
    href: "https://github.com/instadeepai/InstaGeo-E2E-Geospatial-ML",
  },
  {
    title: "Contact Support",
    description:
      "If you need direct assistance, please send us an email.",
    button: "Submit Support Request",
    href: "mailto:support-instageo@instadeep.com",
  },
];

export function openSupportDialog() {
  const content = el("div", { class: "support-sections" },
    el("p", {}, "Need assistance?"),
    ...SECTIONS.map((s) =>
      el("div", { class: "support-section" },
        el("h3", {}, s.title),
        el("p", {}, s.description),
        el("a", { class: "btn", href: s.href, target: "_blank",
                  rel: "noopener" }, s.button))));
  return openDialog({ title: "Contact Support", content, id: "support-dialog" });
}
