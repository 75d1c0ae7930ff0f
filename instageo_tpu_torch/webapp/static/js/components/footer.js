/* footer.js — attribution/disclaimer bar (reference components/Footer.js +
 * constants.FOOTER_DISCLAIMER_TEXT). */

import { el } from "../ui.js";
import { CONFIG } from "../config.js";

export function createFooter() {
  const footer = el("footer", { id: "app-footer" },
    el("span", { class: "footer-text" },
      "InstaGeo TPU — end-to-end geospatial ML"),
    el("span", { class: "footer-attribution" }));
  footer.querySelector(".footer-attribution").innerHTML =
    CONFIG.BASE_MAP_ATTRIBUTION;
  document.body.append(footer);
  return footer;
}
