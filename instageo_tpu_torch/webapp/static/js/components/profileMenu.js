/* profileMenu.js — user avatar + sign in/out menu (reference
 * components/ProfileMenu.js: avatar from id-token claims, login via
 * redirect, logout; hidden entirely when auth is not configured). */

import { el, iconButton } from "../ui.js";
import { isAuthConfigured, isAuthenticated, getUser, loginWithRedirect,
         logout } from "../auth.js";

export function createProfileMenu() {
  if (!isAuthConfigured()) {
    return el("span", { class: "auth-disabled-badge", title:
      "Authentication disabled (test mode)" });
  }
  const wrap = el("div", { class: "profile-menu" });
  const menu = el("div", { class: "menu hidden" });

  function render() {
    wrap.innerHTML = "";
    menu.innerHTML = "";
    if (isAuthenticated()) {
      const user = getUser() || {};
      const avatar = user.picture
        ? el("img", { class: "avatar", src: user.picture, alt: "avatar" })
        : iconButton("person", "Profile", () => {});
      avatar.addEventListener("click", () => menu.classList.toggle("hidden"));
      menu.append(
        el("div", { class: "menu-user" },
          el("div", { class: "menu-name" }, user.name || "Signed in"),
          el("div", { class: "menu-email" }, user.email || "")),
        el("button", { class: "btn", onclick: () => logout() }, "Sign out"));
      wrap.append(avatar, menu);
    } else {
      wrap.append(el("button", {
        class: "btn", onclick: () => loginWithRedirect(),
      }, "Sign in"));
    }
  }
  render();
  return wrap;
}
