/* auth.js — Auth0 SPA login via the OAuth2 authorization-code + PKCE flow.
 *
 * The reference wraps the app in @auth0/auth0-react
 * (components/Auth0Provider.js, auth0-config.js): when the Auth0 domain /
 * client id / audience are configured the user must log in and API calls
 * carry a bearer token; when unset, auth is disabled (the backend's
 * AUTH_DISABLED test mode). This is the same behavior without the SDK:
 * WebCrypto PKCE, sessionStorage token cache, silent expiry handling.
 */

const cfg = window.INSTAGEO_AUTH0 || {};
const STORE_KEY = "instageo_auth_v1";

export function isAuthConfigured() {
  return Boolean(cfg.domain && cfg.clientId);
}

function randomString(len = 64) {
  const bytes = new Uint8Array(len);
  crypto.getRandomValues(bytes);
  return Array.from(bytes, (b) => ("0" + b.toString(16)).slice(-2)).join("");
}

function b64url(buf) {
  return btoa(String.fromCharCode(...new Uint8Array(buf)))
    .replace(/\+/g, "-").replace(/\//g, "_").replace(/=+$/, "");
}

async function sha256(text) {
  return crypto.subtle.digest("SHA-256", new TextEncoder().encode(text));
}

function loadTokens() {
  try {
    return JSON.parse(sessionStorage.getItem(STORE_KEY)) || null;
  } catch (e) {
    return null;
  }
}

function saveTokens(t) {
  sessionStorage.setItem(STORE_KEY, JSON.stringify(t));
}

export function clearTokens() {
  sessionStorage.removeItem(STORE_KEY);
}

export async function loginWithRedirect() {
  const verifier = randomString(48);
  const challenge = b64url(await sha256(verifier));
  const state = randomString(16);
  sessionStorage.setItem(
    "instageo_pkce", JSON.stringify({ verifier, state }));
  const params = new URLSearchParams({
    response_type: "code",
    client_id: cfg.clientId,
    redirect_uri: window.location.origin + window.location.pathname,
    scope: "openid profile email",
    audience: cfg.audience || "",
    state,
    code_challenge: challenge,
    code_challenge_method: "S256",
  });
  window.location.assign(`https://${cfg.domain}/authorize?${params}`);
}

/** Complete the redirect back from Auth0 (call once at app boot). */
export async function handleRedirectCallback() {
  const qs = new URLSearchParams(window.location.search);
  const code = qs.get("code");
  if (!code) return false;
  const pkce = JSON.parse(sessionStorage.getItem("instageo_pkce") || "{}");
  if (qs.get("state") !== pkce.state) throw new Error("OAuth state mismatch");
  const body = new URLSearchParams({
    grant_type: "authorization_code",
    client_id: cfg.clientId,
    code,
    redirect_uri: window.location.origin + window.location.pathname,
    code_verifier: pkce.verifier,
  });
  const res = await fetch(`https://${cfg.domain}/oauth/token`, {
    method: "POST",
    headers: { "Content-Type": "application/x-www-form-urlencoded" },
    body,
  });
  if (!res.ok) throw new Error(`Token exchange failed: ${res.status}`);
  const tok = await res.json();
  saveTokens({
    access_token: tok.access_token,
    id_token: tok.id_token,
    expires_at: Date.now() + (tok.expires_in || 3600) * 1000,
  });
  sessionStorage.removeItem("instageo_pkce");
  // Clean the code out of the URL.
  window.history.replaceState({}, "", window.location.pathname);
  return true;
}

export async function getAccessToken() {
  if (!isAuthConfigured()) {
    throw new Error("Not authenticated. Please sign in to continue.");
  }
  const t = loadTokens();
  if (t && t.expires_at > Date.now() + 30000) return t.access_token;
  clearTokens();
  throw new Error("Not authenticated. Please sign in to continue.");
}

/** Current token or null, synchronously (for <img>-loaded tile URLs,
 * which cannot carry an Authorization header). */
export function getAccessTokenSync() {
  if (!isAuthConfigured()) return null;
  const t = loadTokens();
  return t && t.expires_at > Date.now() ? t.access_token : null;
}

export function isAuthenticated() {
  if (!isAuthConfigured()) return true; // auth disabled — everything open
  const t = loadTokens();
  return Boolean(t && t.expires_at > Date.now());
}

/** Decoded id_token claims (name/email/picture) or null. */
export function getUser() {
  const t = loadTokens();
  if (!t || !t.id_token) return null;
  try {
    const payload = t.id_token.split(".")[1]
      .replace(/-/g, "+").replace(/_/g, "/");
    return JSON.parse(atob(payload));
  } catch (e) {
    return null;
  }
}

export function logout() {
  clearTokens();
  if (isAuthConfigured()) {
    const params = new URLSearchParams({
      client_id: cfg.clientId,
      returnTo: window.location.origin + window.location.pathname,
    });
    window.location.assign(`https://${cfg.domain}/v2/logout?${params}`);
  }
}
