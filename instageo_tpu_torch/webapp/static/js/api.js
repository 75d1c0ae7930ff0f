/* api.js — backend REST client (reference services/apiService.js). */

import { ENDPOINTS } from "./config.js";
import { getAccessToken, isAuthConfigured } from "./auth.js";

async function authHeaders() {
  const headers = { "Content-Type": "application/json" };
  if (isAuthConfigured()) {
    const token = await getAccessToken();
    headers["Authorization"] = `Bearer ${token}`;
  }
  return headers;
}

async function makeRequest(endpoint, options = {}) {
  const config = {
    ...options,
    headers: { ...(await authHeaders()), ...(options.headers || {}) },
  };
  const response = await fetch(endpoint, config);
  if (!response.ok) {
    let detail = {};
    try { detail = await response.json(); } catch (e) { /* non-JSON body */ }
    if (response.status === 401 || response.status === 403) {
      throw new Error(
        detail.detail || "Authentication required. Please sign in again.");
    }
    throw new Error(
      detail.detail || `HTTP ${response.status}: ${response.statusText}`);
  }
  return response.json();
}

export const apiService = {
  makeRequest,
  authHeaders,

  runModel(payload) {
    return makeRequest(ENDPOINTS.RUN_MODEL, {
      method: "POST",
      body: JSON.stringify(payload),
    });
  },

  getTaskStatus(taskId) {
    return makeRequest(ENDPOINTS.TASK_STATUS(taskId));
  },

  async getAllTasks() {
    const data = await makeRequest(ENDPOINTS.GET_ALL_TASKS);
    return data.tasks || data;
  },

  async getModels() {
    const data = await makeRequest(ENDPOINTS.GET_MODELS);
    return data.models || data;
  },

  visualizeTask(taskId) {
    return makeRequest(ENDPOINTS.VISUALIZE(taskId));
  },

  getTitilerData(url) {
    return makeRequest(ENDPOINTS.GET_TITILER_DATA(url));
  },

  health() {
    return makeRequest(ENDPOINTS.HEALTH);
  },
};

// ---------------------------------------------------------------------------
// Models cache (reference utils/modelsCache.js: 24h localStorage TTL)
// ---------------------------------------------------------------------------

const MODELS_CACHE_KEY = "instageo_models_cache_v2";
const MODELS_TTL_MS = 24 * 60 * 60 * 1000;

export async function fetchModelsWithTTL() {
  const now = Date.now();
  try {
    const cachedRaw = localStorage.getItem(MODELS_CACHE_KEY);
    if (cachedRaw) {
      const cached = JSON.parse(cachedRaw);
      if (now - cached.timestamp < MODELS_TTL_MS) return cached.data;
      localStorage.removeItem(MODELS_CACHE_KEY);
    }
  } catch (e) {
    try { localStorage.removeItem(MODELS_CACHE_KEY); } catch (e2) { /* */ }
  }
  const data = await apiService.getModels();
  try {
    localStorage.setItem(
      MODELS_CACHE_KEY, JSON.stringify({ timestamp: now, data }));
  } catch (e) { /* storage full — ignore */ }
  return data;
}

export function clearModelsCache() {
  try { localStorage.removeItem(MODELS_CACHE_KEY); } catch (e) { /* */ }
}

// Authentication error classifier (reference utils/authErrors.js).
export function isAuthenticationError(message) {
  if (!message) return false;
  const m = String(message).toLowerCase();
  return (
    m.includes("authentication") || m.includes("sign in") ||
    m.includes("unauthorized") || m.includes("not authenticated") ||
    m.includes("login required") || m.includes("token")
  );
}
