/* config.js — endpoints and app configuration.
 * Mirrors the reference frontend/src/config.js: same endpoint table and
 * area-validation limits; the base URL is same-origin here because the
 * backend serves the SPA itself.
 */

const BASE = window.INSTAGEO_API_BASE || "";

export function prefixTitilerUrl(url) {
  if (!url) return url;
  if (url.startsWith("http://") || url.startsWith("https://")) return url;
  if (url.startsWith("/")) return `${BASE}${url}`;
  return url;
}

export const ENDPOINTS = {
  RUN_MODEL: `${BASE}/api/run-model`,
  TASK_STATUS: (taskId) => `${BASE}/api/task/${taskId}`,
  GET_ALL_TASKS: `${BASE}/api/tasks`,
  GET_MODELS: `${BASE}/api/models`,
  HEALTH: `${BASE}/api/health`,
  VISUALIZE: (taskId) => `${BASE}/api/visualize/${taskId}`,
  GET_TITILER_DATA: (url) => `${BASE}${url}`,
};

export const CONFIG = {
  MIN_AREA_KM2: window.INSTAGEO_MIN_AREA_KM2 || 50,
  MAX_AREA_KM2: window.INSTAGEO_MAX_AREA_KM2 || 500,
  TASK_POLL_MS: 15000,
  BASE_MAP_URL:
    window.INSTAGEO_BASEMAP_URL ||
    "https://{s}.tile.openstreetmap.org/{z}/{x}/{y}.png",
  BASE_MAP_ATTRIBUTION:
    '&copy; <a href="https://www.openstreetmap.org/copyright">OpenStreetMap</a> contributors',
};

export const DEFAULT_TASK_PARAMS = {
  model_key: "",
  model_size: "",
  temporal_tolerance: 10,
  cloud_coverage: 100,
  date: new Date().toISOString().split("T")[0],
};

export const PARAMS_HELP = {
  chip_size:
    "Pixel width/height of the model input chip. Larger chips cover bigger areas per tile.",
  num_steps:
    "Number of temporal steps (images) the model uses as context for a prediction. >1 means multi-temporal inference.",
  data_source:
    "Satellite data source used to fetch imagery (e.g., HLS, Sentinel-2, Sentinel-1).",
  temporal_step:
    "Spacing in days between temporal steps. 0 means single-date inference.",
  temporal_tolerance:
    "Allowed ± days around the selected date to search for usable imagery. Larger windows increase availability but may shift seasonal conditions.",
  cloud_coverage:
    "Maximum acceptable percentage of cloud cover in the original tile from which the chips are extracted. Lower values yield clearer imagery but fewer candidates.",
};

export const DARK_MODE_MAP_FILTER =
  "invert(0.94) hue-rotate(220deg) brightness(1.5) saturate(0.5)";
