/* store.js — minimal pub/sub application state (replaces React useState
 * threading through App.js). */

export class Store {
  constructor(initial = {}) {
    this.state = { ...initial };
    this._subs = [];
  }
  get(key) { return this.state[key]; }
  set(patch) {
    Object.assign(this.state, patch);
    for (const fn of this._subs) fn(this.state, patch);
  }
  subscribe(fn) {
    this._subs.push(fn);
    return () => { this._subs = this._subs.filter((f) => f !== fn); };
  }
}

export const appStore = new Store({
  theme: localStorage.getItem("instageo_theme") || "dark",
  hasBoundingBox: false,
  totalArea: 0,
  isProcessing: false,
  taskResult: null,
  taskError: null,
  taskLayers: [], // [{id, taskId, taskName, satellite*, prediction*, bounds}]
});
