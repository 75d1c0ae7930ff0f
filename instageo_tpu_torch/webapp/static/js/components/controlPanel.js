/* controlPanel.js — model/params drawer (reference components/
 * ControlPanel.js: model key + size selects fed from /api/models with a
 * 24h cache and reload button, derived model metadata chips, date picker,
 * temporal-tolerance + cloud-coverage sliders with expandable help, run
 * button gated on bbox + model + processing state, profile menu and
 * support dialog). */

import { el, iconButton, labeledSelect, slider, chip, spinner, showSnackbar }
  from "../ui.js";
import { DEFAULT_TASK_PARAMS, PARAMS_HELP } from "../config.js";
import { fetchModelsWithTTL, clearModelsCache } from "../api.js";
import { appStore } from "../store.js";
import { createProfileMenu } from "./profileMenu.js";
import { openSupportDialog } from "./supportDialog.js";

export function createControlPanel({ onRunModel }) {
  const panel = el("div", { class: "drawer hidden", id: "control-panel" });
  document.body.append(panel);

  let models = [];
  let params = { ...DEFAULT_TASK_PARAMS };
  let selectedKey = "";
  let selectedSize = "";
  let loading = false;

  function modelsByKey() {
    const map = {};
    for (const m of models) {
      (map[m.model_key] = map[m.model_key] || []).push(m);
    }
    return map;
  }

  function selectedModel() {
    const group = modelsByKey()[selectedKey] || [];
    if (!group.length) return null;
    const bySize = group.find((m) =>
      (m.model_size || m.default_size) === selectedSize);
    return bySize || group[0];
  }

  function render() {
    panel.innerHTML = "";
    const head = el("div", { class: "drawer-head" },
      el("h2", {}, "InstaGeo"),
      el("div", { class: "drawer-head-actions" },
        iconButton("help", "Support", () => openSupportDialog()),
        createProfileMenu(),
        iconButton("close", "Close", () =>
          panel.classList.add("hidden"))));

    const body = el("div", { class: "drawer-body" });

    // Model selection
    const keys = Object.keys(modelsByKey()).sort();
    const modelRow = el("div", { class: "field-row" },
      labeledSelect("Model",
        [{ value: "", label: loading ? "Loading models…" : "Select a model" },
         ...keys.map((k) => {
           const m = modelsByKey()[k][0];
           return { value: k, label: m.name || k };
         })],
        selectedKey,
        (v) => {
          selectedKey = v;
          const m = modelsByKey()[v] && modelsByKey()[v][0];
          selectedSize = m ? (m.default_size ||
            Object.keys(m.sizes || { base: 1 })[0]) : "";
          render();
        }),
      iconButton("refresh", "Reload models", async () => {
        clearModelsCache();
        await loadModels();
      }));
    body.append(modelRow);

    const model = selectedModel();
    if (model) {
      // Size select (sizes from registry metadata)
      const sizes = Object.keys(model.sizes || { base: {} });
      body.append(labeledSelect("Model size",
        sizes.map((s) => ({ value: s, label: s })), selectedSize,
        (v) => { selectedSize = v; render(); }));

      if (model.description) {
        body.append(el("div", { class: "model-desc" }, model.description));
      }

      // Derived metadata chips with help toggles (reference renderParamChip)
      const derived = el("div", { class: "chips" });
      for (const key of ["chip_size", "num_steps", "data_source",
                         "temporal_step"]) {
        if (model[key] === undefined) continue;
        const help = el("div", { class: "param-help hidden" },
          PARAMS_HELP[key] || "");
        const c = chip(`${key.replace(/_/g, " ")}: ${model[key]}`);
        c.append(iconButton("info", "More info",
          () => help.classList.toggle("hidden"), "inline"));
        derived.append(el("div", { class: "chip-wrap" }, c, help));
      }
      body.append(el("div", { class: "field" },
        el("label", { class: "field-label" }, "Model configuration"),
        derived));
    }

    // Date picker
    body.append(el("div", { class: "field" },
      el("label", { class: "field-label" }, "Date"),
      el("input", {
        type: "date", class: "input", value: params.date,
        onchange: (e) => { params.date = e.target.value; },
      })));

    // Sliders
    body.append(slider({
      label: "Temporal tolerance (days)", min: 1, max: 30,
      value: params.temporal_tolerance,
      onChange: (v) => { params.temporal_tolerance = v; },
      helpText: PARAMS_HELP.temporal_tolerance, onHelp: "toggle",
    }));
    body.append(slider({
      label: "Max cloud coverage (%)", min: 0, max: 100,
      value: params.cloud_coverage,
      onChange: (v) => { params.cloud_coverage = v; },
      helpText: PARAMS_HELP.cloud_coverage, onHelp: "toggle",
    }));

    // Run button
    const hasBox = appStore.get("hasBoundingBox");
    const processing = appStore.get("isProcessing");
    const runBtn = el("button", {
      class: "btn primary run-btn", id: "run-model-btn",
      onclick: async () => {
        if (!selectedKey) { showSnackbar("Select a model first"); return; }
        if (!hasBox) {
          showSnackbar("Draw a bounding box on the map first");
          return;
        }
        await onRunModel({
          ...params,
          model_key: selectedKey,
          model_size: selectedSize,
        });
      },
    }, processing ? spinner(18) : "", processing ? " Submitting…"
                                                 : "Run Model");
    runBtn.disabled = processing || !hasBox || !selectedKey;
    if (!hasBox) {
      body.append(el("div", { class: "hint" },
        "Draw a bounding box on the map to enable Run."));
    }
    body.append(runBtn);

    panel.append(head, body);
  }

  async function loadModels() {
    loading = true;
    render();
    try {
      models = (await fetchModelsWithTTL()) || [];
    } catch (e) {
      models = [];
      showSnackbar(`Failed to load models: ${e.message}`, "error");
    }
    loading = false;
    render();
  }

  appStore.subscribe((state, patch) => {
    if ("hasBoundingBox" in patch || "isProcessing" in patch) render();
  });

  render();
  loadModels();

  return {
    el: panel,
    open: () => panel.classList.remove("hidden"),
    close: () => panel.classList.add("hidden"),
    getParams: () => ({ ...params, model_key: selectedKey,
                        model_size: selectedSize }),
  };
}
