/* app.js — SPA bootstrap and top-level wiring (reference frontend/src/
 * App.js + index.js): map + draw tools, top-right action buttons (control
 * panel, task history, theme toggle), run-model submission from the drawn
 * bboxes, 15s status polling feeding the result popup, task-layer
 * management, footer, Auth0 redirect handling. */

import { createMapView } from "./components/mapView.js";
import { createControlPanel } from "./components/controlPanel.js";
import { createTasksMonitor } from "./components/tasksMonitor.js";
import { createTaskLayersManager } from "./components/taskLayers.js";
import { openTaskResultPopup } from "./components/taskResultPopup.js";
import { createFooter } from "./components/footer.js";
import { el, iconButton, showSnackbar } from "./ui.js";
import { apiService } from "./api.js";
import { appStore } from "./store.js";
import { handleRedirectCallback, isAuthConfigured } from "./auth.js";
import { CONFIG } from "./config.js";

async function boot() {
  if (isAuthConfigured()) {
    try {
      await handleRedirectCallback();
    } catch (e) {
      showSnackbar(`Login failed: ${e.message}`, "error");
    }
  }

  document.documentElement.dataset.theme = appStore.get("theme");
  appStore.subscribe((state, patch) => {
    if ("theme" in patch) {
      document.documentElement.dataset.theme = state.theme;
      localStorage.setItem("instageo_theme", state.theme);
    }
  });

  const { map, featureGroup } = createMapView("map");
  const layersManager = createTaskLayersManager(map);
  const tasksMonitor = createTasksMonitor({
    onAddTaskLayer: (data) => layersManager.addTaskLayer(data),
  });

  let statusPoll = null;
  let resultPopup = null;

  function stopPolling() {
    if (statusPoll) { clearInterval(statusPoll); statusPoll = null; }
  }

  async function handleRunModel(modelParams) {
    const layers = featureGroup.getLayers();
    if (!layers.length) return;
    appStore.set({ isProcessing: true, taskResult: null, taskError: null });
    try {
      const boundingBoxes = layers.map((l) => {
        const b = l.getBounds();
        return [b.getWest(), b.getSouth(), b.getEast(), b.getNorth()];
      });
      const result = await apiService.runModel({
        bboxes: boundingBoxes, ...modelParams,
      });
      appStore.set({ taskResult: result });
      resultPopup = openTaskResultPopup({
        result,
        error: null,
        onOpenTasksMonitor: () => tasksMonitor.open(),
        onClose: stopPolling,
      });
      // Poll status every 15s until completed/failed (reference App.js
      // status polling effect).
      stopPolling();
      statusPoll = setInterval(async () => {
        try {
          const updated = await apiService.getTaskStatus(result.task_id);
          appStore.set({ taskResult: updated });
          if (resultPopup) resultPopup.update(updated);
          if (updated.status === "completed" || updated.status === "failed") {
            stopPolling();
          }
        } catch (e) { /* transient poll error — keep polling */ }
      }, CONFIG.TASK_POLL_MS);
    } catch (e) {
      appStore.set({ taskError: { message: e.message } });
      openTaskResultPopup({
        result: null,
        error: { message: e.message },
        onOpenTasksMonitor: () => tasksMonitor.open(),
        onClose: () => {},
      });
    } finally {
      appStore.set({ isProcessing: false });
    }
  }

  const controlPanel = createControlPanel({ onRunModel: handleRunModel });

  // Top-right action buttons (reference App.js toolbar). Rebuilt on theme
  // change so the sun/moon glyph flips.
  const actions = el("div", { id: "top-actions" });

  function renderActions() {
    actions.replaceChildren(
      iconButton("analytics", "Open Control Panel",
        () => controlPanel.open(), "raised"),
      iconButton("list", "View Task History",
        () => tasksMonitor.open(), "raised"),
      iconButton(appStore.get("theme") === "dark" ? "light" : "dark",
        "Toggle theme", () => {
          appStore.set({
            theme: appStore.get("theme") === "dark" ? "light" : "dark",
          });
          renderActions();
        }, "raised theme-toggle"));
  }
  renderActions();
  document.body.append(actions);

  createFooter();

  // expose for diagnostics/tests
  window.__instageo = { map, appStore, layersManager, tasksMonitor,
                        controlPanel, featureGroup };
}

boot();
