/* taskLayers.js — per-task satellite/prediction overlays + the map-corner
 * layers control (reference components/TaskLayers.js,
 * TaskLayersControl.js, TaskLayersControlWrapper.js): each added task
 * contributes two bounded tile layers; the bottom-left control lists
 * tasks with per-layer visibility toggles, opacity sliders, zoom-to,
 * PDF report, per-task remove and remove-all). */

import { TileLayer, latLngBounds, LatLng } from "../geomap.js";
import { el, iconButton, ICONS, svgIcon, showSnackbar } from "../ui.js";
import { prefixTitilerUrl } from "../config.js";
import { appStore } from "../store.js";
import { generateTiTilerColormap } from "../segColors.js";
import { generateTaskPdf } from "../report.js";
import { getAccessTokenSync } from "../auth.js";

export function createTaskLayersManager(map) {
  const live = new Map(); // taskLayer.id -> {satellite: TileLayer, prediction}

  const control = el("div", { class: "gm-control layers-control" });
  map.addControl(control, "bottomleft");

  function tileUrl(taskLayer, kind) {
    const layers = taskLayer.titilerData || {};
    const entry = kind === "satellite" ? layers.chips : layers.predictions;
    if (!entry || !entry.tiles) return null;
    let url = prefixTitilerUrl(entry.tiles);
    const params = [];
    if (kind === "prediction" && taskLayer.classIndices) {
      params.push(`colormap=${encodeURIComponent(
        generateTiTilerColormap(taskLayer.classIndices))}`);
    }
    if (params.length) url += `?${params.join("&")}`;
    return url;
  }

  // <img>-loaded tiles can't carry an Authorization header; the backend's
  // tile routes accept the bearer token as a query param. Computed per
  // tile LOAD (TileLayer opts.urlParams), never baked into the template —
  // a baked token goes stale at expiry and every pan would 401.
  function tokenParams() {
    const token = getAccessTokenSync();
    return token ? `access_token=${encodeURIComponent(token)}` : "";
  }

  function syncMapLayers() {
    const taskLayers = appStore.get("taskLayers");
    const wantIds = new Set(taskLayers.map((t) => t.id));
    // remove dropped tasks
    for (const [id, entry] of live) {
      if (!wantIds.has(id)) {
        if (entry.satellite) map.removeLayer(entry.satellite);
        if (entry.prediction) map.removeLayer(entry.prediction);
        live.delete(id);
      }
    }
    for (const t of taskLayers) {
      let entry = live.get(t.id);
      if (!entry) {
        entry = {};
        const bounds = t.bounds
          ? latLngBounds(new LatLng(t.bounds[0][0], t.bounds[0][1]),
                         new LatLng(t.bounds[1][0], t.bounds[1][1]))
          : null;
        const satUrl = tileUrl(t, "satellite");
        const predUrl = tileUrl(t, "prediction");
        if (satUrl) {
          entry.satellite = new TileLayer(satUrl, {
            bounds, zIndex: 5, opacity: t.satelliteOpacity,
            minZoom: t.minZoom || 0, maxZoom: t.maxZoom || 19,
            urlParams: tokenParams, fallbackOnError: false,
          }).addTo(map);
        }
        if (predUrl) {
          entry.prediction = new TileLayer(predUrl, {
            bounds, zIndex: 6, opacity: t.predictionOpacity,
            minZoom: t.minZoom || 0, maxZoom: t.maxZoom || 19,
            urlParams: tokenParams, fallbackOnError: false,
          }).addTo(map);
        }
        live.set(t.id, entry);
      }
      if (entry.satellite) {
        entry.satellite.setVisible(t.visible && t.satelliteVisible);
        entry.satellite.setOpacity(t.satelliteOpacity);
      }
      if (entry.prediction) {
        entry.prediction.setVisible(t.visible && t.predictionVisible);
        entry.prediction.setOpacity(t.predictionOpacity);
      }
    }
  }

  // Opacity drags fire store updates per input tick; rebuilding the
  // control then would destroy the <input type=range> mid-drag (the same
  // re-render-kills-the-focused-input trap tasksMonitor.buildToolbar
  // documents), so the subscriber skips the rebuild for pure-opacity
  // changes — the slider the user is holding already shows the value.
  let lastChangeWasOpacity = false;

  function changeTaskLayer(id, layerType, changeType, value) {
    lastChangeWasOpacity = changeType === "opacity";
    let layers = appStore.get("taskLayers");
    if (changeType === "remove") {
      layers = layers.filter((t) => t.id !== id);
    } else {
      layers = layers.map((t) => {
        if (t.id !== id) return t;
        const u = { ...t };
        if (changeType === "visibility") {
          if (layerType === "satellite") u.satelliteVisible = value;
          else u.predictionVisible = value;
        } else if (changeType === "opacity") {
          if (layerType === "satellite") u.satelliteOpacity = value;
          else u.predictionOpacity = value;
        }
        return u;
      });
    }
    appStore.set({ taskLayers: layers });
  }

  function zoomToTask(t) {
    if (!t.bounds) return;
    map.fitBounds(latLngBounds(
      new LatLng(t.bounds[0][0], t.bounds[0][1]),
      new LatLng(t.bounds[1][0], t.bounds[1][1])));
  }

  const collapsed = {};

  function layerRow(t, kind, label) {
    const visible = kind === "satellite" ? t.satelliteVisible
                                         : t.predictionVisible;
    const opacity = kind === "satellite" ? t.satelliteOpacity
                                         : t.predictionOpacity;
    const hasLayer = Boolean(tileUrl(t, kind));
    if (!hasLayer) return null;
    return el("div", { class: "layer-row" },
      iconButton(visible ? "eye" : "eyeOff",
        `${visible ? "Hide" : "Show"} ${label}`,
        () => changeTaskLayer(t.id, kind, "visibility", !visible), "inline"),
      el("span", { class: "layer-label" }, label),
      el("input", {
        type: "range", min: 0, max: 100, value: Math.round(opacity * 100),
        class: "slider layer-opacity", title: `${label} opacity`,
        oninput: (e) =>
          changeTaskLayer(t.id, kind, "opacity",
                          Number(e.target.value) / 100),
      }));
  }

  function renderControl() {
    const taskLayers = appStore.get("taskLayers");
    control.innerHTML = "";
    if (!taskLayers.length) { control.classList.add("hidden"); return; }
    control.classList.remove("hidden");
    const head = el("div", { class: "layers-head" },
      svgIcon(ICONS.layers, 18),
      el("span", {}, ` Task Layers (${taskLayers.length})`),
      iconButton("delete", "Remove all layers", () => {
        appStore.set({ taskLayers: [] });
      }, "inline"));
    control.append(head);
    for (const t of taskLayers) {
      const body = el("div", { class: "layers-task-body" },
        layerRow(t, "satellite", "Satellite"),
        layerRow(t, "prediction", "Prediction"));
      if (collapsed[t.id]) body.classList.add("hidden");
      const taskCard = el("div", { class: "layers-task" },
        el("div", { class: "layers-task-head" },
          el("span", { class: "layers-task-name",
                       title: t.taskId || "" },
             t.taskName || t.taskId || "task"),
          iconButton("zoomIn", "Zoom to task", () => zoomToTask(t), "inline"),
          iconButton("pdf", "Download PDF report", async () => {
            try {
              await generateTaskPdf(t);
            } catch (e) {
              showSnackbar(`PDF generation failed: ${e.message}`, "error");
            }
          }, "inline"),
          iconButton(collapsed[t.id] ? "expand" : "collapse",
            "Toggle", () => {
              collapsed[t.id] = !collapsed[t.id];
              renderControl();
            }, "inline"),
          iconButton("delete", "Remove task layers",
            () => changeTaskLayer(t.id, null, "remove", null), "inline")),
        body);
      control.append(taskCard);
    }
  }

  appStore.subscribe((state, patch) => {
    if ("taskLayers" in patch) {
      syncMapLayers();
      if (lastChangeWasOpacity) {
        lastChangeWasOpacity = false;
      } else {
        renderControl();
      }
    }
  });

  renderControl();

  /** Add a task's layers to the map (reference App.handleAddTaskLayer). */
  function addTaskLayer(data) {
    const newLayer = {
      ...data,
      id: Date.now(),
      visible: true,
      satelliteVisible: false,
      predictionVisible: true,
      satelliteOpacity: 0.8,
      predictionOpacity: 0.8,
    };
    const filtered = appStore.get("taskLayers")
      .filter((t) => t.taskId !== data.taskId);
    appStore.set({ taskLayers: [...filtered, newLayer] });
    if (newLayer.bounds) zoomToTask(newLayer);
  }

  return { addTaskLayer, changeTaskLayer, zoomToTask };
}
