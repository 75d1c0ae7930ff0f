/* mapView.js — base map + rectangle draw tooling (reference
 * components/MapComponent.js + BoundingBoxInfo.js + App.js LocateControl):
 * single-bbox enforcement, 50-500 km² area validation with snackbar
 * feedback, right-click bbox info popover, GPS locate button, dark-mode
 * tile filter. */

import { GeoMap, TileLayer, FeatureGroup, Marker, LatLng, boundsAreaKm2 }
  from "../geomap.js";
import { CONFIG, DARK_MODE_MAP_FILTER } from "../config.js";
import { el, iconButton, showSnackbar } from "../ui.js";
import { appStore } from "../store.js";

export function createMapView(containerId) {
  const map = new GeoMap(containerId, {
    center: [0, 0], zoom: 3, minZoom: 3, maxZoom: 19,
  });
  const base = new TileLayer(CONFIG.BASE_MAP_URL, { zIndex: 0 }).addTo(map);
  const featureGroup = new FeatureGroup();

  // zoom control
  const zoomCtl = el("div", { class: "gm-control gm-zoom" },
    iconButton("zoomIn", "Zoom in", () => map.zoomIn()),
    el("button", { class: "icon-btn", title: "Zoom out",
                   onclick: () => map.zoomOut() }, "−"));
  map.addControl(zoomCtl, "topleft");

  // draw / clear toolbar (leaflet-draw rectangle equivalent)
  const drawBtn = el("button", {
    class: "icon-btn draw-btn", title: "Draw a bounding box",
    onclick: () => {
      drawBtn.classList.add("active");
      map.enableRectangleDraw({
        color: "#1E88E5", fillColor: "#1E88E5", fillOpacity: 0.2, weight: 2,
      });
    },
  }, "▭");
  const clearBtn = iconButton("delete", "Delete bounding box", () => {
    clearBoxes();
    appStore.set({ hasBoundingBox: false, totalArea: 0 });
    hideInfo();
  });
  map.addControl(
    el("div", { class: "gm-control gm-draw" }, drawBtn, clearBtn),
    "topleft");

  // locate control (reference App.js LocateControl)
  let locateMarker = null;
  const locateBtn = iconButton("locate", "Show my location", () => {
    if (!navigator.geolocation) {
      showSnackbar("Geolocation is not supported by this browser");
      return;
    }
    navigator.geolocation.getCurrentPosition(
      (pos) => {
        const ll = new LatLng(pos.coords.latitude, pos.coords.longitude);
        if (locateMarker) map.removeMarker(locateMarker);
        locateMarker = map.addMarker(
          new Marker(ll, { className: "gm-locate-dot" }));
        map.setView(ll, Math.max(map.getZoom(), 12));
      },
      () => showSnackbar("Could not determine your location"));
  });
  map.addControl(el("div", { class: "gm-control" }, locateBtn), "topleft");

  function clearBoxes() {
    featureGroup.eachLayer((l) => {
      featureGroup.removeLayer(l);
      map.removeVector(l);
    });
  }

  function totalArea() {
    let area = 0;
    featureGroup.eachLayer((l) => { area += boundsAreaKm2(l.getBounds()); });
    return area;
  }

  // bbox info panel (reference BoundingBoxInfo.js)
  const infoPanel = el("div", { class: "bbox-info hidden", id: "bbox-info" });
  document.getElementById(containerId).appendChild(infoPanel);

  function showInfo() {
    const layers = featureGroup.getLayers();
    if (!layers.length) { hideInfo(); return; }
    const b = layers[0].getBounds();
    infoPanel.innerHTML = "";
    infoPanel.append(
      el("div", { class: "bbox-info-title" },
        "Bounding Box",
        iconButton("close", "Close", hideInfo, "inline")),
      el("div", {}, `West: ${b.getWest().toFixed(4)}°`),
      el("div", {}, `South: ${b.getSouth().toFixed(4)}°`),
      el("div", {}, `East: ${b.getEast().toFixed(4)}°`),
      el("div", {}, `North: ${b.getNorth().toFixed(4)}°`),
      el("div", { class: "bbox-info-area" },
        `Area: ${totalArea().toFixed(1)} km²`));
    infoPanel.classList.remove("hidden");
  }

  function hideInfo() { infoPanel.classList.add("hidden"); }

  map.on("draw:created", ({ layer }) => {
    drawBtn.classList.remove("active");
    const area = boundsAreaKm2(layer.getBounds());
    // single-box policy: replace any existing boxes (reference
    // MapComponent handleDrawCreated clears existing layers first)
    clearBoxes();
    if (area < CONFIG.MIN_AREA_KM2 || area > CONFIG.MAX_AREA_KM2) {
      map.removeVector(layer);
      showSnackbar(
        `Area must be between ${CONFIG.MIN_AREA_KM2} and ` +
        `${CONFIG.MAX_AREA_KM2} km² (got ${area.toFixed(1)} km²)`);
      appStore.set({ hasBoundingBox: featureGroup.getLayers().length > 0 });
      return;
    }
    featureGroup.addLayer(layer);
    layer.on("contextmenu", () => {
      appStore.set({ totalArea: totalArea() });
      showInfo();
    });
    appStore.set({ hasBoundingBox: true, totalArea: area });
    showInfo();
  });

  // dark-mode tile filter (reference BaseMapThemeController)
  function applyTheme(theme) {
    const tiles = document.querySelector(`#${containerId} .gm-tiles`);
    if (tiles) {
      tiles.style.filter = theme === "dark" ? DARK_MODE_MAP_FILTER : "";
    }
  }
  applyTheme(appStore.get("theme"));
  appStore.subscribe((state, patch) => {
    if ("theme" in patch) applyTheme(state.theme);
  });

  return { map, featureGroup, base, clearBoxes, showInfo, hideInfo };
}
