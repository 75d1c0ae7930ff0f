/* geomap.js — self-contained Web-Mercator map engine.
 *
 * The reference frontend uses Leaflet + leaflet-draw from a CDN
 * (frontend/src/App.js, components/MapComponent.js). This framework ships
 * its own small engine instead so the app is fully offline-servable and
 * testable: XYZ tile layers, pan/wheel-zoom, bounded overlays with opacity,
 * rectangle draw/edit/delete tool, fitBounds, corner-anchored controls,
 * and haversine distance. API names intentionally mirror the Leaflet
 * subset the reference uses (getBounds, eachLayer, distanceTo...).
 */

const TILE = 256;
const EARTH_R = 6371000;

// ---------------------------------------------------------------------------
// Mercator math
// ---------------------------------------------------------------------------

export function lngToX(lng, z) {
  return ((lng + 180) / 360) * TILE * Math.pow(2, z);
}

export function latToY(lat, z) {
  const s = Math.sin((lat * Math.PI) / 180);
  const clamped = Math.min(Math.max(s, -0.9999), 0.9999);
  return (
    (0.5 - Math.log((1 + clamped) / (1 - clamped)) / (4 * Math.PI)) *
    TILE * Math.pow(2, z)
  );
}

export function xToLng(x, z) {
  return (x / (TILE * Math.pow(2, z))) * 360 - 180;
}

export function yToLat(y, z) {
  const n = Math.PI - (2 * Math.PI * y) / (TILE * Math.pow(2, z));
  return (180 / Math.PI) * Math.atan(0.5 * (Math.exp(n) - Math.exp(-n)));
}

export function haversineMeters(lat1, lng1, lat2, lng2) {
  const r = Math.PI / 180;
  const dLat = (lat2 - lat1) * r;
  const dLng = (lng2 - lng1) * r;
  const a =
    Math.sin(dLat / 2) ** 2 +
    Math.cos(lat1 * r) * Math.cos(lat2 * r) * Math.sin(dLng / 2) ** 2;
  return 2 * EARTH_R * Math.asin(Math.sqrt(a));
}

export class LatLng {
  constructor(lat, lng) {
    this.lat = lat;
    this.lng = lng;
  }
  distanceTo(other) {
    return haversineMeters(this.lat, this.lng, other.lat, other.lng);
  }
}

export class LatLngBounds {
  constructor(sw, ne) {
    this._sw = sw;
    this._ne = ne;
  }
  getSouthWest() { return this._sw; }
  getNorthEast() { return this._ne; }
  getWest() { return this._sw.lng; }
  getSouth() { return this._sw.lat; }
  getEast() { return this._ne.lng; }
  getNorth() { return this._ne.lat; }
  contains(ll) {
    return (
      ll.lat >= this._sw.lat && ll.lat <= this._ne.lat &&
      ll.lng >= this._sw.lng && ll.lng <= this._ne.lng
    );
  }
}

export function latLngBounds(a, b) {
  const sw = new LatLng(Math.min(a.lat, b.lat), Math.min(a.lng, b.lng));
  const ne = new LatLng(Math.max(a.lat, b.lat), Math.max(a.lng, b.lng));
  return new LatLngBounds(sw, ne);
}

// Area of a bounds rectangle in km² (reference MapComponent.calculateArea:
// width x height via distances).
export function boundsAreaKm2(bounds) {
  const sw = bounds.getSouthWest();
  const ne = bounds.getNorthEast();
  const width = haversineMeters(sw.lat, sw.lng, sw.lat, ne.lng);
  const height = haversineMeters(sw.lat, sw.lng, ne.lat, sw.lng);
  return (width * height) / 1e6;
}

// ---------------------------------------------------------------------------
// Event emitter
// ---------------------------------------------------------------------------

export class Evented {
  constructor() {
    this._handlers = {};
  }
  on(type, fn) {
    (this._handlers[type] = this._handlers[type] || []).push(fn);
    return this;
  }
  off(type, fn) {
    if (!this._handlers[type]) return this;
    this._handlers[type] = fn
      ? this._handlers[type].filter((h) => h !== fn)
      : [];
    return this;
  }
  fire(type, data) {
    for (const fn of this._handlers[type] || []) fn(data || {});
    return this;
  }
}

// ---------------------------------------------------------------------------
// Offline fallback tile (zero-egress demo/test environments)
// ---------------------------------------------------------------------------

let _fallbackCache = {};

function fallbackTileURL(z, x, y) {
  const key = `${z}`;
  if (!_fallbackCache[key]) {
    const c = document.createElement("canvas");
    c.width = TILE;
    c.height = TILE;
    const g = c.getContext("2d");
    g.fillStyle = "#dfe8dd";
    g.fillRect(0, 0, TILE, TILE);
    g.strokeStyle = "#b9c8bf";
    g.lineWidth = 1;
    for (let i = 0; i <= TILE; i += 32) {
      g.beginPath(); g.moveTo(i, 0); g.lineTo(i, TILE); g.stroke();
      g.beginPath(); g.moveTo(0, i); g.lineTo(TILE, i); g.stroke();
    }
    g.strokeStyle = "#9fb3a8";
    g.strokeRect(0, 0, TILE, TILE);
    _fallbackCache[key] = c.toDataURL("image/png");
  }
  return _fallbackCache[key];
}

// ---------------------------------------------------------------------------
// Tile layer
// ---------------------------------------------------------------------------

export class TileLayer extends Evented {
  /** opts: {minZoom, maxZoom, opacity, bounds (LatLngBounds|null), zIndex,
   *         className, crossOrigin,
   *         urlParams: optional () => string — extra query params computed
   *           at TILE LOAD TIME (e.g. a fresh bearer token; baking it into
   *           the template would go stale after token expiry),
   *         fallbackOnError: swap failed tiles for the offline grid
   *           (default true; data overlays pass false so an auth/server
   *           error shows as a missing tile, not plausible-looking data)} */
  constructor(urlTemplate, opts = {}) {
    super();
    this.url = urlTemplate;
    this.opts = Object.assign(
      { minZoom: 0, maxZoom: 19, opacity: 1, bounds: null, zIndex: 1,
        urlParams: null, fallbackOnError: true },
      opts
    );
    this.pane = null;
    this.map = null;
    this._tiles = new Map();
    this.visible = true;
  }

  addTo(map) {
    map.addLayer(this);
    return this;
  }

  setOpacity(o) {
    this.opts.opacity = o;
    if (this.pane) this.pane.style.opacity = String(o);
  }

  setVisible(v) {
    this.visible = v;
    if (this.pane) this.pane.style.display = v ? "" : "none";
  }

  _tileURL(z, x, y) {
    const n = Math.pow(2, z);
    const wrapped = ((x % n) + n) % n;
    let url = this.url
      .replace("{z}", z)
      .replace("{x}", wrapped)
      .replace("{y}", y)
      .replace("{s}", "abc"[(wrapped + y) % 3]);
    if (this.opts.urlParams) {
      const extra = this.opts.urlParams();
      if (extra) url += (url.includes("?") ? "&" : "?") + extra;
    }
    return url;
  }

  _tileInBounds(z, x, y) {
    if (!this.opts.bounds) return true;
    const west = xToLng(x * TILE, z);
    const east = xToLng((x + 1) * TILE, z);
    const north = yToLat(y * TILE, z);
    const south = yToLat((y + 1) * TILE, z);
    const b = this.opts.bounds;
    return !(
      east < b.getWest() || west > b.getEast() ||
      south > b.getNorth() || north < b.getSouth()
    );
  }

  redraw() {
    if (!this.map || !this.pane) return;
    const map = this.map;
    const z = Math.round(map.zoom);
    if (z < this.opts.minZoom || z > this.opts.maxZoom) {
      for (const el of this._tiles.values()) el.remove();
      this._tiles.clear();
      return;
    }
    const size = map.getSize();
    const cx = lngToX(map.center.lng, z);
    const cy = latToY(map.center.lat, z);
    const x0 = Math.floor((cx - size.w / 2) / TILE);
    const x1 = Math.floor((cx + size.w / 2) / TILE);
    const y0 = Math.max(0, Math.floor((cy - size.h / 2) / TILE));
    const y1 = Math.min(Math.pow(2, z) - 1,
                        Math.floor((cy + size.h / 2) / TILE));
    const wanted = new Set();
    for (let x = x0; x <= x1; x++) {
      for (let y = y0; y <= y1; y++) {
        if (!this._tileInBounds(z, x, y)) continue;
        const key = `${z}/${x}/${y}`;
        wanted.add(key);
        if (!this._tiles.has(key)) {
          const img = document.createElement("img");
          img.className = "gm-tile";
          img.width = TILE;
          img.height = TILE;
          img.draggable = false;
          img.alt = "";
          img.decoding = "async";
          img.onerror = () => {
            if (this.opts.fallbackOnError && !img._fellBack) {
              img._fellBack = true;
              img.src = fallbackTileURL(z, x, y);
            } else {
              img.style.visibility = "hidden";
            }
          };
          img.src = this._tileURL(z, x, y);
          this.pane.appendChild(img);
          this._tiles.set(key, img);
        }
        const el = this._tiles.get(key);
        el.style.transform =
          `translate(${x * TILE - cx + size.w / 2}px,` +
          ` ${y * TILE - cy + size.h / 2}px)`;
      }
    }
    for (const [key, el] of this._tiles) {
      if (!wanted.has(key)) {
        el.remove();
        this._tiles.delete(key);
      }
    }
  }

  remove() {
    if (this.map) this.map.removeLayer(this);
  }
}

// ---------------------------------------------------------------------------
// Rectangle vector layer
// ---------------------------------------------------------------------------

export class Rectangle extends Evented {
  constructor(bounds, style = {}) {
    super();
    this.bounds = bounds;
    this.style = Object.assign(
      { color: "#1E88E5", fillColor: "#1E88E5", fillOpacity: 0.2, weight: 2 },
      style
    );
    this.el = null;
    this.map = null;
  }

  getBounds() { return this.bounds; }

  setBounds(b) {
    this.bounds = b;
    if (this.map) this.map._redrawVector(this);
    this.fire("edit");
  }

  _render(map, svg) {
    if (!this.el) {
      this.el = document.createElementNS("http://www.w3.org/2000/svg", "rect");
      this.el.setAttribute("stroke", this.style.color);
      this.el.setAttribute("stroke-width", this.style.weight);
      this.el.setAttribute("fill", this.style.fillColor);
      this.el.setAttribute("fill-opacity", this.style.fillOpacity);
      this.el.setAttribute("pointer-events", "all");
      this.el.classList.add("gm-rect");
      this.el.addEventListener("contextmenu", (e) => {
        e.preventDefault();
        e.stopPropagation();
        this.fire("contextmenu", { originalEvent: e });
      });
      svg.appendChild(this.el);
    }
    const p1 = map.latLngToContainerPoint(
      new LatLng(this.bounds.getNorth(), this.bounds.getWest()));
    const p2 = map.latLngToContainerPoint(
      new LatLng(this.bounds.getSouth(), this.bounds.getEast()));
    this.el.setAttribute("x", Math.min(p1.x, p2.x));
    this.el.setAttribute("y", Math.min(p1.y, p2.y));
    this.el.setAttribute("width", Math.abs(p2.x - p1.x));
    this.el.setAttribute("height", Math.abs(p2.y - p1.y));
  }

  remove() {
    // Deregister from the map's vector list too — detaching only the SVG
    // element would let the next redraw() (any pan/zoom) re-render this
    // "removed" rectangle from map.vectors.
    if (this.map) {
      const m = this.map;
      this.map = null;
      m.vectors = m.vectors.filter((v) => v !== this);
    }
    if (this.el) { this.el.remove(); this.el = null; }
  }
}

export class FeatureGroup extends Evented {
  constructor() {
    super();
    this.layers = [];
  }
  addLayer(l) { this.layers.push(l); this.fire("change"); return this; }
  removeLayer(l) {
    l.remove();
    this.layers = this.layers.filter((x) => x !== l);
    this.fire("change");
    return this;
  }
  clearLayers() {
    for (const l of [...this.layers]) this.removeLayer(l);
    return this;
  }
  eachLayer(fn) { for (const l of [...this.layers]) fn(l); }
  getLayers() { return [...this.layers]; }
}

// ---------------------------------------------------------------------------
// Marker (locate control dot)
// ---------------------------------------------------------------------------

export class Marker extends Evented {
  constructor(latlng, opts = {}) {
    super();
    this.latlng = latlng;
    this.opts = opts;
    this.el = null;
    this.map = null;
  }
  _render(map, pane) {
    if (!this.el) {
      this.el = document.createElement("div");
      this.el.className = this.opts.className || "gm-marker";
      pane.appendChild(this.el);
    }
    const p = map.latLngToContainerPoint(this.latlng);
    this.el.style.transform = `translate(${p.x}px, ${p.y}px)`;
  }
  remove() { if (this.el) { this.el.remove(); this.el = null; } }
}

// ---------------------------------------------------------------------------
// Map
// ---------------------------------------------------------------------------

export class GeoMap extends Evented {
  /** opts: {center: [lat, lng], zoom, minZoom, maxZoom, maxBounds} */
  constructor(container, opts = {}) {
    super();
    this.container =
      typeof container === "string"
        ? document.getElementById(container)
        : container;
    this.container.classList.add("gm-map");
    this.center = new LatLng(
      (opts.center && opts.center[0]) || 0,
      (opts.center && opts.center[1]) || 0
    );
    this.zoom = opts.zoom != null ? opts.zoom : 3;
    this.minZoom = opts.minZoom != null ? opts.minZoom : 1;
    this.maxZoom = opts.maxZoom != null ? opts.maxZoom : 19;
    this.layers = [];
    this.vectors = [];
    this.markers = [];
    this._drawMode = null;

    // panes
    this.tilePane = document.createElement("div");
    this.tilePane.className = "gm-pane gm-tiles";
    this.overlayPane = document.createElement("div");
    this.overlayPane.className = "gm-pane gm-overlays";
    this.vectorSvg = document.createElementNS(
      "http://www.w3.org/2000/svg", "svg");
    this.vectorSvg.classList.add("gm-pane", "gm-vectors");
    this.markerPane = document.createElement("div");
    this.markerPane.className = "gm-pane gm-markers";
    this.controlCorners = {};
    this.container.append(
      this.tilePane, this.overlayPane, this.vectorSvg, this.markerPane);
    for (const corner of ["topleft", "topright", "bottomleft",
                          "bottomright"]) {
      const div = document.createElement("div");
      div.className = `gm-corner gm-${corner}`;
      this.container.appendChild(div);
      this.controlCorners[corner] = div;
    }

    this._bindInteractions();
    if (typeof ResizeObserver !== "undefined") {
      new ResizeObserver(() => this.redraw()).observe(this.container);
    }
    this.redraw();
  }

  getSize() {
    return {
      w: this.container.clientWidth || 800,
      h: this.container.clientHeight || 600,
    };
  }

  latLngToContainerPoint(ll) {
    const size = this.getSize();
    const z = this.zoom;
    return {
      x: lngToX(ll.lng, z) - lngToX(this.center.lng, z) + size.w / 2,
      y: latToY(ll.lat, z) - latToY(this.center.lat, z) + size.h / 2,
    };
  }

  containerPointToLatLng(p) {
    const size = this.getSize();
    const z = this.zoom;
    return new LatLng(
      yToLat(latToY(this.center.lat, z) + p.y - size.h / 2, z),
      xToLng(lngToX(this.center.lng, z) + p.x - size.w / 2, z)
    );
  }

  setView(center, zoom) {
    this.center = Array.isArray(center)
      ? new LatLng(center[0], center[1])
      : center;
    if (zoom != null) {
      this.zoom = Math.min(this.maxZoom, Math.max(this.minZoom, zoom));
    }
    this.redraw();
    this.fire("moveend");
    return this;
  }

  getZoom() { return this.zoom; }
  getCenter() { return this.center; }

  zoomIn() { return this.setView(this.center, this.zoom + 1); }
  zoomOut() { return this.setView(this.center, this.zoom - 1); }

  fitBounds(bounds, padding = 40) {
    const size = this.getSize();
    const center = new LatLng(
      (bounds.getSouth() + bounds.getNorth()) / 2,
      (bounds.getWest() + bounds.getEast()) / 2
    );
    for (let z = this.maxZoom; z >= this.minZoom; z--) {
      const w = lngToX(bounds.getEast(), z) - lngToX(bounds.getWest(), z);
      const h = latToY(bounds.getSouth(), z) - latToY(bounds.getNorth(), z);
      if (w <= size.w - padding && h <= size.h - padding) {
        return this.setView(center, z);
      }
    }
    return this.setView(center, this.minZoom);
  }

  addLayer(layer) {
    layer.map = this;
    layer.pane = document.createElement("div");
    layer.pane.className = "gm-pane gm-tilelayer";
    layer.pane.style.zIndex = String(layer.opts.zIndex);
    layer.pane.style.opacity = String(layer.opts.opacity);
    this.tilePane.appendChild(layer.pane);
    this.layers.push(layer);
    layer.redraw();
    return this;
  }

  removeLayer(layer) {
    if (layer.pane) layer.pane.remove();
    this.layers = this.layers.filter((l) => l !== layer);
    layer.map = null;
    // Drop the tile cache: the entries' <img>s died with the pane, and a
    // re-addTo(map) would otherwise skip every previously-seen tile key.
    if (layer._tiles) layer._tiles.clear();
    return this;
  }

  addVector(rect) {
    rect.map = this;
    this.vectors.push(rect);
    rect._render(this, this.vectorSvg);
    return rect;
  }

  removeVector(rect) {
    rect.remove();
    this.vectors = this.vectors.filter((v) => v !== rect);
  }

  _redrawVector(rect) { rect._render(this, this.vectorSvg); }

  addMarker(m) {
    m.map = this;
    this.markers.push(m);
    m._render(this, this.markerPane);
    return m;
  }

  removeMarker(m) {
    m.remove();
    this.markers = this.markers.filter((x) => x !== m);
  }

  redraw() {
    for (const l of this.layers) l.redraw();
    for (const v of this.vectors) v._render(this, this.vectorSvg);
    for (const m of this.markers) m._render(this, this.markerPane);
  }

  // -- draw mode ------------------------------------------------------------

  /** Enable one-shot rectangle drawing; fires "draw:created" with {rect}. */
  enableRectangleDraw(style) {
    this._drawMode = { style: style || {} };
    this.container.classList.add("gm-drawing");
  }

  disableDraw() {
    this._drawMode = null;
    this.container.classList.remove("gm-drawing");
  }

  // -- interactions -----------------------------------------------------------

  _bindInteractions() {
    const el = this.container;
    let drag = null;
    let drawing = null;

    el.addEventListener("pointerdown", (e) => {
      if (e.button !== 0) return;
      const rectBox = el.getBoundingClientRect();
      const p = { x: e.clientX - rectBox.left, y: e.clientY - rectBox.top };
      if (this._drawMode) {
        drawing = {
          start: this.containerPointToLatLng(p),
          rect: null,
        };
        el.setPointerCapture(e.pointerId);
        e.preventDefault();
        return;
      }
      drag = { x: e.clientX, y: e.clientY, moved: false };
      el.setPointerCapture(e.pointerId);
    });

    el.addEventListener("pointermove", (e) => {
      const rectBox = el.getBoundingClientRect();
      const p = { x: e.clientX - rectBox.left, y: e.clientY - rectBox.top };
      if (drawing) {
        const cur = this.containerPointToLatLng(p);
        const b = latLngBounds(drawing.start, cur);
        if (!drawing.rect) {
          drawing.rect = new Rectangle(b, this._drawMode.style);
          this.addVector(drawing.rect);
        } else {
          drawing.rect.bounds = b;
          this._redrawVector(drawing.rect);
        }
        return;
      }
      if (drag) {
        const dx = e.clientX - drag.x;
        const dy = e.clientY - drag.y;
        if (Math.abs(dx) + Math.abs(dy) > 2) drag.moved = true;
        drag.x = e.clientX;
        drag.y = e.clientY;
        const z = this.zoom;
        this.center = new LatLng(
          yToLat(latToY(this.center.lat, z) - dy, z),
          xToLng(lngToX(this.center.lng, z) - dx, z)
        );
        this.redraw();
      }
    });

    const finish = (e) => {
      if (drawing) {
        const rect = drawing.rect;
        drawing = null;
        this.disableDraw();
        if (rect) this.fire("draw:created", { layer: rect });
        return;
      }
      if (drag) {
        if (drag.moved) this.fire("moveend");
        drag = null;
      }
    };
    el.addEventListener("pointerup", finish);
    el.addEventListener("pointercancel", finish);

    el.addEventListener(
      "wheel",
      (e) => {
        e.preventDefault();
        const rectBox = el.getBoundingClientRect();
        const p = { x: e.clientX - rectBox.left, y: e.clientY - rectBox.top };
        const anchor = this.containerPointToLatLng(p);
        const dz = e.deltaY < 0 ? 1 : -1;
        const newZoom = Math.min(
          this.maxZoom, Math.max(this.minZoom, this.zoom + dz));
        if (newZoom === this.zoom) return;
        // keep the cursor latlng fixed
        const size = this.getSize();
        this.zoom = newZoom;
        const cx = lngToX(anchor.lng, newZoom) - (p.x - size.w / 2);
        const cy = latToY(anchor.lat, newZoom) - (p.y - size.h / 2);
        this.center = new LatLng(yToLat(cy, newZoom), xToLng(cx, newZoom));
        this.redraw();
        this.fire("moveend");
      },
      { passive: false }
    );

    el.addEventListener("dblclick", (e) => {
      const rectBox = el.getBoundingClientRect();
      const p = { x: e.clientX - rectBox.left, y: e.clientY - rectBox.top };
      this.setView(this.containerPointToLatLng(p), this.zoom + 1);
    });
  }

  /** Add a positioned control: corner in topleft|topright|bottomleft|... */
  addControl(el, corner = "topleft") {
    // controls must not pan/zoom the map underneath
    for (const evt of ["pointerdown", "dblclick", "wheel"]) {
      el.addEventListener(evt, (e) => e.stopPropagation());
    }
    this.controlCorners[corner].appendChild(el);
    return el;
  }
}
