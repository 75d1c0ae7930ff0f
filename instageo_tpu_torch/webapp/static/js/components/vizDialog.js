/* vizDialog.js — visualization dialog (reference components/
 * VisualizationDialog.js, 461 LoC): satellite + prediction preview cards
 * (auth-fetched blobs with loading/error states), segmentation class
 * legend with per-class proportions from the visualization stage's
 * segmentation_stats, regression min/max/mean/std from the statistics
 * endpoint, add-to-map, and PDF report download. */

import { el, openDialog, spinner, chip, showSnackbar } from "../ui.js";
import { apiService } from "../api.js";
import { prefixTitilerUrl } from "../config.js";
import { generateSegmentationColors, generateTiTilerColormap }
  from "../segColors.js";
import { generateTaskPdf } from "../report.js";

async function authedImage(url) {
  const headers = await apiService.authHeaders().catch(() => ({}));
  const res = await fetch(url, { headers });
  if (!res.ok) throw new Error(`HTTP ${res.status}`);
  const blob = await res.blob();
  const img = el("img", { class: "viz-preview" });
  img.src = URL.createObjectURL(blob);
  return img;
}

function previewCard(title, urlPromiseFactory) {
  const holder = el("div", { class: "viz-card" },
    el("div", { class: "viz-card-title" }, title),
    el("div", { class: "viz-card-body" }, spinner(28)));
  urlPromiseFactory()
    .then((img) => {
      holder.querySelector(".viz-card-body").replaceChildren(img);
    })
    .catch((e) => {
      holder.querySelector(".viz-card-body").replaceChildren(
        el("div", { class: "viz-error" }, `Preview unavailable (${e.message})`));
    });
  return holder;
}

function modelInfoFor(task, models) {
  return (models || []).find((m) => m.model_key === task.model_key) || {};
}

export function openVisualizationDialog({ task, models, onAddToMap }) {
  const layers = task.titiler_data || {};
  const model = modelInfoFor(task, models);
  const isSeg = (model.model_type || "seg") === "seg";
  const classesMapping = model.classes_mapping || {};
  const classIndices = Object.keys(classesMapping)
    .map(Number).sort((a, b) => a - b);
  const colors = generateSegmentationColors(classIndices);

  const content = el("div", { class: "viz-content" });

  // Previews row
  const previews = el("div", { class: "viz-previews" });
  if (layers.chips && layers.chips.preview) {
    previews.append(previewCard("Satellite", () =>
      authedImage(prefixTitilerUrl(layers.chips.preview + "?mode=rgb"))));
  }
  if (layers.predictions && layers.predictions.preview) {
    let url = layers.predictions.preview + "?mode=classes";
    if (isSeg && classIndices.length) {
      url += `&colormap=${encodeURIComponent(
        generateTiTilerColormap(classIndices))}`;
    }
    previews.append(previewCard("Prediction", () =>
      authedImage(prefixTitilerUrl(url))));
  }
  content.append(previews);

  // Stats section
  const statsBox = el("div", { class: "viz-stats" }, spinner(22));
  content.append(statsBox);
  let statsForPdf = null;

  (async () => {
    try {
      if (isSeg) {
        const segStats = (((task.stages || {}).visualization_preparation
          || {}).result || {}).segmentation_stats || {};
        const counts = segStats.class_counts || {};
        const totalValid = segStats.valid_pixels ||
          Object.values(counts).reduce((a, b) => a + Number(b), 0);
        const proportions = {};
        for (const [idx, count] of Object.entries(counts)) {
          if (totalValid) {
            proportions[Number(idx)] =
              ((Number(count) / totalValid) * 100).toFixed(1);
          }
        }
        statsForPdf = {
          type: "seg",
          class_indices: classIndices,
          classes_mapping: classesMapping,
          class_proportions: proportions,
          valid_pixels: totalValid,
        };
        statsBox.replaceChildren(
          el("div", { class: "viz-stats-title" },
            `Classes (${segStats.unique_values != null
              ? segStats.unique_values
              : Object.keys(counts).length} present, ` +
            `${totalValid.toLocaleString()} valid px)`),
          el("div", { class: "viz-classes" },
            ...classIndices.map((idx) => {
              const pct = proportions[idx];
              const c = chip(
                `${classesMapping[idx] || `Class ${idx}`}` +
                (pct !== undefined ? ` — ${pct}%` : ""), colors[idx]);
              return c;
            })));
      } else {
        const statsUrl = layers.predictions && layers.predictions.statistics;
        if (!statsUrl) { statsBox.replaceChildren(); return; }
        const stats = await apiService.getTitilerData(statsUrl);
        const b1 = stats.b1 || {};
        statsForPdf = { type: "reg", ...b1 };
        statsBox.replaceChildren(
          el("div", { class: "viz-stats-title" }, "Prediction statistics"),
          el("table", { class: "stats-table" },
            ...[["Min", b1.min], ["Max", b1.max],
                ["Mean", b1.mean], ["Std", b1.std]].map(([k, v]) =>
              el("tr", {},
                el("td", {}, k),
                el("td", { class: "mono" },
                  v != null ? Number(v).toFixed(4) : "-")))));
      }
    } catch (e) {
      statsBox.replaceChildren(
        el("div", { class: "viz-error" }, `Stats unavailable: ${e.message}`));
    }
  })();

  const bounds = boundsFromTask(task);
  const layerData = () => ({
    taskId: task.task_id,
    taskName: `${model.name || task.model_key || "task"} · ` +
      `${String(task.task_id).slice(0, 8)}`,
    modelKey: task.model_key,
    modelSize: task.model_size,
    createdAt: task.created_at
      ? new Date(task.created_at * 1000).toLocaleString() : "",
    bboxText: JSON.stringify(task.bboxes || []),
    titilerData: layers,
    classIndices: isSeg ? classIndices : null,
    bounds,
    minZoom: 4,
    maxZoom: 18,
    stats: statsForPdf,
  });

  const dialog = openDialog({
    title: `Visualization — ${String(task.task_id).slice(0, 12)}`,
    content,
    wide: true,
    id: "viz-dialog",
    actions: [
      el("button", {
        class: "btn", onclick: async () => {
          try {
            await generateTaskPdf(layerData());
          } catch (e) {
            showSnackbar(`PDF generation failed: ${e.message}`, "error");
          }
        },
      }, "Download report"),
      el("button", {
        class: "btn primary", id: "viz-add-to-map",
        onclick: () => {
          onAddToMap(layerData());
          dialog.close();
        },
      }, "Add to map"),
    ],
  });
  return dialog;
}

function boundsFromTask(task) {
  const bboxes = task.bboxes || [];
  if (!bboxes.length) return null;
  let [w, s, e, n] = bboxes[0];
  for (const [bw, bs, be, bn] of bboxes) {
    w = Math.min(w, bw); s = Math.min(s, bs);
    e = Math.max(e, be); n = Math.max(n, bn);
  }
  return [[s, w], [n, e]]; // [[southLat, westLng], [northLat, eastLng]]
}
