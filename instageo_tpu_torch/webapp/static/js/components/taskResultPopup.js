/* taskResultPopup.js — post-submit popup (reference components/
 * TaskResultPopup.js + BoundingBoxSnapshot.js): task id + live status with
 * per-stage indicators while the app polls /api/task/{id}, a bbox snapshot
 * sketch, error display, and an "open task history" shortcut. */

import { el, openDialog, chip, formatDate, svgIcon, ICONS } from "../ui.js";

const STAGE_LABELS = {
  data_processing: "Data Processing",
  model_prediction: "Model Prediction",
  visualization_preparation: "Visualization Preparation",
};

function bboxSnapshot(bboxes) {
  // Mini SVG sketch of the submitted boxes in their own extent
  if (!bboxes || !bboxes.length) return null;
  let [w, s, e, n] = bboxes[0];
  for (const [bw, bs, be, bn] of bboxes) {
    w = Math.min(w, bw); s = Math.min(s, bs);
    e = Math.max(e, be); n = Math.max(n, bn);
  }
  const pad = Math.max((e - w), (n - s)) * 0.15 || 0.1;
  w -= pad; s -= pad; e += pad; n += pad;
  const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
  svg.setAttribute("viewBox", `0 0 100 70`);
  svg.setAttribute("class", "bbox-snapshot");
  for (const [bw, bs, be, bn] of bboxes) {
    const r = document.createElementNS("http://www.w3.org/2000/svg", "rect");
    r.setAttribute("x", ((bw - w) / (e - w)) * 100);
    r.setAttribute("y", ((n - bn) / (n - s)) * 70);
    r.setAttribute("width", ((be - bw) / (e - w)) * 100);
    r.setAttribute("height", ((bn - bs) / (n - s)) * 70);
    r.setAttribute("fill", "#1E88E5");
    r.setAttribute("fill-opacity", "0.25");
    r.setAttribute("stroke", "#1E88E5");
    svg.appendChild(r);
  }
  return svg;
}

export function openTaskResultPopup({ result, error, onOpenTasksMonitor,
                                      onClose }) {
  const content = el("div", { class: "result-content" });

  function renderResult(task) {
    content.innerHTML = "";
    if (error) {
      content.append(el("div", { class: "alert error" },
        svgIcon(ICONS.error, 18), " ",
        error.message || "Failed to submit task."));
      return;
    }
    if (!task) return;
    content.append(
      el("div", { class: "result-row" },
        el("span", { class: "result-label" }, "Task ID"),
        el("span", { class: "mono" }, task.task_id)),
      el("div", { class: "result-row" },
        el("span", { class: "result-label" }, "Status"),
        chip(task.status || "pending")),
      el("div", { class: "result-row" },
        el("span", { class: "result-label" }, "Submitted"),
        el("span", {}, formatDate(task.created_at))));
    const snapshot = bboxSnapshot(task.bboxes);
    if (snapshot) content.append(snapshot);
    const stages = task.stages || {};
    content.append(el("div", { class: "result-stages" },
      ...Object.entries(STAGE_LABELS).map(([key, label]) => {
        const st = (stages[key] || {}).status || "pending";
        const icon = st === "completed" ? "check"
          : st === "failed" ? "error"
          : st === "running" ? "play" : "schedule";
        return el("div", { class: "stage-row" },
          svgIcon(ICONS[icon], 14),
          el("span", { class: "stage-name" }, label),
          el("span", { class: "stage-status" }, st));
      })));
    if (task.error) {
      content.append(el("div", { class: "alert error" }, task.error));
    }
  }

  renderResult(result);

  const dialog = openDialog({
    title: error ? "Task Submission Failed" : "Task Submitted",
    content,
    id: "task-result-popup",
    onClose,
    actions: [
      el("button", {
        class: "btn primary",
        onclick: () => { dialog.close(); onOpenTasksMonitor(); },
      }, "Open Task History"),
    ],
  });
  // Caller updates the popup as polling progresses.
  dialog.update = renderResult;
  return dialog;
}
