/* report.js — task PDF report (reference utils/pdfReport.js: header band,
 * satellite + prediction previews side by side, seg pie chart + legend or
 * reg histogram + gradient legend, page footer with numbers, opened as a
 * blob URL). */

import { MiniPDF, pieChartJpeg, barChartJpeg, fetchImageAsJpeg } from "./pdf.js";
import { generateSegmentationColors, hexToRgb, VIRIDIS_PALETTE }
  from "./segColors.js";
import { generateTiTilerColormap } from "./segColors.js";
import { prefixTitilerUrl } from "./config.js";
import { apiService } from "./api.js";

function sectionHeader(doc, title, y) {
  doc.setFillColor(240, 240, 240);
  doc.setDrawColor(200, 200, 200);
  doc.rect(10, y, doc.pageWidth - 20, 8, "FD");
  doc.setFontSize(11);
  doc.setTextColor(0, 0, 0);
  doc.text(title, doc.pageWidth / 2, y + 5.5, { align: "center" });
  return y + 12;
}

function fitImage(w, h, maxW, maxH) {
  const ar = w / h;
  let iw = maxW, ih = maxW / ar;
  if (ih > maxH) { ih = maxH; iw = maxH * ar; }
  return [iw, ih];
}

export async function generateTaskPdf(taskLayer) {
  const doc = new MiniPDF();
  const pageW = doc.pageWidth;
  let y = 0;

  // Header band
  doc.setFillColor(33, 150, 243);
  doc.rect(0, 0, pageW, 20, "F");
  doc.setTextColor(255, 255, 255);
  doc.setFontSize(14);
  doc.text("Task Report", pageW / 2, 8, { align: "center" });
  doc.setFontSize(10);
  doc.text(
    `${taskLayer.taskName || taskLayer.taskId || ""} - ` +
    `${new Date().toLocaleString()}`,
    pageW / 2, 15, { align: "center" });
  doc.setTextColor(0, 0, 0);
  y = 26;

  // Metadata
  y = sectionHeader(doc, "Task Details", y);
  doc.setFontSize(10);
  const meta = [
    ["Task ID", taskLayer.taskId || "-"],
    ["Model", `${taskLayer.modelKey || "-"} (${taskLayer.modelSize || "-"})`],
    ["Created", taskLayer.createdAt || "-"],
    ["Bounding box", taskLayer.bboxText || "-"],
  ];
  for (const [k, v] of meta) {
    doc.text(`${k}:`, 14, y);
    doc.text(String(v), 55, y);
    y += 6;
  }
  y += 4;

  // Previews
  y = sectionHeader(doc, "Imagery", y);
  const headers = await apiService.authHeaders().catch(() => ({}));
  const layers = taskLayer.titilerData || {};
  const previews = [];
  if (layers.chips && layers.chips.preview) {
    previews.push(["Satellite", prefixTitilerUrl(
      layers.chips.preview + "?mode=rgb")]);
  }
  if (layers.predictions && layers.predictions.preview) {
    let url = layers.predictions.preview + "?mode=classes";
    if (taskLayer.classIndices) {
      url += `&colormap=${encodeURIComponent(
        generateTiTilerColormap(taskLayer.classIndices))}`;
    }
    previews.push(["Prediction", prefixTitilerUrl(url)]);
  }
  let x = 10;
  let rowH = 0;
  for (const [label, url] of previews) {
    try {
      const img = await fetchImageAsJpeg(url, headers);
      const [iw, ih] = fitImage(img.width, img.height, 90, 90);
      doc.setFontSize(9);
      doc.text(label, x + iw / 2, y + 4, { align: "center" });
      doc.addImage(img.dataUrl, x, y + 6, iw, ih);
      rowH = Math.max(rowH, ih + 10);
      x += 100;
    } catch (e) {
      doc.setFontSize(9);
      doc.text(`${label}: preview unavailable`, x, y + 6);
      rowH = Math.max(rowH, 12);
      x += 100;
    }
  }
  y += rowH + 6;

  // Stats
  if (y + 100 > 280) { doc.addPage(); y = 10; }
  const stats = taskLayer.stats;
  if (stats && stats.type === "seg") {
    y = sectionHeader(doc, "Class Distribution", y);
    const indices = stats.class_indices || [];
    const colors = generateSegmentationColors(indices);
    const values = indices.map((i) =>
      Number((stats.class_proportions || {})[i] || 0));
    const pie = pieChartJpeg(values, indices.map((i) => colors[i]));
    doc.addImage(pie, 10, y, 70, 70);
    let legendY = y + 4;
    doc.setFontSize(10);
    for (const idx of indices) {
      const [r, g, b] = hexToRgb(colors[idx]);
      doc.setFillColor(r, g, b);
      doc.rect(90, legendY, 4, 4, "F");
      doc.setTextColor(0, 0, 0);
      const name = (stats.classes_mapping || {})[idx] || `Class ${idx}`;
      doc.text(
        `${name}: ${values[indices.indexOf(idx)].toFixed(1)}%`,
        96, legendY + 3.5);
      legendY += 6;
      if (legendY > 270) { doc.addPage(); legendY = 10; }
    }
    y += 76;
  } else if (stats && stats.type === "reg") {
    y = sectionHeader(doc, "Prediction Statistics", y);
    doc.setFontSize(10);
    const rows = [
      ["Min", stats.min], ["Max", stats.max],
      ["Mean", stats.mean], ["Std", stats.std],
    ];
    for (const [k, v] of rows) {
      doc.text(`${k}:`, 14, y);
      doc.text(v != null ? Number(v).toFixed(4) : "-", 40, y);
      y += 6;
    }
    if (stats.histogram && stats.histogram.length) {
      const hist = barChartJpeg(stats.histogram, VIRIDIS_PALETTE);
      doc.addImage(hist, 10, y + 2, 120, 75);
      y += 82;
    }
  }

  // Page footers
  const total = doc.getNumberOfPages();
  for (let p = 1; p <= total; p++) {
    doc.setFontSize(8);
    doc.setTextColor(150, 150, 150);
    doc.text(`Page ${p} of ${total}`, pageW / 2, doc.pageHeight - 5,
             { align: "center" }, p);
  }

  window.open(doc.bloburl(), "_blank");
  return doc;
}
