/* segColors.js — segmentation class palette + tiler colormap strings
 * (reference utils/segmentationColors.js: same 30-color palette so layer
 * colors match across the viz dialog, map layers, and PDF report). */

export const SEGMENTATION_COLORS = [
  // Light variants
  "#aec7e8", "#ffbb78", "#98df8a", "#ff9896", "#c5b0d5",
  "#c49c94", "#f7b6d2", "#c7c7c7", "#dbdb8d", "#9edae5",
  // Base
  "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
  "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
  // Dark variants
  "#393b79", "#b35806", "#006d2c", "#a50f15", "#54278f",
  "#5d4037", "#c2185b", "#424242", "#827717", "#006064",
];

export function generateSegmentationColors(classIndices = []) {
  const mapping = {};
  classIndices.forEach((idx, i) => {
    mapping[idx] = SEGMENTATION_COLORS[i % SEGMENTATION_COLORS.length];
  });
  return mapping;
}

export function hexToRgb(hex) {
  if (hex.length === 4) {
    hex = "#" + hex.slice(1).split("").map((ch) => ch + ch).join("");
  }
  return [
    parseInt(hex.slice(1, 3), 16),
    parseInt(hex.slice(3, 5), 16),
    parseInt(hex.slice(5, 7), 16),
  ];
}

/** Class indices (or {index: color} map) -> tiler colormap JSON string. */
export function generateTiTilerColormap(input) {
  let colorMap;
  if (Array.isArray(input)) {
    colorMap = generateSegmentationColors(input);
  } else if (typeof input === "object" && input !== null) {
    colorMap = input;
  } else {
    throw new Error(
      "generateTiTilerColormap expects array of indices or color mapping");
  }
  const jsonObj = {};
  for (const [index, hex] of Object.entries(colorMap)) {
    if (typeof hex !== "string" || !hex.startsWith("#")) {
      throw new Error(`Invalid color value for class ${index}: ${hex}`);
    }
    jsonObj[index] = hexToRgb(hex);
  }
  return JSON.stringify(jsonObj);
}

export const VIRIDIS_PALETTE = [
  "#440154", "#482777", "#3f4a8a", "#31678e", "#26838f",
  "#1f9d8a", "#6cce5a", "#b6de2b", "#fee825",
];
