/* pdf.js — minimal PDF writer (the reference uses jsPDF + recharts-to-png,
 * utils/pdfReport.js; this is a from-scratch equivalent covering the subset
 * the report needs: A4 pages in mm, Helvetica text with alignment, filled/
 * stroked rects, JPEG images via DCTDecode XObjects, multi-page output,
 * and a blob URL for window.open). */

const A4 = { w: 210, h: 297 }; // mm
const MM_TO_PT = 72 / 25.4;

// Common CP1252 (WinAnsi) codes for characters above Latin-1's range.
const WINANSI_EXTRA = {
  "€": 0x80, "…": 0x85, "‘": 0x91, "’": 0x92,
  "“": 0x93, "”": 0x94, "•": 0x95, "–": 0x96,
  "—": 0x97, "™": 0x99,
};

export function esc(s) {
  // PDF literal strings are BYTE strings under the font's encoding
  // (/WinAnsiEncoding here) — emit non-ASCII as octal byte escapes, not
  // raw UTF-8 (viewers would render multi-byte sequences as mojibake,
  // e.g. '·' -> 'Â·'). Characters outside WinAnsi degrade to '?'.
  let out = "";
  for (const ch of String(s)) {
    if (ch === "\\") { out += "\\\\"; continue; }
    if (ch === "(") { out += "\\("; continue; }
    if (ch === ")") { out += "\\)"; continue; }
    const c = WINANSI_EXTRA[ch] ?? ch.codePointAt(0);
    if (c >= 32 && c < 127) out += ch;
    else if (c >= 0x80 && c <= 0xff) {
      out += "\\" + c.toString(8).padStart(3, "0");
    } else out += "?";
  }
  return out;
}

// Rough Helvetica advance widths (per 1000 units) for text centering.
const AVG_CHAR_W = 500;
const CHAR_W = {
  i: 222, j: 222, l: 222, f: 278, t: 278, r: 333, " ": 278,
  m: 833, w: 722, M: 833, W: 944, ".": 278, ",": 278, ":": 278,
};

function textWidthMm(text, sizePt) {
  let units = 0;
  for (const ch of String(text)) units += CHAR_W[ch] || AVG_CHAR_W;
  return ((units / 1000) * sizePt) / MM_TO_PT;
}

export class MiniPDF {
  constructor() {
    this.pages = [];
    this.images = []; // {name, width, height, bytes}
    this._fill = [0, 0, 0];
    this._stroke = [0, 0, 0];
    this._textColor = [0, 0, 0];
    this._fontSize = 10;
    this.addPage();
  }

  addPage() {
    this.pages.push({ ops: [], images: new Set() });
    return this;
  }

  get pageWidth() { return A4.w; }
  get pageHeight() { return A4.h; }
  getNumberOfPages() { return this.pages.length; }

  _page(n = null) {
    return n === null ? this.pages[this.pages.length - 1]
      : this.pages[n - 1];
  }

  _pt(xMm) { return (xMm * MM_TO_PT).toFixed(2); }
  _y(yMm) { return ((A4.h - yMm) * MM_TO_PT).toFixed(2); } // top-left origin

  setFillColor(r, g, b) { this._fill = [r / 255, g / 255, b / 255]; return this; }
  setDrawColor(r, g, b) { this._stroke = [r / 255, g / 255, b / 255]; return this; }
  setTextColor(r, g, b) { this._textColor = [r / 255, g / 255, b / 255]; return this; }
  setFontSize(pt) { this._fontSize = pt; return this; }

  /** style: 'F' fill, 'D' stroke, 'FD' both. Coordinates in mm, top-left. */
  rect(x, y, w, h, style = "D", pageN = null) {
    const p = this._page(pageN);
    const [fr, fg, fb] = this._fill;
    const [sr, sg, sb] = this._stroke;
    const op =
      `${fr.toFixed(3)} ${fg.toFixed(3)} ${fb.toFixed(3)} rg ` +
      `${sr.toFixed(3)} ${sg.toFixed(3)} ${sb.toFixed(3)} RG ` +
      `${this._pt(x)} ${this._y(y + h)} ${this._pt(w)} ${this._pt(h)} re ` +
      (style === "F" ? "f" : style === "FD" ? "B" : "S");
    p.ops.push(op);
    return this;
  }

  /** opts: {align: 'left'|'center'|'right'}; (x, y) in mm, y is baseline. */
  text(str, x, y, opts = {}, pageN = null) {
    const p = this._page(pageN);
    let tx = x;
    if (opts.align === "center") tx = x - textWidthMm(str, this._fontSize) / 2;
    else if (opts.align === "right") tx = x - textWidthMm(str, this._fontSize);
    const [r, g, b] = this._textColor;
    p.ops.push(
      `BT /F1 ${this._fontSize} Tf ` +
      `${r.toFixed(3)} ${g.toFixed(3)} ${b.toFixed(3)} rg ` +
      `${this._pt(tx)} ${this._y(y)} Td (${esc(str)}) Tj ET`);
    return this;
  }

  /** JPEG data URL (canvas.toDataURL('image/jpeg')) -> image at (x, y) mm. */
  addImage(jpegDataUrl, x, y, w, h) {
    const base64 = jpegDataUrl.split(",")[1];
    const bin = atob(base64);
    const bytes = new Uint8Array(bin.length);
    for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
    // Parse SOFn for dimensions.
    let iw = 1, ih = 1;
    for (let i = 2; i < bytes.length - 9; ) {
      if (bytes[i] !== 0xff) { i++; continue; }
      const marker = bytes[i + 1];
      if (marker >= 0xc0 && marker <= 0xcf &&
          marker !== 0xc4 && marker !== 0xc8 && marker !== 0xcc) {
        ih = (bytes[i + 5] << 8) | bytes[i + 6];
        iw = (bytes[i + 7] << 8) | bytes[i + 8];
        break;
      }
      i += 2 + ((bytes[i + 2] << 8) | bytes[i + 3]);
    }
    const name = `Im${this.images.length}`;
    this.images.push({ name, width: iw, height: ih, bytes });
    const p = this._page();
    p.images.add(name);
    p.ops.push(
      `q ${this._pt(w)} 0 0 ${this._pt(h)} ` +
      `${this._pt(x)} ${this._y(y + h)} cm /${name} Do Q`);
    return this;
  }

  /** Serialize to a PDF Blob. */
  output() {
    const enc = new TextEncoder();
    const chunks = [];
    const offsets = [];
    let pos = 0;
    const push = (data) => {
      const bytes = typeof data === "string" ? enc.encode(data) : data;
      chunks.push(bytes);
      pos += bytes.length;
    };
    const obj = (body) => {
      offsets.push(pos);
      const n = offsets.length;
      push(`${n} 0 obj\n${body}\nendobj\n`);
      return n;
    };

    push("%PDF-1.4\n");
    const fontN = obj(
      "<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica " +
      "/Encoding /WinAnsiEncoding >>");
    const imageNs = {};
    for (const img of this.images) {
      offsets.push(pos);
      const n = offsets.length;
      push(
        `${n} 0 obj\n<< /Type /XObject /Subtype /Image ` +
        `/Width ${img.width} /Height ${img.height} ` +
        `/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode ` +
        `/Length ${img.bytes.length} >>\nstream\n`);
      push(img.bytes);
      push("\nendstream\nendobj\n");
      imageNs[img.name] = n;
    }

    const contentNs = [];
    for (const p of this.pages) {
      const stream = p.ops.join("\n");
      contentNs.push(obj(
        `<< /Length ${enc.encode(stream).length} >>\nstream\n${stream}\nendstream`));
    }
    const pageNs = [];
    const pagesN = offsets.length + this.pages.length + 1; // forward ref
    this.pages.forEach((p, i) => {
      const xobjs = [...p.images]
        .map((nm) => `/${nm} ${imageNs[nm]} 0 R`).join(" ");
      pageNs.push(obj(
        `<< /Type /Page /Parent ${pagesN} 0 R ` +
        `/MediaBox [0 0 ${(A4.w * MM_TO_PT).toFixed(2)} ` +
        `${(A4.h * MM_TO_PT).toFixed(2)}] ` +
        `/Resources << /Font << /F1 ${fontN} 0 R >> ` +
        `/XObject << ${xobjs} >> >> ` +
        `/Contents ${contentNs[i]} 0 R >>`));
    });
    const actualPagesN = obj(
      `<< /Type /Pages /Kids [${pageNs.map((n) => `${n} 0 R`).join(" ")}] ` +
      `/Count ${pageNs.length} >>`);
    const catalogN = obj(
      `<< /Type /Catalog /Pages ${actualPagesN} 0 R >>`);

    const xrefPos = pos;
    let xref = `xref\n0 ${offsets.length + 1}\n0000000000 65535 f \n`;
    for (const off of offsets) {
      xref += `${String(off).padStart(10, "0")} 00000 n \n`;
    }
    push(xref);
    push(
      `trailer\n<< /Size ${offsets.length + 1} /Root ${catalogN} 0 R >>\n` +
      `startxref\n${xrefPos}\n%%EOF\n`);

    return new Blob(chunks, { type: "application/pdf" });
  }

  bloburl() {
    return URL.createObjectURL(this.output());
  }
}

// ---------------------------------------------------------------------------
// Canvas charts (replace recharts Pie/Bar renders in the reference report)
// ---------------------------------------------------------------------------

export function pieChartJpeg(values, colors, size = 600) {
  const c = document.createElement("canvas");
  c.width = size;
  c.height = size;
  const g = c.getContext("2d");
  g.fillStyle = "#ffffff";
  g.fillRect(0, 0, size, size);
  const total = values.reduce((a, b) => a + b, 0) || 1;
  let angle = -Math.PI / 2;
  const cx = size / 2, cy = size / 2, r = size * 0.42;
  values.forEach((v, i) => {
    const sweep = (v / total) * 2 * Math.PI;
    g.beginPath();
    g.moveTo(cx, cy);
    g.arc(cx, cy, r, angle, angle + sweep);
    g.closePath();
    g.fillStyle = colors[i % colors.length];
    g.fill();
    angle += sweep;
  });
  return c.toDataURL("image/jpeg", 0.9);
}

export function barChartJpeg(values, colors, width = 800, height = 500) {
  const c = document.createElement("canvas");
  c.width = width;
  c.height = height;
  const g = c.getContext("2d");
  g.fillStyle = "#ffffff";
  g.fillRect(0, 0, width, height);
  const maxV = Math.max(...values, 1);
  const pad = 40;
  const bw = (width - 2 * pad) / values.length;
  g.strokeStyle = "#888";
  g.beginPath();
  g.moveTo(pad, height - pad);
  g.lineTo(width - pad, height - pad);
  g.stroke();
  values.forEach((v, i) => {
    const h = ((height - 2 * pad) * v) / maxV;
    g.fillStyle = colors[i % colors.length];
    g.fillRect(pad + i * bw + bw * 0.1, height - pad - h, bw * 0.8, h);
  });
  return c.toDataURL("image/jpeg", 0.9);
}

/** Fetch a PNG/any image URL (with auth headers) -> JPEG data URL. */
export async function fetchImageAsJpeg(url, headers = {}) {
  const res = await fetch(url, { headers });
  if (!res.ok) throw new Error(`Failed to fetch image: ${res.status}`);
  const blob = await res.blob();
  const bitmapUrl = URL.createObjectURL(blob);
  try {
    const img = await new Promise((resolve, reject) => {
      const im = new Image();
      im.onload = () => resolve(im);
      im.onerror = reject;
      im.src = bitmapUrl;
    });
    const c = document.createElement("canvas");
    c.width = img.width;
    c.height = img.height;
    const g = c.getContext("2d");
    g.fillStyle = "#ffffff";
    g.fillRect(0, 0, c.width, c.height);
    g.drawImage(img, 0, 0);
    return {
      dataUrl: c.toDataURL("image/jpeg", 0.9),
      width: img.width,
      height: img.height,
    };
  } finally {
    URL.revokeObjectURL(bitmapUrl);
  }
}
