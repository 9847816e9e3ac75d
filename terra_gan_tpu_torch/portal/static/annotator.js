/* Annotation portal canvas tool (reference: Annotation_Portal_Code/main.js).
 *
 * Same capabilities as the reference Konva app with no external
 * dependency: stable per-browser user hash, image list navigation,
 * pan/zoom, brush + eraser with adjustable size, rectangle tool,
 * undo/redo history, and mask export — the mask layer is rendered to
 * a dataURL at the ORIGINAL image resolution (the server rejects
 * dimension mismatches) and POSTed to /save_annotation.
 */
"use strict";

const state = {
  images: [],
  index: 0,
  tool: "brush",
  brushSize: 24,
  drawing: false,
  scale: 1,
  offsetX: 0,
  offsetY: 0,
  history: [],
  histPos: -1,
  rectStart: null,
};

function userHash() {
  let h = localStorage.getItem("annotator_user_hash");
  if (!h) {
    h = Math.random().toString(36).slice(2, 10);
    localStorage.setItem("annotator_user_hash", h);
  }
  return h;
}

const view = document.getElementById("view");
const vctx = view.getContext("2d");
const img = new Image();
// mask kept at native image resolution; white = flagged as AI
let mask = document.createElement("canvas");
let mctx = mask.getContext("2d");

async function loadImages() {
  const resp = await fetch("/images");
  const data = await resp.json();
  state.images = data.images || [];
  if (state.images.length) loadImage(0);
  else setStatus("no images available");
}

function loadImage(i) {
  state.index = (i + state.images.length) % state.images.length;
  img.onload = () => {
    mask.width = img.naturalWidth;
    mask.height = img.naturalHeight;
    mctx = mask.getContext("2d");
    mctx.fillStyle = "black";
    mctx.fillRect(0, 0, mask.width, mask.height);
    state.history = [];
    state.histPos = -1;
    pushHistory();
    fitView();
    render();
    setStatus(`${state.images[state.index]} (${state.index + 1}/${state.images.length})`);
  };
  img.src = `/api/file/${state.images[state.index]}`;
}

function fitView() {
  state.scale = Math.min(view.width / img.naturalWidth, view.height / img.naturalHeight);
  state.offsetX = (view.width - img.naturalWidth * state.scale) / 2;
  state.offsetY = (view.height - img.naturalHeight * state.scale) / 2;
}

function render() {
  vctx.clearRect(0, 0, view.width, view.height);
  vctx.save();
  vctx.translate(state.offsetX, state.offsetY);
  vctx.scale(state.scale, state.scale);
  vctx.drawImage(img, 0, 0);
  vctx.globalAlpha = 0.45;
  vctx.drawImage(mask, 0, 0);
  vctx.globalAlpha = 1.0;
  vctx.restore();
}

function toImageCoords(e) {
  const r = view.getBoundingClientRect();
  return {
    x: (e.clientX - r.left - state.offsetX) / state.scale,
    y: (e.clientY - r.top - state.offsetY) / state.scale,
  };
}

function pushHistory() {
  state.history = state.history.slice(0, state.histPos + 1);
  state.history.push(mctx.getImageData(0, 0, mask.width, mask.height));
  if (state.history.length > 40) state.history.shift();
  state.histPos = state.history.length - 1;
}

function undo() {
  if (state.histPos > 0) {
    state.histPos -= 1;
    mctx.putImageData(state.history[state.histPos], 0, 0);
    render();
  }
}

function redo() {
  if (state.histPos < state.history.length - 1) {
    state.histPos += 1;
    mctx.putImageData(state.history[state.histPos], 0, 0);
    render();
  }
}

function stroke(p) {
  mctx.fillStyle = state.tool === "eraser" ? "black" : "white";
  mctx.beginPath();
  mctx.arc(p.x, p.y, state.brushSize / state.scale / 2, 0, Math.PI * 2);
  mctx.fill();
}

view.addEventListener("pointerdown", (e) => {
  const p = toImageCoords(e);
  if (state.tool === "pan") {
    state.drawing = { panX: e.clientX, panY: e.clientY };
  } else if (state.tool === "rect") {
    state.rectStart = p;
    state.drawing = true;
  } else {
    state.drawing = true;
    stroke(p);
    render();
  }
});

view.addEventListener("pointermove", (e) => {
  if (!state.drawing) return;
  if (state.tool === "pan") {
    state.offsetX += e.clientX - state.drawing.panX;
    state.offsetY += e.clientY - state.drawing.panY;
    state.drawing = { panX: e.clientX, panY: e.clientY };
    render();
  } else if (state.tool !== "rect") {
    stroke(toImageCoords(e));
    render();
  }
});

view.addEventListener("pointerup", (e) => {
  if (state.tool === "rect" && state.rectStart) {
    const p = toImageCoords(e);
    mctx.fillStyle = "white";
    mctx.fillRect(
      Math.min(state.rectStart.x, p.x),
      Math.min(state.rectStart.y, p.y),
      Math.abs(p.x - state.rectStart.x),
      Math.abs(p.y - state.rectStart.y)
    );
    state.rectStart = null;
    render();
  }
  if (state.drawing && state.tool !== "pan") pushHistory();
  state.drawing = false;
});

view.addEventListener("wheel", (e) => {
  e.preventDefault();
  const factor = e.deltaY < 0 ? 1.1 : 1 / 1.1;
  const r = view.getBoundingClientRect();
  const cx = e.clientX - r.left;
  const cy = e.clientY - r.top;
  state.offsetX = cx - (cx - state.offsetX) * factor;
  state.offsetY = cy - (cy - state.offsetY) * factor;
  state.scale *= factor;
  render();
});

async function saveAnnotation() {
  // export at native resolution — the server validates dimensions
  const dataUrl = mask.toDataURL("image/png");
  const resp = await fetch("/save_annotation", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({
      image_name: state.images[state.index],
      user_hash: userHash(),
      mask: dataUrl,
    }),
  });
  const out = await resp.json();
  setStatus(out.status === "success" ? "annotation saved" : `error: ${out.message}`);
}

function setStatus(msg) {
  document.getElementById("status").textContent = msg;
}

document.getElementById("brush").onclick = () => (state.tool = "brush");
document.getElementById("eraser").onclick = () => (state.tool = "eraser");
document.getElementById("rect").onclick = () => (state.tool = "rect");
document.getElementById("pan").onclick = () => (state.tool = "pan");
document.getElementById("undo").onclick = undo;
document.getElementById("redo").onclick = redo;
document.getElementById("save").onclick = saveAnnotation;
document.getElementById("prev").onclick = () => loadImage(state.index - 1);
document.getElementById("next").onclick = () => loadImage(state.index + 1);
document.getElementById("size").oninput = (e) => (state.brushSize = +e.target.value);
document.addEventListener("keydown", (e) => {
  if (e.ctrlKey && e.key === "z") undo();
  if (e.ctrlKey && e.key === "y") redo();
});

loadImages();
