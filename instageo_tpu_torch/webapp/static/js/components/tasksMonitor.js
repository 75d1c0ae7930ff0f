/* tasksMonitor.js — task-history dialog (reference components/
 * TasksMonitor.js, 927 LoC): fetch /api/tasks; free-text task-id search,
 * status + model filters with clear; 5-per-page pagination; 15s auto-poll
 * while any task is active; per-task card with status chip, 3-stage
 * progress bar, stage icons, expandable details (parameters, bboxes,
 * errors, timings); visualize button that loads /api/visualize and opens
 * the visualization dialog; sign-in prompt on auth errors. */

import { el, iconButton, openDialog, chip, progressBar, spinner, formatDate,
         svgIcon, ICONS, showSnackbar } from "../ui.js";
import { apiService, fetchModelsWithTTL, isAuthenticationError }
  from "../api.js";
import { isAuthConfigured, loginWithRedirect } from "../auth.js";
import { CONFIG } from "../config.js";
import { openVisualizationDialog } from "./vizDialog.js";

const TASKS_PER_PAGE = 5;
const STAGE_NAMES = {
  data_processing: "Data Processing",
  model_prediction: "Model Prediction",
  visualization_preparation: "Visualization Preparation",
};

const STATUS_COLORS = {
  completed: "var(--success)",
  failed: "var(--error)",
  running: "var(--info)",
  pending: "var(--muted)",
};

function statusColor(status) {
  if (!status) return STATUS_COLORS.pending;
  if (status === "completed") return STATUS_COLORS.completed;
  if (status === "failed" || status === "timed_out") return STATUS_COLORS.failed;
  if (String(status).includes("pending")) return STATUS_COLORS.pending;
  return STATUS_COLORS.running;
}

function statusIcon(status) {
  if (status === "completed") return "check";
  if (status === "failed" || status === "timed_out") return "error";
  if (!status || String(status).includes("pending")) return "schedule";
  return "play";
}

function taskProgress(task) {
  const stages = task.stages || {};
  let done = 0;
  for (const s of Object.keys(STAGE_NAMES)) {
    if ((stages[s] || {}).status === "completed") done++;
  }
  return (done / 3) * 100;
}

export function createTasksMonitor({ onAddTaskLayer }) {
  let dialog = null;
  let tasks = [];
  let models = [];
  let loading = false;
  let error = null;
  let searchTerm = "";
  let statusFilter = "all";
  let modelFilter = "all";
  let page = 1;
  let expanded = null;
  let pollTimer = null;

  function filteredTasks() {
    let out = tasks;
    if (searchTerm) {
      const needle = searchTerm.toLowerCase();
      out = out.filter((t) =>
        (t.task_id || "").toLowerCase().includes(needle));
    }
    if (statusFilter !== "all") {
      out = out.filter((t) => (t.status || "") === statusFilter);
    }
    if (modelFilter !== "all") {
      out = out.filter((t) => (t.model_key || "") === modelFilter);
    }
    return out;
  }

  async function fetchTasks() {
    loading = true;
    error = null;
    render();
    try {
      tasks = (await apiService.getAllTasks()) || [];
      tasks.sort((a, b) => (b.created_at || 0) - (a.created_at || 0));
    } catch (e) {
      error = e.message;
    }
    loading = false;
    render();
  }

  async function fetchModels() {
    try {
      models = (await fetchModelsWithTTL()) || [];
    } catch (e) { models = []; }
  }

  function startPolling() {
    stopPolling();
    pollTimer = setInterval(() => {
      const active = tasks.some(
        (t) => t.status !== "completed" && t.status !== "failed");
      if (active) fetchTasks();
    }, CONFIG.TASK_POLL_MS);
  }

  function stopPolling() {
    if (pollTimer) { clearInterval(pollTimer); pollTimer = null; }
  }

  async function handleVisualize(task) {
    try {
      const viz = await apiService.visualizeTask(task.task_id);
      const layers = viz.layers || viz;
      if (!layers || (!layers.predictions && !layers.chips)) {
        throw new Error("Visualization data is not available yet for this task");
      }
      openVisualizationDialog({
        task: { ...task, titiler_data: layers },
        models,
        onAddToMap: (layerData) => {
          onAddTaskLayer(layerData);
          if (dialog) dialog.close();
        },
      });
    } catch (e) {
      showSnackbar(`Failed to load visualization data: ${e.message}`, "error");
    }
  }

  function stageRow(name, stage) {
    const st = stage || {};
    const done = st.finished_at || st.completed_at;  // backend: finished_at
    const dur = st.started_at && done
      ? ` (${(done - st.started_at).toFixed(0)}s)` : "";
    return el("div", { class: "stage-row" },
      el("span", { class: "stage-icon",
                   style: { color: statusColor(st.status) } },
        svgIcon(ICONS[statusIcon(st.status)], 14)),
      el("span", { class: "stage-name" }, STAGE_NAMES[name] || name),
      el("span", { class: "stage-status" }, st.status || "pending", dur),
      st.error ? el("div", { class: "stage-error" }, st.error) : null);
  }

  function taskCard(task) {
    const isExpanded = expanded === task.task_id;
    const canViz = task.status === "completed";
    const card = el("div", { class: "task-card", dataset:
                             { taskId: task.task_id } });
    const header = el("div", { class: "task-card-head" },
      el("div", { class: "task-id mono" }, task.task_id),
      chip(task.status || "pending", statusColor(task.status)));
    const meta = el("div", { class: "task-meta" },
      el("span", {}, `${task.model_key || "?"}${
        task.model_size ? ` / ${task.model_size}` : ""}`),
      el("span", {}, formatDate(task.created_at)));
    const prog = progressBar(taskProgress(task));
    const actions = el("div", { class: "task-actions" },
      el("button", {
        class: "btn small", onclick: () => {
          expanded = isExpanded ? null : task.task_id;
          render();
        },
      }, isExpanded ? "Hide details" : "Details"),
      el("button", {
        class: `btn small ${canViz ? "primary" : ""}`,
        disabled: canViz ? null : "true",
        title: canViz ? "Visualize results"
                      : "Available when the task completes",
        onclick: () => canViz && handleVisualize(task),
      }, "Visualize"));
    card.append(header, meta, prog, actions);

    if (isExpanded) {
      const stages = task.stages || {};
      const details = el("div", { class: "task-details" },
        el("div", { class: "detail-title" }, "Stages"),
        ...Object.keys(STAGE_NAMES).map((s) => stageRow(s, stages[s])),
        el("div", { class: "detail-title" }, "Parameters"),
        el("pre", { class: "mono small-pre" },
          JSON.stringify(task.parameters || {}, null, 1)),
        el("div", { class: "detail-title" }, "Bounding boxes"),
        el("pre", { class: "mono small-pre" },
          JSON.stringify(task.bboxes || [], null, 1)),
        task.error
          ? el("div", { class: "stage-error" }, `Error: ${task.error}`)
          : null);
      card.append(details);
    }
    return card;
  }

  let listBox = null;
  let toolbar = null;
  let modelSel = null;
  let searchInput = null;
  let statusSel = null;

  function buildToolbar() {
    // Built ONCE per dialog open: a full re-render on every keystroke
    // would destroy the focused search input (reference keeps these as
    // controlled React inputs for the same reason).
    statusSel = el("select", { class: "input small-input",
      onchange: (e) => { statusFilter = e.target.value; page = 1; render(); } },
      ...["all", "data_processing", "model_prediction",
          "visualization_preparation", "completed", "failed"]
        .map((s) => {
          const o = el("option", { value: s },
            s === "all" ? "All statuses" : s.replace(/_/g, " "));
          if (s === statusFilter) o.selected = true;
          return o;
        }));
    modelSel = el("select", { class: "input small-input",
      onchange: (e) => { modelFilter = e.target.value; page = 1; render(); } });
    refreshModelOptions();
    searchInput = el("input", {
      class: "input small-input", type: "search",
      placeholder: "Search by task ID…", value: searchTerm,
      oninput: (e) => { searchTerm = e.target.value; page = 1; render(); },
    });
    toolbar = el("div", { class: "monitor-toolbar" },
      searchInput, statusSel, modelSel,
      el("button", { class: "btn small", onclick: () => {
        searchTerm = ""; statusFilter = "all"; modelFilter = "all";
        searchInput.value = "";
        statusSel.value = "all";
        modelSel.value = "all";
        page = 1; render();
      } }, "Clear"),
      iconButton("refresh", "Refresh", fetchTasks));
    return toolbar;
  }

  function refreshModelOptions() {
    if (!modelSel) return;
    modelSel.replaceChildren(
      ...["all", ...new Set(models.map((m) => m.model_key))].map((k) => {
        const o = el("option", { value: k },
          k === "all" ? "All models" : k);
        if (k === modelFilter) o.selected = true;
        return o;
      }));
  }

  function render() {
    if (!dialog || !listBox) return;
    const body = listBox;
    body.innerHTML = "";

    if (error) {
      const authError = isAuthenticationError(error);
      body.append(el("div", { class: "alert error" },
        el("span", {}, error),
        authError && isAuthConfigured()
          ? el("button", { class: "btn small primary",
                           onclick: () => loginWithRedirect() }, "Sign in")
          : null));
    }
    if (loading && !tasks.length) {
      body.append(el("div", { class: "center" }, spinner(32)));
      return;
    }

    const filtered = filteredTasks();
    if (!filtered.length) {
      body.append(el("div", { class: "empty" },
        tasks.length ? "No tasks match the filters."
                     : "No tasks yet. Draw a bounding box and run a model."));
      return;
    }

    const totalPages = Math.max(1, Math.ceil(filtered.length / TASKS_PER_PAGE));
    page = Math.min(page, totalPages);
    const start = (page - 1) * TASKS_PER_PAGE;
    for (const task of filtered.slice(start, start + TASKS_PER_PAGE)) {
      body.append(taskCard(task));
    }

    // pagination
    const pager = el("div", { class: "pager" });
    for (let p = 1; p <= totalPages; p++) {
      pager.append(el("button", {
        class: `btn small ${p === page ? "primary" : ""}`,
        onclick: () => { page = p; render(); },
      }, String(p)));
    }
    if (totalPages > 1) body.append(pager);
  }

  function open() {
    if (dialog) return;
    listBox = el("div", { class: "monitor-list" });
    dialog = openDialog({
      title: "Task History",
      wide: true,
      id: "tasks-monitor",
      content: el("div", {}, buildToolbar(), listBox),
      onClose: () => { stopPolling(); dialog = null; listBox = null; },
    });
    fetchModels().then(() => { refreshModelOptions(); render(); });
    fetchTasks();
    startPolling();
  }

  return { open, fetchTasks };
}
