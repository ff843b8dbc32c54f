// Job manager panel + live progress ticker
// (role parity: ref:interface JobManager + CoreEvent::JobProgress).

import client from "/rspc/client.js";
import { $, el, state } from "/static/js/util.js";

const jobState = new Map(); // id -> live progress event

export function onJobProgress(ev) {
  jobState.set(ev.id, ev);
  $("jobticker").textContent =
    ev.completed_task_count < ev.task_count
      ? `⏳ ${ev.name || "job"} ${ev.completed_task_count}/${ev.task_count}`
      : "";
  if ($("jobs-panel").classList.contains("open")) renderJobs();
}

export async function renderJobs() {
  const reports = await client.jobs.reports(null, state.lib);
  const list = $("jobs-list");
  list.innerHTML = "";
  for (const r of reports) {
    const live = jobState.get(r.id);
    const total = live ? live.task_count : r.task_count;
    const done = live ? live.completed_task_count : r.completed_task_count;
    const running = r.status === "RUNNING" || r.status === "PAUSED";
    const job = el("div", "job " + r.status);
    const row = el("div", "row");
    row.appendChild(el("b", "", r.name));
    row.appendChild(el("span", "status",
      r.status + (total ? ` ${done}/${total}` : "")));
    job.appendChild(row);
    const bar = el("div", "bar");
    const fill = el("i");
    fill.style.width = (total ? Math.round(100 * done / total) :
      (r.status.startsWith("COMPLETED") ? 100 : 0)) + "%";
    bar.appendChild(fill);
    job.appendChild(bar);
    if (r.errors && r.errors.length) {
      const errEl = el("div", "status", r.errors.join("\n"));
      errEl.style.color = "var(--err)";
      errEl.style.whiteSpace = "pre-line";
      job.appendChild(errEl);
    }
    if (running) {
      const act = el("div", "row");
      act.style.marginTop = "6px";
      const pause = el("button", "",
        r.status === "PAUSED" ? "resume" : "pause");
      pause.onclick = async () => {
        await (r.status === "PAUSED" ? client.jobs.resume(r.id)
                                     : client.jobs.pause(r.id));
        renderJobs();
      };
      const cancel = el("button", "danger", "cancel");
      cancel.onclick = async () => {
        await client.jobs.cancel(r.id); renderJobs();
      };
      act.appendChild(pause); act.appendChild(cancel);
      job.appendChild(act);
    }
    list.appendChild(job);
  }
}

export function wireJobsPanel() {
  $("btn-jobs").onclick = () => {
    const p = $("jobs-panel");
    $("drop-panel").classList.remove("open");
    $("settings-panel").classList.remove("open");
    p.classList.toggle("open");
    if (p.classList.contains("open")) renderJobs();
  };
  $("jobs-clear").onclick = async () => {
    await client.jobs.clearAll(null, state.lib); renderJobs();
  };
}
