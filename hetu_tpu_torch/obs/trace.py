"""Chrome-trace (chrome://tracing / Perfetto JSON) exporter.

Three sources feed one timeline format:

1. **Schedule renders** — the pipeline engines' own schedule structures
   (`parallel.pipeline_1f1b.schedule_validity`,
   `parallel.pipeline.gpipe_schedule_validity`) drawn as per-stage lanes
   with fwd/bwd/bubble events, so "what does my 1F1B schedule look like"
   is answerable without hardware (the reference draws the same picture
   from its per-op event records, SURVEY §5.1).
2. **Run events** — RunLog records (steps, hot-switch phases, elastic
   re-mesh epochs) converted into wall-clock spans.
3. **Serving flight-recorder traces** — `span` RunLog records
   (HETU_TORCH_SERVE_TRACE, obs/spans.py) rendered as one lane per decode
   slot showing request occupancy, a queue lane, counter lanes for
   queue depth / page utilization, and instants for
   admissions/evictions/reshards (`serving_trace`).  Serving records
   also ride `merge_runlogs`, so a serving worker's lifecycle merges
   into the same cluster timeline as training RunLogs.

Copied from `hetu_tpu/obs/trace.py` (host-only code).  The schedule
renders read the pipeline engines, which the port does not have yet:
`pipeline_schedule_trace` and `schedule_bubble_fraction` raise
NotImplementedError naming the slice that brings them.

Open the saved JSON at https://ui.perfetto.dev or chrome://tracing.

Format: the Trace Event JSON array form — each event carries at least
`name`, `ph`, `ts` (microseconds), `pid`; complete events ("ph": "X") add
`dur`; instant events use "ph": "i"; counter lanes use "ph": "C".
"""
from __future__ import annotations

import contextlib
import json
import math
import time
from typing import Any, Dict, Iterable, List, Optional

#: the slice that brings the pipeline engines the schedule renders draw
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


class ChromeTrace:
    """Accumulates trace events; `save()`/`to_json()` emit the JSON array
    form that chrome://tracing and Perfetto accept directly."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    def add_complete(self, name: str, ts_us: float, dur_us: float, *,
                     pid: Any = 0, tid: Any = 0, cat: str = "",
                     args: Optional[Dict] = None):
        ev = {"name": name, "ph": "X", "ts": float(ts_us),
              "dur": float(dur_us), "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def add_instant(self, name: str, ts_us: float, *, pid: Any = 0,
                    tid: Any = 0, cat: str = "",
                    args: Optional[Dict] = None):
        ev = {"name": name, "ph": "i", "ts": float(ts_us), "pid": pid,
              "tid": tid, "s": "p"}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def add_flow(self, name: str, flow_id: Any, *, start_ts_us: float,
                 finish_ts_us: float, start_pid: Any = 0,
                 start_tid: Any = 0, finish_pid: Any = 0,
                 finish_tid: Any = 0, cat: str = "flow"):
        """Flow-event pair ("ph": "s" / "f") — Perfetto draws an arrow
        from the slice enclosing the start point to the slice enclosing
        the finish point, connecting lanes (tiers) causally.  The pair
        is matched by (cat, id); `bp: "e"` binds the finish to the
        ENCLOSING slice rather than the next one."""
        self.events.append({"name": name, "ph": "s", "id": str(flow_id),
                            "ts": float(start_ts_us), "pid": start_pid,
                            "tid": start_tid, "cat": cat})
        self.events.append({"name": name, "ph": "f", "bp": "e",
                            "id": str(flow_id),
                            "ts": float(finish_ts_us), "pid": finish_pid,
                            "tid": finish_tid, "cat": cat})

    def add_counter(self, name: str, ts_us: float, values: Dict[str, float],
                    *, pid: Any = 0):
        """Counter event ("ph": "C") — Perfetto draws each series of
        `values` as a stacked area lane under `name`."""
        self.events.append({"name": name, "ph": "C", "ts": float(ts_us),
                            "pid": pid,
                            "args": {k: float(v)
                                     for k, v in values.items()}})

    def name_thread(self, pid: Any, tid: Any, name: str):
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "ts": 0,
                            "args": {"name": name}})

    def name_process(self, pid: Any, name: str):
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "ts": 0, "args": {"name": name}})

    @contextlib.contextmanager
    def span(self, name: str, *, pid: Any = 0, tid: Any = 0, cat: str = "",
             args: Optional[Dict] = None):
        """Wall-clock complete event over the with-block (ts relative to
        trace construction)."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self.add_complete(name, (t0 - self._t0) * 1e6,
                              (t1 - t0) * 1e6, pid=pid, tid=tid, cat=cat,
                              args=args)

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self.events)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


# ---------------------------------------------------------------------------
# schedule renders
# ---------------------------------------------------------------------------

def pipeline_schedule_trace(pp: int, n_micro: int, *,
                            schedule: str = "1f1b",
                            fwd_us: float = 1000.0,
                            bwd_us: float = 2000.0) -> ChromeTrace:
    """Render a micro-batch pipeline schedule as per-stage timeline lanes.

    Lanes come from the engines' OWN schedule structures, so the picture is
    the executed schedule, not a diagram: 1F1B uses
    pipeline_1f1b.schedule_validity (lockstep rounds, fwd half + bwd half),
    GPipe uses pipeline.gpipe_schedule_validity (fill/steady forwards, then
    the autodiff-reversed backwards).  `fwd_us`/`bwd_us` are per-micro
    nominal durations (B ~ 2F by default); feed measured values for a
    to-scale render.
    """
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"schedule must be '1f1b' or 'gpipe', "
                         f"got {schedule!r}")
    raise NotImplementedError(
        "pipeline schedule renders draw the pipeline engines' own "
        "schedules, which are not in the port yet; they arrive with "
        f"{_MULTI_GPU}")


def schedule_bubble_fraction(pp: int, n_micro: int,
                             schedule: str = "1f1b",
                             fwd_us: float = 1.0,
                             bwd_us: float = 2.0) -> float:
    """Fraction of lane time spent idle in the rendered schedule — the
    analytic pipeline-bubble overhead ((pp-1)/(n_micro+pp-1) for GPipe)."""
    tr = pipeline_schedule_trace(pp, n_micro, schedule=schedule,
                                 fwd_us=fwd_us, bwd_us=bwd_us)
    busy = sum(e["dur"] for e in tr.events
               if e.get("ph") == "X" and e.get("cat") in ("fwd", "bwd"))
    idle = sum(e["dur"] for e in tr.events
               if e.get("ph") == "X" and e.get("cat") == "bubble")
    total = busy + idle
    return idle / total if total else 0.0


# ---------------------------------------------------------------------------
# run-event conversion (RunLog -> timeline)
# ---------------------------------------------------------------------------

def _name_run_lanes(tr: ChromeTrace, pid: Any, title: str,
                    serving: bool = False):
    tr.name_process(pid, title)
    tr.name_thread(pid, "train", "train steps")
    tr.name_thread(pid, "switch", "hot switches")
    tr.name_thread(pid, "elastic", "elastic epochs")
    tr.name_thread(pid, "health", "anomalies / faults / stragglers")
    if serving:
        tr.name_thread(pid, "serving", "serving requests / spans")


def _has_serving(recs: Iterable[Dict[str, Any]]) -> bool:
    return any(r.get("kind") in ("serve", "span") for r in recs)


def _driver_to_wall_offset(recs: List[Dict[str, Any]]) -> Optional[float]:
    """Wall seconds to add to a serving record's DRIVER-clock stamp
    (`span` t0/t1, `serve` now) to land it on this log's wall timeline.
    Estimated once from the first stamped record: the engine's virtual
    clock idle-skips and compresses wall time, so per-record anchoring
    would overlap spans — one run-level offset keeps the serving lane
    internally consistent (and exact for live servers, where the driver
    clock IS wall time)."""
    for r in recs:
        if r.get("kind") == "span" and r.get("t1") is not None:
            return float(r["t"]) - float(r["t1"])
        if r.get("kind") == "serve" and r.get("now") is not None:
            return float(r["t"]) - float(r["now"])
    return None


def _emit_run_events(tr: ChromeTrace, recs: List[Dict[str, Any]],
                     pid: Any, t0: float, offset_s: float = 0.0):
    """Draw RunLog records into `tr` under process `pid`; each record's
    wall time is shifted by `offset_s` (a worker-clock -> reference-clock
    correction) before being made relative to `t0`."""
    drv_off = _driver_to_wall_offset(recs)
    for r in recs:
        ts = (float(r["t"]) + offset_s - t0) * 1e6
        kind = r.get("kind")
        if kind == "step":
            dur = float(r.get("step_time_s") or 0.0) * 1e6
            # RunLog stamps t at record time (step END); draw from start
            tr.add_complete(f"step {r.get('step')}", ts - dur, dur,
                            pid=pid, tid="train", cat="step",
                            args={k: r[k] for k in
                                  ("loss", "tokens_per_s", "plan",
                                   "device_mem_bytes")
                                  if r.get(k) is not None})
        elif kind == "switch":
            dur = float(r.get("wall_s") or 0.0) * 1e6
            tr.add_complete(
                f"switch {r.get('from_id')}->{r.get('to_id')}", ts - dur,
                dur, pid=pid, tid="switch", cat="switch",
                args={k: r[k] for k in ("moved_bytes", "total_bytes")
                      if r.get(k) is not None})
        elif kind == "elastic_epoch":
            tr.add_instant(f"epoch {r.get('epoch')}", ts, pid=pid,
                           tid="elastic", cat="elastic",
                           args={"alive": r.get("alive")})
        elif kind == "compile":
            dur = float(r.get("compile_s") or 0.0) * 1e6
            tr.add_complete(f"compile {r.get('name')}", ts - dur, dur,
                            pid=pid, tid="train", cat="compile")
        elif kind == "anomaly":
            tr.add_instant(f"anomaly {r.get('anomaly')}", ts, pid=pid,
                           tid="health", cat="anomaly",
                           args={k: r[k] for k in ("step", "value",
                                                   "baseline")
                                 if r.get(k) is not None})
        elif kind == "fault":
            tr.add_instant(f"fault {r.get('fault')}", ts, pid=pid,
                           tid="health", cat="fault",
                           args={k: r[k] for k in ("step", "detail",
                                                   "error", "generation")
                                 if r.get(k) is not None})
        elif kind == "straggler":
            tr.add_instant("straggler report", ts, pid=pid, tid="health",
                           cat="straggler",
                           args={"stragglers": r.get("stragglers")})
        elif kind == "span" and r.get("t0") is not None \
                and drv_off is not None:
            # serving flight-recorder spans in the MERGED view: driver
            # stamps mapped onto the wall timeline through the ONE
            # run-level offset (per-record anchoring would overlap
            # spans whenever the virtual clock idle-skipped).  The
            # per-slot driver-clock picture is `serving_trace`'s job.
            s0 = (float(r["t0"]) + drv_off + offset_s - t0) * 1e6
            dur = max(0.0, float(r.get("t1", r["t0"]))
                      - float(r["t0"])) * 1e6
            tr.add_complete(f"r{r.get('req')} {r.get('span')}", s0,
                            dur, pid=pid, tid="serving",
                            cat=f"span:{r.get('span')}",
                            args={k: r[k] for k in
                                  ("slot", "slo_class", "reason",
                                   "tokens", "chunk", "segment")
                                  if r.get(k) is not None})
        elif kind == "numerics":
            # one counter lane per scope (ph "C"): Perfetto draws each
            # scope's scalar stats as stacked area over the run — the
            # numerics observatory's timeline view (underflow ramps and
            # SNR collapses are visible as shape, not just as the
            # detector firings on the health lane)
            for scope, stats in sorted((r.get("scopes") or {}).items()):
                vals = {name: float(v) for name, v in stats.items()
                        if isinstance(v, (int, float))
                        and math.isfinite(float(v))
                        and name in ("rms", "absmax", "underflow_frac",
                                     "overflow_frac", "snr_db",
                                     "entropy", "load_max", "dropped")}
                if vals:
                    tr.add_counter(f"numerics/{scope}", ts, vals, pid=pid)
        elif kind == "scaler":
            tr.add_instant(f"scaler {r.get('event')}", ts, pid=pid,
                           tid="health", cat="scaler",
                           args={k: r[k] for k in ("scale", "prev", "step")
                                 if r.get(k) is not None})
        elif kind == "serve":
            ev = r.get("event")
            if ev in ("admit", "done", "reshard"):
                if r.get("now") is not None and drv_off is not None:
                    ts = (float(r["now"]) + drv_off + offset_s - t0) * 1e6
                tr.add_instant(f"serve {ev} r{r.get('req')}"
                               if r.get("req") is not None
                               else f"serve {ev}", ts, pid=pid,
                               tid="serving", cat=f"serve:{ev}",
                               args={k: r[k] for k in
                                     ("slot", "reason", "tier", "tenant",
                                      "queue_depth", "page_util")
                                     if r.get(k) is not None})


def trace_from_runlog(records: Iterable[Dict[str, Any]]) -> ChromeTrace:
    """Convert RunLog records into a wall-clock timeline: step spans on a
    'train' lane, hot-switch phases on a 'switch' lane, elastic epochs as
    instants on an 'elastic' lane, anomalies/faults/straggler reports on
    a 'health' lane."""
    recs = [r for r in records if isinstance(r, dict) and "t" in r]
    tr = ChromeTrace()
    if not recs:
        return tr
    t0 = min(float(r["t"]) for r in recs)
    pid = "run"
    _name_run_lanes(tr, pid, "training run", serving=_has_serving(recs))
    _emit_run_events(tr, recs, pid, t0)
    return tr


def numerics_trace(records: Iterable[Dict[str, Any]]) -> ChromeTrace:
    """Standalone numerics timeline: ONLY the per-scope counter lanes
    (plus scaler transitions and anomaly instants for context) from a
    RunLog — what ``tools_numerics.py --chrome-trace`` writes.  The full
    run view (steps/compiles/serving interleaved) is
    :func:`trace_from_runlog`'s job; this one stays readable when a long
    run's step lane would drown the counters."""
    recs = [r for r in records if isinstance(r, dict) and "t" in r
            and r.get("kind") in ("numerics", "scaler", "anomaly")]
    tr = ChromeTrace()
    if not recs:
        return tr
    t0 = min(float(r["t"]) for r in recs)
    pid = "numerics"
    tr.name_process(pid, "numerics observatory")
    _emit_run_events(tr, recs, pid, t0)
    return tr


def merge_runlogs(runlogs: Dict[Any, Iterable[Dict[str, Any]]],
                  offsets_s: Optional[Dict[Any, float]] = None
                  ) -> ChromeTrace:
    """Merge several workers' RunLogs into ONE cluster timeline: pid per
    worker, the same lanes per worker as `trace_from_runlog`, timestamps
    aligned onto a common (server) clock via per-worker offsets.

    `runlogs` maps worker id -> records (e.g. ``RunLog.read(path)`` per
    worker); `offsets_s` maps worker id -> that worker's clock offset in
    seconds (server_time ~= worker_time + offset).  The coordinator
    estimates offsets from heartbeat-RTT-corrected telemetry pushes —
    take them from a ClusterSnapshot with
    ``obs.aggregate.merge_offsets(snapshot)``.  Missing offsets default
    to 0 (same-host workers)."""
    offsets = offsets_s or {}
    per: Dict[Any, List[Dict[str, Any]]] = {}
    for worker, records in runlogs.items():
        per[worker] = [r for r in records
                       if isinstance(r, dict) and "t" in r]
    tr = ChromeTrace()
    all_t = [float(r["t"]) + float(offsets.get(w, 0.0))
             for w, recs in per.items() for r in recs]
    if not all_t:
        return tr
    t0 = min(all_t)
    for worker in sorted(per, key=str):
        off = float(offsets.get(worker, 0.0))
        pid = f"worker {worker}"
        _name_run_lanes(tr, pid, f"worker {worker}",
                        serving=_has_serving(per[worker]))
        _emit_run_events(tr, per[worker], pid, t0, offset_s=off)
    return tr


# ---------------------------------------------------------------------------
# serving flight-recorder render (span records -> per-slot lanes)
# ---------------------------------------------------------------------------

def serving_trace(records: Iterable[Dict[str, Any]], *,
                  pid: Any = "serving") -> ChromeTrace:
    """Render a serving run's flight-recorder records as the per-slot
    timeline (driver-clock basis, so a replayed virtual-clock run draws
    deterministically):

    * one lane per decode slot — each request's prefill chunks, decode
      segments and reshard pauses drawn where the slot actually spent
      its time (`r<rid> <kind>` complete events, cat = span kind),
    * a ``queue`` lane with every request's queued span (args carry the
      no_slot/no_pages stall attribution),
    * an ``events`` lane with admission / eviction(done) / reshard
      instants (from the ``serve`` events' driver-clock ``now`` stamp),
    * counter lanes ``queue_depth`` and ``page_util`` sampled at every
      serve event.

    Open at https://ui.perfetto.dev.  Records come straight from
    ``RunLog.read``; non-serving records are ignored, so a mixed log
    renders its serving slice."""
    from hetu_tpu_torch.obs.spans import collect_traces
    recs = [r for r in records if isinstance(r, dict)]
    traces = collect_traces(recs)
    tr = ChromeTrace()
    tr.name_process(pid, "serving engine")
    tr.name_thread(pid, "queue", "queue (stall attribution)")
    tr.name_thread(pid, "events", "admissions / evictions / reshards")
    slots = sorted({s.slot for t in traces.values() for s in t.spans
                    if s.slot is not None})
    for s in slots:
        tr.name_thread(pid, f"slot {s}", f"decode slot {s}")

    for rid in sorted(traces):
        t = traces[rid]
        for sp in t.spans:
            args = dict(sp.attrs, slo_class=sp.slo_class, trace=sp.trace)
            ts, dur = sp.t0 * 1e6, sp.dur_s * 1e6
            if sp.kind == "queued":
                tr.add_complete(f"r{rid} queued", ts, dur, pid=pid,
                                tid="queue", cat="queued", args=args)
            elif sp.kind in ("prefill", "decode", "reshard_pause"):
                tid = f"slot {sp.slot}" if sp.slot is not None else "queue"
                tr.add_complete(f"r{rid} {sp.kind}", ts, dur, pid=pid,
                                tid=tid, cat=sp.kind, args=args)
            else:   # terminal: a zero-duration marker on the slot lane
                tid = f"slot {sp.slot}" if sp.slot is not None else "events"
                tr.add_instant(f"r{rid} {sp.kind}", ts, pid=pid, tid=tid,
                               cat=sp.kind, args=args)

    for r in recs:
        if r.get("kind") != "serve" or r.get("now") is None:
            continue
        ts = float(r["now"]) * 1e6
        ev = r.get("event")
        if ev in ("admit", "done", "reshard"):
            tr.add_instant(f"{ev} r{r.get('req')}"
                           if r.get("req") is not None else ev,
                           ts, pid=pid, tid="events", cat=f"serve:{ev}",
                           args={k: r[k] for k in
                                 ("slot", "reason", "tier", "slo_class",
                                  "tenant")
                                 if r.get(k) is not None})
        counters = {k: r[k] for k in ("queue_depth", "page_util")
                    if r.get(k) is not None}
        for name, v in counters.items():
            tr.add_counter(name, ts, {name: v}, pid=pid)
    return tr


# ---------------------------------------------------------------------------
# stitched fleet render (FleetTrace DAGs -> flow-connected tier lanes)
# ---------------------------------------------------------------------------

def stitched_trace(fleet_traces, *, pid: Any = "fleet") -> ChromeTrace:
    """Render stitched :class:`obs.spans.FleetTrace` DAGs as ONE
    flow-connected multi-tier timeline (what ``tools_fleet.py
    --chrome-trace`` writes when the run was traced):

    * one lane per fleet hop identity (``prefill/0``, ``decode/1``, a
      bare ``decode`` for unstamped single-engine runs) plus a
      ``frontend`` lane — each hop's spans drawn as complete events,
      terminals as instants,
    * every causal edge drawn as a **flow arrow** ("ph": "s"/"f" pairs,
      matched by id, finish bound to the enclosing slice via
      ``bp: "e"``) connecting the lanes: dispatch (frontend -> hop
      queued), ship/adopt (prefill -> decode), hedge fork/win/withdraw,
      replay re-admissions and dead-tier fallbacks,

    so the cross-tier causality that `FleetTrace.validate` checks
    numerically is *visible* — follow the arrows from frontend through
    prefill and shipment into the decode lane that produced the client
    result.  Accepts the dict `FleetTrace.stitch` returns (or any
    iterable of FleetTraces); timestamps are the spans' own (driver)
    clock basis, so replayed virtual-clock runs draw deterministically."""
    from hetu_tpu_torch.obs.spans import TERMINAL_KINDS
    tr = ChromeTrace()
    tr.name_process(pid, "fleet (stitched)")
    tr.name_thread(pid, "frontend", "frontend / client")
    fts = (fleet_traces.values() if isinstance(fleet_traces, dict)
           else list(fleet_traces))
    fts = sorted(fts, key=lambda ft: ft.rid)
    lanes: Dict[str, str] = {}      # hop trace id -> lane tid
    for ft in fts:
        for h in ft.hops:
            lanes.setdefault(h.trace, ft.hop_label(h))
    for tid in sorted(set(lanes.values())):
        tr.name_thread(pid, tid, f"{tid} hop")

    def lane_of(trace_id: Any) -> str:
        return lanes.get(trace_id, "frontend")

    def enclosing_ts(trace_id: Any, t_us: float) -> float:
        """Nudge a flow endpoint inside the hop's span coverage so the
        arrow binds to a slice (edges stamp the boundary instant, which
        can fall exactly between two slices)."""
        hop = hop_by_trace.get(trace_id)
        if hop is None or not hop.spans:
            return t_us
        lo, hi = hop.spans[0].t0 * 1e6, hop.spans[-1].t1 * 1e6
        return min(max(t_us, lo), hi)

    flow_id = 0
    for ft in fts:
        hop_by_trace = {h.trace: h for h in ft.hops}
        for h in ft.hops:
            tid = lanes[h.trace]
            for sp in h.spans:
                args = dict(sp.attrs, slo_class=sp.slo_class,
                            trace=sp.trace)
                ts = sp.t0 * 1e6
                if sp.kind in TERMINAL_KINDS:
                    tr.add_instant(f"r{ft.rid} {sp.kind}", ts, pid=pid,
                                   tid=tid, cat=sp.kind, args=args)
                else:
                    tr.add_complete(f"r{ft.rid} {sp.kind}", ts,
                                    max(0.0, sp.t1 - sp.t0) * 1e6,
                                    pid=pid, tid=tid, cat=sp.kind,
                                    args=args)
        for e in ft.edges:
            t_us = float(e.get("t", 0.0)) * 1e6
            src, dst = lane_of(e.get("src")), lane_of(e.get("dst"))
            flow_id += 1
            tr.add_flow(f"r{ft.rid} {e['kind']}", f"r{ft.rid}.{flow_id}",
                        start_ts_us=enclosing_ts(e.get("src"), t_us),
                        finish_ts_us=enclosing_ts(e.get("dst"), t_us),
                        start_pid=pid, start_tid=src,
                        finish_pid=pid, finish_tid=dst,
                        cat=f"edge:{e['kind']}")
    return tr
