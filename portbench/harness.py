"""One run of one cell: set-up, the measured window, the trace, the check.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file holds the model (``"model"``: the program's ``ConformerConfig``
fields), and a traffic mix ``traffic/<name>.json`` (:mod:`portbench.traffic`).
Per-layer metrics are readers ``metrics/<name>.py`` found by name.

The window: records run back to back, closed loop, one at a time, as the
serial drivers run them: ``DynamicEvalEngine.__call__`` (built by
``evals.common.build_engine``), then ``decode_output`` (greedy), the
normalizer and the record's word errors.  No record starts after
``seconds``; the one in flight finishes.  The benchmark's own hooks on the
model (registered before ``build_engine``; the engine's working copy keeps
them) note the argmax ids of each window's clean log-probs, for the check,
and with ``trace`` a CUDA event at each call into the model.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.optim.optimizer as optimizer_hooks

from portbench import check, host, traffic, weights as W, yardstick as Y
from portbench.reference.conformer import fp8_quant
from portbench.reference.nsti import check_engine, plan

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    cfg: Dict  # the configuration file
    mix: Dict  # the traffic file
    end_to_end: List[Dict]
    per_layer: List[Dict]
    metrics_dir: Path = HERE / "metrics"


def _reports(metric: Dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, bench: Path = ROOT / "BENCHMARK.json",
              traffic_dir: Path = HERE / "traffic", metrics_dir: Path = HERE / "metrics") -> Cell:
    """The cell's configuration, traffic and metrics, found by name."""
    spec = json.loads(Path(bench).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((Path(bench).parent / conf["file"]).read_text())
    mix = traffic.load(Path(traffic_dir) / f"{w['traffic']}.json")
    check_engine(mix["engine"])
    return Cell(workload, cfg, mix,
                [m for m in spec["end_to_end"] if _reports(m, workload)],
                [m for m in spec["per_layer"] if _reports(m, workload)], Path(metrics_dir))


def reader(metrics_dir: Path, name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = Path(metrics_dir) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    """What the window did with one record."""
    index: int  # its place in the window's order
    frames: int
    windows: List[int]  # valid frames of each window
    wall_s: float
    engine_s: float
    profiled: bool
    step_ms: List[float] = field(default_factory=list)
    untraced_wall_s: Optional[float] = None  # the profiled record run again, untraced


@dataclass
class Run:
    """What a per-layer reader reads."""
    model: Dict
    records: List[Record]
    trace: Optional[object] = None  # tracing.Trace of the profiled record
    profiled: Optional[Record] = None
    peak_bytes: int = 0


class Hooks:
    """Hooks on the model: the argmax ids of the clean copy's log-probs at
    each call (the last item of the engine's batch); with ``timing`` a CUDA
    event as each call starts; while ``spans`` is a list, host spans
    (epoch ns, the profiler's clock) of each call into the model and into
    the optimizer's step.  Closures, not methods: the engine deep-copies
    the model, and with it its hooks, and a closure's state is not copied."""

    def __init__(self, model, timing: bool):
        self.ids: Optional[List] = None
        self.events: Optional[List] = None
        self.spans: Optional[List] = None
        state, opened = self, {}

        def pre(module, args):
            if timing and state.events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                state.events.append(ev)
            opened["forward"] = time.time_ns()

        def post(module, args, out):
            if state.ids is not None:
                state.ids.append(out["final_posteriors"][-1].argmax(-1))
            if state.spans is not None:
                state.spans.append(("forward", opened["forward"], time.time_ns()))

        def opt_pre(optimizer, args, kwargs):
            opened["optimizer"] = time.time_ns()

        def opt_post(optimizer, args, kwargs):
            if state.spans is not None:
                state.spans.append(("optimizer", opened["optimizer"], time.time_ns()))

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)
        self.handles = [optimizer_hooks.register_optimizer_step_pre_hook(opt_pre),
                        optimizer_hooks.register_optimizer_step_post_hook(opt_post)]

    def begin(self):
        self.ids, self.events = [], []

    def remove(self):
        for h in self.handles:
            h.remove()


class Masks:
    """The engine's ``augment_fn``: window k of the current record gets the
    mix's frequency bands ``masks[k]``, filled with the copy's mean."""

    def __init__(self):
        self.masks, self.k = None, 0

    def begin(self, masks):
        self.masks, self.k = masks, 0

    def __call__(self, batch, generator, length):
        band = self.masks[self.k]
        self.k += 1
        fill = batch.mean(dim=(1, 2), keepdim=True)
        return torch.where(band[None, :, None], fill, batch)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


class System:
    """The program under test, built from a cell and a seed: weights made
    on the device, the vocabulary written into a temporary directory, the
    engine from ``build_engine``, the records of the mix."""

    def __init__(self, cell: Cell, seed: int, device, timing: bool = False):
        from dynamic_asr_eval_tpu_torch.evals.common import build_engine
        from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
        from dynamic_asr_eval_tpu_torch.text import load_tokenizer, normalize

        self.device = torch.device(device)
        self.phases, last = [], [time.perf_counter()]

        def tick(name):
            now = time.perf_counter()
            self.phases.append((name, round(now - last[0], 3)))
            last[0] = now

        m, mix = cell.cfg["model"], cell.mix
        self.m, self.engine_cfg = m, mix["engine"]
        self.weights = W.make(m, traffic.substream(seed, 4).integers(2 ** 62), self.device)
        self.blank_bias = W.set_blank_bias(self.weights, m, cell.cfg["assumed"]["blank_emit_share"],
                                           traffic.substream(seed, 5).integers(2 ** 62))
        tick("weights")
        self.pieces = traffic.pieces(m["vocab_size"])
        self.tmp = tempfile.mkdtemp(prefix="portbench_")
        vocab = os.path.join(self.tmp, "pieces.vocab")
        Path(vocab).write_text("\n".join(self.pieces) + "\n", encoding="utf-8")
        self.tokenizer = load_tokenizer(vocab)
        self.records = traffic.make_records(mix, seed, self.pieces, self.device)
        tick("records")
        for rec in self.records:
            rec["gold"] = normalize(rec["text"])
        tick("texts")
        cfg = ConformerConfig.from_dict(m)
        with torch.device(self.device):
            model = SCConformer(cfg)
        model.load_state_dict(self.weights, strict=True)
        self.hooks = Hooks(model, timing)
        e = self.engine_cfg
        args = argparse.Namespace(seq_len=e["seq_len"], overlap=e["overlap"], epochs=e["epochs"],
                                  online=e["online"], shuffle=False, optim_lr=e["lr"],
                                  device=str(self.device))
        self.engine = build_engine(args, model, cfg, "dynamic_eval", device=self.device)
        self.engine.augment_fn = self.masks = Masks()
        self.params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.model = model
        tick("engine")

    def run_record(self, rec: Dict, rec_seed: int):
        """One record as a driver runs it; returns (EngineOutput, raw text,
        word-error counts); the hooks hold the window's ids."""
        from dynamic_asr_eval_tpu_torch.evals.common import decode_output
        from dynamic_asr_eval_tpu_torch.text import normalize, wer_counts

        e = self.engine_cfg
        self.hooks.begin()
        self.masks.begin(rec["masks"])
        out = self.engine(self.params, rec["spec"], e["seq_len"], e["overlap"], rng=rec_seed)
        text = decode_output(out, self.tokenizer)
        counts = wer_counts(normalize(text), rec["gold"])
        return out, text, counts

    def close(self):
        self.hooks.remove()
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.engine = self.model = self.params = None


def warm_up(system: System) -> None:
    """Every shape the window uses: the engine pads each window to
    ``seq_len``, so one record of two windows runs them all (the adapt
    step, the stitch, the decode, the word errors)."""
    e = system.engine_cfg
    frames = min(e["seq_len"] + (e["seq_len"] - e["overlap"]), system.records[0]["frames"])
    rec = dict(system.records[0], spec=system.records[0]["spec"][:, :frames])
    system.run_record(rec, 0)
    if system.device.type == "cuda":
        torch.cuda.synchronize()


def windows_of(rec: Dict, e: Dict) -> List[int]:
    return [n for _, n in plan(rec["frames"], e["seq_len"], e["overlap"])]


def run_window(system: System, seconds: float, seed: int, trace: bool):
    """Records back to back until ``seconds``; returns (records, the kept
    outputs of the checked records, first start, last end, trace, profiled)."""
    from portbench.tracing import Trace

    e, recs = system.engine_cfg, system.records
    pick = int(traffic.substream(seed, 6).integers(0, 3))  # a checked record besides the longest
    kept: Dict[int, Dict] = {}
    longest = None
    done: List[Record] = []
    trace_obj = prof_rec = None
    cuda = system.device.type == "cuda"
    t_start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t_start < seconds:
        rec = recs[i % len(recs)]
        profile = trace and trace_obj is None and time.perf_counter() - t_start >= 0.25 * seconds
        t0 = time.perf_counter()
        if profile:
            # the device alone: recording every host operation too slowed a
            # record 3.8-fold (the host's phases come from the hooks' spans)
            acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                    else torch.profiler.ProfilerActivity.CPU]
            system.hooks.spans = []
            with torch.profiler.profile(activities=acts) as prof:
                out, text, counts = system.run_record(rec, seed * 1_000_003 + i)
            t1 = time.perf_counter()
            trace_obj = Trace.from_profiler(prof, system.hooks.spans)
            system.hooks.spans = None
            del prof
        else:
            out, text, counts = system.run_record(rec, seed * 1_000_003 + i)
            t1 = time.perf_counter()
        r = Record(i, rec["frames"], windows_of(rec, e), t1 - t0, out.elapsed, profile)
        if cuda and system.hooks.events:
            evs = system.hooks.events
            r.step_ms = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
        done.append(r)
        if profile:
            prof_rec = r
        keep = {"ids": system.hooks.ids, "logits": out.logits, "counts": out.counts,
                "text": text, "record": rec}
        if longest is None or rec["frames"] > recs[longest % len(recs)]["frames"]:
            if longest is not None and longest != pick:
                kept.pop(longest, None)
            longest = i
            kept[i] = keep
        if i == pick:
            kept[i] = keep
        del out, keep
        i += 1
    t_end = time.perf_counter()
    return done, kept, t_start, t_end, trace_obj, prof_rec


def time_untraced(system: System, r: Record, seed: int) -> None:
    """The profiled record once more, as the window ran it but untraced,
    after the window: its wall is ``idle_share``'s divisor, for the same
    work as the traced busy time."""
    t0 = time.perf_counter()
    system.run_record(system.records[r.index % len(system.records)], seed * 1_000_003 + r.index)
    r.untraced_wall_s = time.perf_counter() - t0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             process_start: Optional[float] = None, log=print) -> Dict:
    """One run; returns the result line as a dict (without the device's
    name, which the caller adds)."""
    process_start = time.perf_counter() if process_start is None else process_start
    cuda = torch.device(device).type == "cuda"
    t_imported = time.perf_counter()
    system = System(cell, seed, device, timing=trace and cuda)
    t_built = time.perf_counter()
    warm_up(system)
    log(f"blank bias {system.blank_bias!r}; records {len(system.records)}; "
        f"set-up {time.perf_counter() - process_start:.3f} s: imports "
        f"{t_imported - process_start:.3f}, {system.phases}, warm-up "
        f"{time.perf_counter() - t_built:.3f}")
    probe_before = host.probe_ms()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with host.quiet_collector():
        setup_s = time.perf_counter() - process_start
        h0 = host.sample()
        done, kept, t0, t1, trace_obj, prof_rec = run_window(system, seconds, seed, trace)
        h1 = host.sample()
        if prof_rec is not None:
            time_untraced(system, prof_rec, seed)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    wall = t1 - t0
    host_readings = dict(host.between(h0, h1), probe_ms_before=probe_before,
                         probe_ms_after=host.probe_ms())
    log(f"window {wall:.3f} s; record walls {[round(r.wall_s, 3) for r in done]}")
    log(f"host {host_readings}")
    m, e = system.m, system.engine_cfg

    metrics: Dict[str, Dict] = {}
    if not trace:
        values = {
            "rtfx": Y.rtfx([r.frames for r in done], wall),
            "mfu": 100.0 * sum(Y.window_flops(m, n, e["num_negatives"]) for r in done
                               for n in r.windows) / (wall * Y.PEAK_BF16_FLOPS),
            "setup_s": setup_s,
        }
        for metric in cell.end_to_end:
            metrics[metric["name"]] = {"value": values[metric["name"]], "unit": metric["unit"]}
    else:
        run = Run(m, done, trace_obj, prof_rec, peak)
        for metric in cell.per_layer:
            value = reader(cell.metrics_dir, metric["name"])(run)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    # the program's state goes before the reference runs
    checked = [dict(kept[i], index=i) for i in sorted(kept)]
    weights, pieces = system.weights, system.pieces
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    per_record = []
    for c in checked:
        rec = c["record"]
        spec = torch.as_tensor(rec["spec"], device=device, dtype=torch.float32)
        per_record.append(check.judge(weights, m, e, spec, rec["masks"], c, pieces))
    numbers = check.worst(per_record)
    log(f"numbers {numbers}")
    limits = cell.cfg["limits"]
    correct = check.verdict(numbers, limits)
    log(f"checked records {[c['index'] for c in checked]} "
        f"({[c['record']['frames'] for c in checked]} frames) in "
        f"{time.perf_counter() - t_check:.1f} s")
    result = {
        "correct": correct,
        "attempted": len(done),
        "failed": sum(not check.verdict(n, limits) for n in per_record),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "count": 1, "memory_peak_bytes": peak},
    }
    if trace and trace_obj is not None:
        result["device"]["busy_s"] = trace_obj.busy_ns() / 1e9
        result["device"]["window_s"] = prof_rec.wall_s
        result["breakdown"] = {"device_ops": trace_obj.top_ops(), "idle_gaps": trace_obj.idle_gaps()}
    result["host"] = host_readings
    result["checks"] = check.as_entries(numbers, limits)
    result["_check_lines"] = check.lines(numbers, limits)
    return result


def control_numbers(cell: Cell, seed: int, device="cuda", records=None) -> List[Dict]:
    """The precision control: the reference in float8 in the program's place,
    judged as the program is, on ``records`` (indices) of the seed's mix."""
    m, e = cell.cfg["model"], cell.mix["engine"]
    w = W.make(m, traffic.substream(seed, 4).integers(2 ** 62), device)
    W.set_blank_bias(w, m, cell.cfg["assumed"]["blank_emit_share"],
                     traffic.substream(seed, 5).integers(2 ** 62))
    pcs = traffic.pieces(m["vocab_size"])
    recs = traffic.make_records(cell.mix, seed, pcs, device)
    out = []
    for i in records if records is not None else [0]:
        rec = recs[i % len(recs)]
        spec = torch.as_tensor(rec["spec"], device=device, dtype=torch.float32)
        program = check.control(w, m, e, spec, rec["masks"], pcs, fp8_quant)
        out.append(check.judge(w, m, e, spec, rec["masks"], program, pcs))
    return out

