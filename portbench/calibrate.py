"""Readings the limits of ``correct`` are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload scconformer_xl.nsti.talks \
        --seeds 12 --control-seeds 3 --seconds 6 --out calib.jsonl

In one process: for each seed, the program's short window of records (as a
run makes it, the same records checked) and the comparison's numbers; for
the first ``--control-seeds`` seeds, the precision control (the reference in
float8 in the program's place, judged as the program is) on the same
records, and the program with its optimizer step made a no-op (a step that
leaves the state unchanged).  One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", type=int, default=1, help="0: no no-step fault runs")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import dynamic_asr_eval_tpu_torch.optim.madgrad as madgrad
    from portbench import check
    from portbench.harness import System, control_numbers, load_cell, run_window, warm_up

    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    m, e = cell.cfg["model"], cell.mix["engine"]
    sink = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, extra=None):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, **(extra or {})})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def program(seed):
        t0 = time.perf_counter()
        system = System(cell, seed, "cuda")
        warm_up(system)
        done, kept, start, end, _, _ = run_window(system, args.seconds, seed, False)
        w, pcs = system.weights, system.pieces
        system.close()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        per = [check.judge(w, m, e, torch.as_tensor(c["record"]["spec"], device="cuda"),
                           c["record"]["masks"], c, pcs) for c in kept.values()]
        torch.backends.cudnn.allow_tf32 = True
        return per, sorted(kept), [r.frames for r in done], time.perf_counter() - t0

    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        per, idx, frames, took = program(seed)
        emit("program", seed, check.worst(per), {"records": idx, "per_record": per,
                                                  "frames_run": frames, "seconds": took})
        if k < args.control_seeds:
            t0 = time.perf_counter()
            ctl = control_numbers(cell, seed, "cuda", records=idx)
            emit("control_fp8", seed, check.worst(ctl), {"records": idx, "per_record": ctl,
                                                         "seconds": time.perf_counter() - t0})
            if not args.faults:
                continue
            step = madgrad.MADGRAD.step
            madgrad.MADGRAD.step = lambda self, closure=None: None
            try:
                per, idx, _, took = program(seed)
            finally:
                madgrad.MADGRAD.step = step
            emit("fault_no_step", seed, check.worst(per), {"records": idx, "per_record": per,
                                                           "seconds": took})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
