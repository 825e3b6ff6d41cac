"""Benchmark entry: one run of one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload scconformer_xl.nsti.talks --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout.  Prints the card and its power limit, then as
the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, ``host`` (what the host did around the window:
:mod:`portbench.host`), and last ``checks``: each number the comparison read
beside its limit, which are also the last lines of standard error.

Refuses, printing no result, where CUDA is absent or has too few cards, and
where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamic_asr_eval_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def environment() -> None:
    """Caches at fixed paths inside the checkout, so that only a
    checkout's first run builds; libraries that might load JAX told not to;
    one CPU thread a pool: the timed path runs no parallel CPU operation,
    and idle pool threads that spin take cores from the host thread that
    launches the kernels, on a host whose cores other machines share."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[pool] = "1"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    environment()
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from portbench.harness import card_line, load_cell, run_cell

    cell = load_cell(args.workload)
    chips = {w["name"]: w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
             ["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      process_start=PROCESS_START,
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"refused: loaded {found}", file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    check_lines = result.pop("_check_lines")
    checks = result.pop("checks")
    result["checks"] = checks  # last key of the line
    for line in check_lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
