"""The port's NSTI driver with ``--dp_records`` and ``--dp`` over N ranks
(``torch.distributed.run``, one process a card) against the serial driver
in one process, on the same ``synthetic_spec`` records: equal transcripts
and WER, in f32 with TF32 off and cuDNN deterministic.

    python3 multicard_check.py [--nproc 4] [--device cpu]

Prints one JSON line and exits non-zero where a run differs.  A small f32
model (2 x 64) keeps it quick; five records of 30720, 22528, 16384, 8192
and 30720 frames at seq 16384 / overlap 14336 make a padded last group on
4 ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

MODEL = {"feat_in": 80, "n_layers": 2, "d_model": 64, "n_heads": 2, "head_dim": 32,
         "subsampling_factor": 4, "subsampling_conv_channels": 8, "conv_kernel_size": 5,
         "compute_dtype": "float32"}
FRAMES = "30720,22528,16384,8192,30720"
KWARGS = ["-kwargs", "epochs=1", "optim_lr=9e-5", "seed=0"]
# set in the runs this script starts: the process is one rank (or the
# serial run) of the driver; an environment variable, as a flag could clash
# with torch.distributed.run's own (prefix-matched) options
RANK_RUN = "MULTICARD_CHECK_RANK_RUN"


def driver(argv) -> None:
    """One rank (or the serial run): ``evals.run`` at parity precision."""
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn, set_parity_precision
    from dynamic_asr_eval_tpu_torch.evals import run

    set_parity_precision()
    with deterministic_cudnn():
        run.cli(argv)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nproc", type=int, default=4)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DAE_SYNTH_SPEC_FRAMES=FRAMES,
               PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        config = os.path.join(tmp, "model.yaml")  # JSON is YAML in flow style
        with open(config, "w") as f:
            json.dump({"model": MODEL}, f)
        common = ["-d", "synthetic_spec", "--quiet", "--config", config, "-seq", "16384",
                  "-o", "14336"] + (["--device", args.device] if args.device else [])
        launch = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={args.nproc}",
                  "--master_port", "29611"]
        runs = {"serial": ([], []), "dp_records": (launch, ["--dp_records"]),
                "serial_offline": ([], ["online=false"]), "dp": (launch, ["--dp"])}
        for name, (prefix, extra) in runs.items():
            flags = [x for x in extra if x.startswith("--")]
            kwargs = KWARGS + [x for x in extra if not x.startswith("--")]
            out = os.path.join(tmp, f"{name}.pkl")
            cmd = (prefix or [sys.executable]) + [os.path.abspath(__file__), *common, "-s", out,
                                                  *flags, *kwargs]
            proc = subprocess.run(cmd, env={**env, RANK_RUN: "1"}, capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode:
                print(f"{name}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                      f"{proc.stderr[-6000:]}", file=sys.stderr)
                return proc.returncode
            with open(out[:-4] + "_1.pkl", "rb") as f:
                results[name] = pickle.load(f)
    line = {"nproc": args.nproc, "records": len(FRAMES.split(","))}
    ok = True
    for name, ref in (("dp_records", "serial"), ("dp", "serial_offline")):
        same = results[name]["model_output"] == results[ref]["model_output"]
        line[name] = {"transcripts_equal": same, "wer": results[name]["wer"],
                      "serial_wer": results[ref]["wer"], "words": results[ref]["words"]}
        ok = ok and same and results[name]["wer"] == results[ref]["wer"]
    print(json.dumps({"multicard_check": line}))
    return 0 if ok else 1


if __name__ == "__main__":
    if os.environ.get(RANK_RUN):
        driver(sys.argv[1:])
    else:
        sys.exit(main())
