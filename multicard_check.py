"""The port's NSTI driver with ``--dp_records`` and ``--dp`` over N ranks
(``torch.distributed.run``, one process a card), each also with ``--tp``
(tensor parallelism: tp adjacent ranks a group), and with the model's
``seq_shard_axes`` over 2 ranks (sequence parallelism: the driver run inside
``parallel.use_mesh`` of a ``('dp', 'sp')`` mesh), against the serial driver
in one process, on the same ``synthetic_spec`` records: equal transcripts
and WER, in f32 with TF32 off and cuDNN deterministic.

    python3 multicard_check.py [--nproc 4] [--tp 2] [--device cpu]

Prints one JSON line and exits non-zero where a run differs.  A small f32
model (2 x 64) keeps it quick; five records of 30720, 22528, 16384, 8192
and 30720 frames at seq 16384 / overlap 14336 make a padded last group on
4 ranks (on 2 at tp 2).
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
SEQ_SHARD = "MULTICARD_CHECK_SEQ_SHARD"  # set too in the sequence-parallel run's ranks


def driver(argv) -> None:
    """One rank (or the serial run): ``evals.run`` at parity precision; in
    the sequence-parallel run, inside ``use_mesh`` of a ``('dp', 'sp')`` mesh
    over every rank."""
    import contextlib

    import torch.distributed as dist

    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn, set_parity_precision
    from dynamic_asr_eval_tpu_torch.evals import run

    set_parity_precision()
    mesh = contextlib.nullcontext()
    if os.environ.get(SEQ_SHARD):
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        from dynamic_asr_eval_tpu_torch.parallel import init_process_group, use_mesh

        args = run.parse_args(argv)
        device = init_process_group(args.device)
        n = dist.get_world_size()
        mesh = use_mesh(DeviceMesh(device.type, torch.arange(n).reshape(1, n),
                                   mesh_dim_names=("dp", "sp")))
    with deterministic_cudnn(), mesh:
        run.cli(argv)
    if dist.is_initialized():  # every rank done before any tears its groups down
        dist.barrier()
        dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nproc", type=int, default=4)
    parser.add_argument("--tp", type=int, default=2,
                        help="tensor-parallel degree of the --dp / --dp_records runs with --tp "
                             "(1: none)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DAE_SYNTH_SPEC_FRAMES=FRAMES,
               PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        configs = {}
        for name, model in (("plain", MODEL), ("seq_shard", {**MODEL,
                                                            "seq_shard_axes": ["dp", "sp"]})):
            configs[name] = os.path.join(tmp, f"{name}.yaml")  # JSON is YAML in flow style
            with open(configs[name], "w") as f:
                json.dump({"model": model}, f)
        common = ["-d", "synthetic_spec", "--quiet", "-seq", "16384", "-o", "14336"] + (
            ["--device", args.device] if args.device else [])

        def launch(n):
            return [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={n}",
                    "--master_port", "29611"]

        tp = ["--tp", str(args.tp)]
        # name: (launcher, flags, -kwargs, config, sequence-parallel ranks)
        runs = {"serial": ([], [], [], "plain", False),
                "dp_records": (launch(args.nproc), ["--dp_records"], [], "plain", False),
                "serial_offline": ([], [], ["online=false"], "plain", False),
                "dp": (launch(args.nproc), ["--dp"], ["online=false"], "plain", False),
                "seq_shard": (launch(2), [], [], "seq_shard", True)}
        if args.tp > 1:
            runs.update(dp_records_tp=(launch(args.nproc), ["--dp_records"] + tp, [], "plain",
                                       False),
                        dp_tp=(launch(args.nproc), ["--dp"] + tp, ["online=false"], "plain",
                               False))
        for name, (prefix, flags, extra, config, seq_shard) in runs.items():
            out = os.path.join(tmp, f"{name}.pkl")
            cmd = (prefix or [sys.executable]) + [
                os.path.abspath(__file__), *common, "--config", configs[config], "-s", out,
                *flags, *KWARGS, *extra]
            run_env = {**env, RANK_RUN: "1", **({SEQ_SHARD: "1"} if seq_shard else {})}
            proc = subprocess.run(cmd, env=run_env, capture_output=True, text=True, timeout=900)
            if proc.returncode:
                print(f"{name}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                      f"{proc.stderr[-6000:]}", file=sys.stderr)
                return proc.returncode
            with open(out[:-4] + "_1.pkl", "rb") as f:
                results[name] = pickle.load(f)
    line = {"nproc": args.nproc, "tp": args.tp, "seq_shard_ranks": 2,
            "records": len(FRAMES.split(","))}
    ok = True
    pairs = [("dp_records", "serial"), ("dp", "serial_offline"), ("seq_shard", "serial")]
    if args.tp > 1:
        pairs += [("dp_records_tp", "serial"), ("dp_tp", "serial_offline")]
    for name, ref in pairs:
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
