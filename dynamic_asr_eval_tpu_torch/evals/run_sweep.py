"""Hyperparameter sweep runner.

Counterpart of the JAX package's ``evals/run_sweep.py``: a sweep YAML names
a parameter space; each run overrides the driver's arguments, forces the dev
split and reports the driver's WER.  With ``wandb`` importable and no
``--no_wandb`` the sweep goes to ``wandb.sweep`` / ``wandb.agent``;
otherwise it runs here: ``grid`` and ``random`` as lists of overrides,
``bayes`` through the TPE sampler of :mod:`.hpo`, each result appended to
the ``--out`` JSONL.  The run scripts are the port's :func:`.run.main`
(``main``) and its encoder-decoder drivers: ``enc_dec_dynamic_eval_test``,
``enc_dec_inference_test`` and ``enc_dec_ctc_beam_inference_test`` (the
inference driver pinned to ``mode="joint"``).  PyYAML and wandb are
imported inside :func:`main` only.  The runs go to ``cuda`` unless
``--device cpu`` is given.

Sweep YAML schema (wandb-style)::

    method: bayes | grid | random
    metric: {name: WER, goal: minimize}
    parameters:
      optim_lr: {values: [1e-5, 9e-5]}        # or {min: ..., max: ...}
      spec_augment_n_freq_masks: {values: [2, 6]}

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_sweep -sc
sweep_configs/online.yaml --no_wandb --out results.jsonl -d tedlium``
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

from dynamic_asr_eval_tpu_torch.config import apply_args, parse_kwarg_value
from dynamic_asr_eval_tpu_torch.models import ConformerConfig
from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig

ENC_DEC_SCRIPTS = ("enc_dec_dynamic_eval_test", "enc_dec_inference_test",
                   "enc_dec_ctc_beam_inference_test")


def run_scripts() -> Dict[str, Callable]:
    """``-run_script`` name → the driver's ``main(args, model_config=...,
    jax_params=...)``."""
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_dynamic_eval_test as ed_tta
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_inference_test as ed_inf
    from dynamic_asr_eval_tpu_torch.evals import run as run_mod

    def joint_beam_main(args, **kwargs):
        # the joint-CTC-beam driver is enc_dec_inference_test pinned to
        # mode="joint": a sweep of it must not run the plain AR decode
        args.mode = "joint"
        return ed_inf.main(args, **kwargs)

    return {"main": run_mod.main, "enc_dec_dynamic_eval_test": ed_tta.main,
            "enc_dec_inference_test": ed_inf.main,
            "enc_dec_ctc_beam_inference_test": joint_beam_main}


def _coerce(v):
    # PyYAML 1.1 parses "1e-5" (no dot) as a string: normalize scalars
    return parse_kwarg_value(v) if isinstance(v, str) else v


def coerce_parameters(params: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, spec in params.items():
        spec = dict(spec)
        if "values" in spec:
            spec["values"] = [_coerce(v) for v in spec["values"]]
        for bound in ("min", "max"):
            if bound in spec:
                spec[bound] = _coerce(spec[bound])
        out[k] = spec
    return out


def expand_parameters(params: Dict[str, Any], method: str, n_random: int = 20,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """``grid``: every combination (a range as 5 evenly spaced points);
    otherwise ``n_random`` independent draws."""
    keys, spaces = [], []
    rng = random.Random(seed)
    for k, spec in params.items():
        keys.append(k)
        if "values" in spec:
            spaces.append([_coerce(v) for v in spec["values"]])
        elif "min" in spec and "max" in spec:
            lo, hi = spec["min"], spec["max"]
            if method == "grid":
                spaces.append([lo + (hi - lo) * i / 4 for i in range(5)])
            else:
                spaces.append(("range", lo, hi))
        else:
            raise ValueError(f"parameter {k}: need 'values' or 'min'/'max'")

    if method == "grid":
        return [dict(zip(keys, combo)) for combo in itertools.product(*spaces)]
    out = []
    for _ in range(n_random):
        pick = {}
        for k, sp in zip(keys, spaces):
            if isinstance(sp, tuple):
                pick[k] = rng.uniform(sp[1], sp[2])
            else:
                pick[k] = rng.choice(sp)
        out.append(pick)
    return out


def main(args, model_config: Optional[Union[ConformerConfig, EncDecConfig]] = None,
         jax_params: Optional[Mapping] = None):
    """Returns the best ``{"overrides", "WER"}`` of an offline sweep (None
    after a wandb agent).  ``model_config`` and ``jax_params`` go to the run
    script's ``main`` in every run."""
    import yaml

    script = run_scripts()[args.run_script]

    with open(args.sweep_config, "r") as f:
        sweep = yaml.safe_load(f)

    def run_fn(run_args):
        return script(run_args, model_config=model_config, jax_params=jax_params)

    method = sweep.get("method", "grid")

    try:
        import wandb

        have_wandb = not args.no_wandb
    except ImportError:
        have_wandb = False

    if have_wandb:
        sweep_id = wandb.sweep(sweep, project=sweep.get("project", "dae_tpu_sweep"))

        def agent_run():
            wandb.init()
            overrides = dict(wandb.config)
            run_args = argparse.Namespace(**{**vars(args.base_args), **overrides})
            run_args.split = "dev"
            wer = run_fn(run_args)
            wandb.log({"WER": wer})

        wandb.agent(sweep_id, function=agent_run, count=args.count)
        return None

    # offline: grid / random are lists of overrides; bayes runs the TPE
    # sampler's suggest -> run -> observe loop, as wandb's service does
    parameters = coerce_parameters(sweep.get("parameters", {}))
    maximize = (sweep.get("metric") or {}).get("goal", "minimize") == "maximize"
    results = []

    def run_trial(i, n, overrides):
        run_args = argparse.Namespace(**{**vars(args.base_args), **overrides})
        run_args.split = "dev"
        print(f"[sweep {i + 1}/{n}] {overrides}")
        wer = run_fn(run_args)
        rec = {"overrides": overrides, "WER": wer}
        results.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return wer

    if method == "bayes":
        from dynamic_asr_eval_tpu_torch.evals.hpo import TPESampler

        tpe = TPESampler(parameters, seed=getattr(args, "seed", 0) or 0, maximize=maximize)
        for i in range(args.count):
            overrides = tpe.suggest()
            tpe.observe(overrides, run_trial(i, args.count, overrides))
    else:
        combos = expand_parameters(parameters, method, args.count)
        for i, overrides in enumerate(combos):
            run_trial(i, len(combos), overrides)
    best = min(results, key=lambda r: (-1 if maximize else 1) * r["WER"])
    print(f"best: WER={best['WER']} with {best['overrides']}")
    return best


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sc", "--sweep_config", type=str, required=True)
    parser.add_argument("-run_script", "--run_script", type=str, default="main",
                        choices=["main", *ENC_DEC_SCRIPTS])
    parser.add_argument("--count", type=int, default=20)
    parser.add_argument("--out", type=str, default="")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("-r", "--repeats", type=int, default=1)
    # the encoder-decoder run scripts' own flags
    parser.add_argument("--training_mode", type=str, default="grpo")
    parser.add_argument("--breaks", action="store_true")
    parser.add_argument("-mode", "--mode", type=str, default="default")
    args = apply_args(parser, argv)
    args.base_args = args
    return args


def cli(argv=None, model_config: Optional[Union[ConformerConfig, EncDecConfig]] = None,
        jax_params: Optional[Mapping] = None):
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
