"""Configuration: the shared CLI argument system and the TTA knob bundles.

Counterpart of the JAX package's ``config.py`` with the same CLI surface
(``-seq``, ``-o``, ``-kwargs key=value`` ...), the same dataclasses, and the
``paths.yaml`` loader (:class:`DotDict`, :func:`load_paths`).  ``yaml`` is
imported only inside the functions that read a yaml file, so the GPU path
needs no PyYAML: a dataset adapter handed its ``paths`` reads no yaml.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class DotDict(dict):
    """A dict with recursive attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return DotDict(v) if isinstance(v, dict) and not isinstance(v, DotDict) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def load_paths(path: Optional[str] = None) -> DotDict:
    """The user's ``paths.yaml`` (``path``, else ``$DAE_PATHS_YAML``,
    ``./paths.yaml``, ``~/paths.yaml``, the first that exists); an empty
    :class:`DotDict` when there is none (synthetic data needs none)."""
    candidates = [path] if path else [
        os.environ.get("DAE_PATHS_YAML", ""), "paths.yaml", os.path.expanduser("~/paths.yaml")]
    for cand in candidates:
        if cand and os.path.exists(cand):
            import yaml

            with open(cand, "r") as f:
                return DotDict(yaml.safe_load(f) or {})
    return DotDict()


def load_yaml(path: str) -> Dict[str, Any]:
    """A yaml file as a dict.  A file that is JSON (a YAML document in flow
    style) is read with ``json``, so it needs no PyYAML; any other goes
    through ``yaml.safe_load``."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return json.loads(text) or {}
    except ValueError:
        pass
    import yaml

    return yaml.safe_load(text) or {}


def parse_kwarg_value(raw: str) -> Any:
    """``-kwargs`` value: literal python where possible, true/false/none,
    else the raw string (never evaluated as code)."""
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def apply_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Adds the common flags every driver uses, parses, then folds
    ``-kwargs key=value ...`` pairs into the namespace."""
    parser.add_argument("-c", "--checkpoint", type=str, default="", help="model checkpoint path")
    parser.add_argument("-config", "--config", type=str, default="", help="model config yaml (if no checkpoint)")
    parser.add_argument("-split", "--split", type=str, default="test")
    parser.add_argument("-seq", "--seq_len", type=int, default=16384)
    parser.add_argument("-o", "--overlap", type=int, default=14336)
    parser.add_argument("-ds", "--dont_shuffle", action="store_true")
    parser.add_argument("-dfa", "--disable_flash_attention", action="store_true")
    parser.add_argument("-log", "--log", type=str, default="")
    parser.add_argument("-beams", "--beams", type=int, default=1)
    parser.add_argument("-lm", "--language_model", type=str, default="")
    parser.add_argument(
        "-kwargs",
        "--kwargs",
        nargs="+",
        default=[],
        help="extra key=value hyperparameters (optim_lr, spec_augment_*, epochs, online, ...)",
    )
    args = parser.parse_args(argv)
    for pair in args.kwargs:
        if "=" not in pair:
            raise ValueError(f"-kwargs entries must be key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        args.__dict__[k] = parse_kwarg_value(v)
    args.shuffle = not args.dont_shuffle
    return args


@dataclass
class SpecAugmentConfig:
    n_time_masks: int = 0
    n_freq_masks: int = 0
    freq_mask_param: int = 42
    time_mask_param: int = -1
    min_p: float = 0.05
    max_p: float = 1.0
    zero_masking: bool = False

    @classmethod
    def from_args(cls, args) -> "SpecAugmentConfig":
        d = {k.replace("spec_augment_", ""): v for k, v in vars(args).items() if k.startswith("spec_augment")}
        return cls(
            n_time_masks=d.get("n_time_masks", 0),
            n_freq_masks=d.get("n_freq_masks", 0),
            freq_mask_param=d.get("freq_mask_param", 42),
            time_mask_param=d.get("time_mask_param", -1),
            min_p=d.get("min_p", 0.05),
            max_p=d.get("max_p", 1.0),
            zero_masking=d.get("zero_masking", False),
        )


@dataclass
class FrameShuffleConfig:
    time_dimension: bool = False
    freq_dimension: bool = False

    @classmethod
    def from_args(cls, args) -> "FrameShuffleConfig":
        d = {k.replace("frame_shuffle_", ""): v for k, v in vars(args).items() if k.startswith("frame_shuffle")}
        return cls(
            time_dimension=d.get("time_dimension", False),
            freq_dimension=d.get("freq_dimension", False),
        )


@dataclass
class CutoutConfig:
    seq_len: int = 16384
    cutout_val: str = "mean"
    num_rectangles: int = 0
    max_width: int = 100
    max_height: int = 10

    @classmethod
    def from_args(cls, args, seq_len: int) -> "CutoutConfig":
        d = {k.replace("cutout_", ""): v for k, v in vars(args).items() if k.startswith("cutout")}
        return cls(
            seq_len=seq_len,
            cutout_val=d.get("value", "mean"),
            num_rectangles=d.get("num_rectangles", 0),
            max_width=d.get("max_width", 100),
            max_height=d.get("max_height", 10),
        )


def get_lr_args_from_args(args) -> Dict[str, Any]:
    """optim_* prefix scrape; default lr 9e-5."""
    lr_args = {k.replace("optim_", ""): v for k, v in vars(args).items() if k.startswith("optim_")}
    lr_args["lr"] = lr_args.get("lr", 9e-5)
    return lr_args


@dataclass
class TTAConfig:
    """Bundle of the knobs the NSTI engine reads from args."""

    seq_len: int = 16384
    overlap: int = 14336
    epochs: int = 1
    shuffle: bool = True
    online: bool = False
    num_negatives: int = 1
    random_noise: float = 0.0
    lm_tta_beams: int = 3
    pseudo_label_retokenize: bool = False
    optim_args: Dict[str, Any] = field(default_factory=lambda: {"lr": 9e-5})
    spec_augment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    frame_shuffle: FrameShuffleConfig = field(default_factory=FrameShuffleConfig)
    cutout: CutoutConfig = field(default_factory=CutoutConfig)
    entropy_augmentation: bool = False
    bitfit: bool = False
    freeze_subsampling: bool = False
    freeze_all_but_last_block_and_head: bool = False
    train_subsampling_only: bool = False
    ema_decay: float = 0.999
    ema_use_num_updates: bool = True
    print_runtimes: bool = False
    print_pseudo_labels: bool = False

    @classmethod
    def from_args(cls, args) -> "TTAConfig":
        g = lambda k, d: getattr(args, k, vars(args).get(k, d))
        online = bool(g("online", False))
        return cls(
            seq_len=g("seq_len", 16384),
            overlap=g("overlap", 14336),
            # online mode runs args.epochs epochs (each overwriting the
            # stitch; the last one wins) but never shuffles — the JAX
            # package's reading of the reference loop
            epochs=int(g("epochs", 1)),
            shuffle=False if online else bool(g("shuffle", True)),
            online=online,
            random_noise=float(g("random_noise", 0.0)),
            lm_tta_beams=int(g("lm_tta_beams", 3)),
            pseudo_label_retokenize=bool(g("pseudo_label_retokenize", False)),
            optim_args=get_lr_args_from_args(args),
            spec_augment=SpecAugmentConfig.from_args(args),
            frame_shuffle=FrameShuffleConfig.from_args(args),
            cutout=CutoutConfig.from_args(args, g("seq_len", 16384)),
            entropy_augmentation=bool(g("entropy_augmentation_enabled", False)),
            bitfit=bool(g("bitfit", False)),
            freeze_subsampling=bool(g("freeze_subsampling", False)),
            freeze_all_but_last_block_and_head=bool(g("freeze_all_but_last_block_and_head", False)),
            train_subsampling_only=bool(g("train_subsampling_only", False)),
            ema_decay=float(g("ema_decay", 0.999)),
            ema_use_num_updates=bool(g("ema_use_num_updates", True)),
            print_runtimes=bool(g("print_runtimes", False)),
            print_pseudo_labels=bool(g("print_pseudo_labels", False)),
        )
