"""Offline Bayesian hyperparameter search (Tree-structured Parzen Estimator).

Counterpart of the JAX package's ``evals/hpo.py``, line for line: a
dependency-free TPE sampler (Bergstra et al., NeurIPS 2011, "Algorithms for
Hyper-Parameter Optimization") over the sweep-YAML parameter schema, the
``method: bayes`` of :mod:`.run_sweep` without the wandb service:

- ``{values: [...]}``      — categorical (bools / strings / numbers)
- ``{min: .., max: ..}``   — uniform range; integer iff both ends are ints

TPE in one paragraph: split the observed trials at the γ-quantile of the
objective into "good" and "bad" sets, fit a density to each (Parzen window —
a truncated Gaussian mixture for numeric params, a smoothed histogram for
categoricals), draw candidates from the *good* density and keep the one
maximizing ``l(x)/g(x)``.  All draws come from one ``random.Random(seed)``,
so the same seed and history give the JAX package's suggestions exactly.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Sequence, Tuple


class _Categorical:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample_prior(self, rng: random.Random):
        return rng.choice(self.values)

    def _weights(self, obs: List[Any]) -> List[float]:
        # Dirichlet(1) smoothing: every category keeps nonzero mass so the
        # ratio l/g is always finite and unseen categories stay explorable
        counts = [1.0] * len(self.values)
        for o in obs:
            try:
                counts[self.values.index(o)] += 1.0
            except ValueError:
                pass
        total = sum(counts)
        return [c / total for c in counts]

    def sample_good(self, good: List[Any], rng: random.Random):
        w = self._weights(good)
        return rng.choices(self.values, weights=w, k=1)[0]

    def log_ratio(self, x, good: List[Any], bad: List[Any]) -> float:
        lw = self._weights(good)
        gw = self._weights(bad)
        i = self.values.index(x)
        return math.log(lw[i]) - math.log(gw[i])


class _Numeric:
    def __init__(self, lo: float, hi: float, integer: bool):
        self.lo, self.hi = float(lo), float(hi)
        self.integer = integer

    def _clip(self, x: float):
        x = min(max(x, self.lo), self.hi)
        return int(round(x)) if self.integer else x

    def sample_prior(self, rng: random.Random):
        if self.integer:
            return rng.randint(int(self.lo), int(self.hi))
        return rng.uniform(self.lo, self.hi)

    def _bandwidth(self, obs: List[float]) -> float:
        # Parzen heuristic: span / (1 + #obs), floored so the mixture never
        # collapses to spikes (keeps g(x) > 0 everywhere in range)
        span = self.hi - self.lo
        bw = span / (1.0 + len(obs))
        return max(bw, 1e-3 * span, 1e-12)

    def _logpdf(self, x: float, obs: List[float]) -> float:
        # uniform-prior component + one truncated Gaussian per observation
        span = max(self.hi - self.lo, 1e-12)
        comps = [math.log(1.0 / span)]
        if obs:
            bw = self._bandwidth(obs)
            for mu in obs:
                z = (x - mu) / bw
                comps.append(-0.5 * z * z - math.log(bw * math.sqrt(2 * math.pi)))
        m = max(comps)
        return m + math.log(sum(math.exp(c - m) for c in comps)) - math.log(len(comps))

    def sample_good(self, good: List[float], rng: random.Random):
        if not good or rng.random() < 1.0 / (1 + len(good)):
            return self.sample_prior(rng)  # the uniform-prior mixture component
        mu = rng.choice(good)
        bw = self._bandwidth(good)
        for _ in range(16):  # rejection-sample the truncation
            x = rng.gauss(mu, bw)
            if self.lo <= x <= self.hi:
                return self._clip(x)
        return self._clip(mu)

    def log_ratio(self, x, good: List[float], bad: List[float]) -> float:
        return self._logpdf(float(x), [float(v) for v in good]) - self._logpdf(
            float(x), [float(v) for v in bad]
        )


def _build_space(parameters: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    space = {}
    for name, spec in parameters.items():
        if "values" in spec:
            space[name] = _Categorical(spec["values"])
        elif "min" in spec and "max" in spec:
            lo, hi = spec["min"], spec["max"]
            space[name] = _Numeric(lo, hi, isinstance(lo, int) and isinstance(hi, int))
        else:
            raise ValueError(f"parameter {name}: need 'values' or 'min'/'max'")
    return space


class TPESampler:
    """Sequential suggest-observe optimizer over a sweep-YAML parameter dict.

    Usage::

        tpe = TPESampler(sweep['parameters'], seed=0)
        for _ in range(count):
            cfg = tpe.suggest()
            tpe.observe(cfg, objective(cfg))   # lower is better
    """

    def __init__(self, parameters: Dict[str, Dict[str, Any]], seed: int = 0,
                 n_startup: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24, maximize: bool = False):
        self.space = _build_space(parameters)
        self.rng = random.Random(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.sign = -1.0 if maximize else 1.0
        self.trials: List[Tuple[Dict[str, Any], float]] = []

    def observe(self, params: Dict[str, Any], value: float) -> None:
        self.trials.append((dict(params), self.sign * float(value)))

    def _split(self) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        ordered = sorted(self.trials, key=lambda t: t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        return ([t[0] for t in ordered[:n_good]],
                [t[0] for t in ordered[n_good:]])

    def suggest(self) -> Dict[str, Any]:
        if len(self.trials) < self.n_startup:
            return {k: p.sample_prior(self.rng) for k, p in self.space.items()}
        good, bad = self._split()
        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cfg, score = {}, 0.0
            for k, p in self.space.items():
                g = [t[k] for t in good if k in t]
                b = [t[k] for t in bad if k in t]
                x = p.sample_good(g, self.rng)
                cfg[k] = x
                score += p.log_ratio(x, g, b)
            if score > best_score:
                best_cfg, best_score = cfg, score
        return best_cfg
