"""The port's ``grpo`` and ``maxrl`` engines against the JAX package's, on
shared weights, with the same rollouts injected on both sides: each
package's ``tta.encdec_rl.generate_encdec`` is replaced for the sampled call
inside the test (sampled tokens cannot match across frameworks), so both
take the teacher, two perturbations of it and an unrelated sequence as the
rollouts; the rewards, advantages, the batch-4 policy loss and MADGRAD then
run as they are.  Transcripts equal, adapted weights within 2e-5, the
decoder's ``pos_enc`` unchanged bit for bit on both sides; JAX's updates
go through ``.lower().compile()`` (tests/test_torch_encdec_rl.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamic_asr_eval_tpu.tta.encdec_rl as jax_rl
from dynamic_asr_eval_tpu_torch.tta import encdec_rl as port_rl
from test_torch_encdec_rl import SEQ, assert_same_adaptation, run_both, spec

torch.set_num_threads(1)


def fixed_rollouts(teacher, n, max_generate):
    """The rollouts both sides get: the teacher itself, two perturbations of
    it and an unrelated sequence (so GRPO's rewards spread and MaxRL's pass
    rate is 1/4)."""
    t = list(teacher)
    rows = [t, (t[:-1] + [27]) if t else [27], [5, 6] + t[2:], [11, 12, 13, 14, 15][:n]]
    toks = np.zeros((n, max_generate), np.int32)
    lens = np.zeros((n,), np.int32)
    for i, row in enumerate(rows[:n]):
        row = row[: max_generate - 1]
        toks[i, : len(row)], lens[i] = row, len(row)
    return toks, lens


def inject_rollouts(monkeypatch):
    """Each package's sampled ``generate_encdec`` call returns
    :func:`fixed_rollouts` of its own greedy teacher on the same audio."""
    real_jax, real_port = jax_rl.generate_encdec, port_rl.generate_encdec

    def jax_gen(model, variables, audio, cfg, rng=None, sample=1, greedy=True, **kw):
        if greedy and sample == 1:
            return real_jax(model, variables, audio, cfg, rng=rng, sample=sample, greedy=greedy,
                            **kw)
        t, n, enc = real_jax(model, variables, audio, cfg, max_generate=kw["max_generate"],
                             length=kw["length"])
        toks, lens = fixed_rollouts(np.asarray(t[0])[: int(n[0])], sample, kw["max_generate"])
        return jnp.asarray(toks), jnp.asarray(lens), enc

    def port_gen(model, audio, cfg, generator=None, sample=1, greedy=True, **kw):
        if greedy and sample == 1:
            return real_port(model, audio, cfg, generator=generator, sample=sample,
                             greedy=greedy, **kw)
        t, n, enc = real_port(model, audio, cfg, max_generate=kw["max_generate"],
                              length=kw["length"])
        toks, lens = fixed_rollouts(t[0].tolist()[: int(n[0])], sample, kw["max_generate"])
        return torch.from_numpy(toks).long(), torch.from_numpy(lens), enc

    monkeypatch.setattr(jax_rl, "generate_encdec", jax_gen)
    monkeypatch.setattr(port_rl, "generate_encdec", port_gen)


@pytest.mark.parametrize("mode", ["grpo", "maxrl"])
def test_policy_engine_matches_jax_on_injected_rollouts(mode, monkeypatch):
    inject_rollouts(monkeypatch)
    updates = []
    step = port_rl.EncDecDynamicEvalEngine._step
    monkeypatch.setattr(port_rl.EncDecDynamicEvalEngine, "_step",
                        lambda self, opt, loss: updates.append(loss.item()) or step(self, opt,
                                                                                      loss))
    out, pristine, variables = run_both(mode, spec(1, 2 * SEQ), monkeypatch)
    assert len(updates) == 2 and all(math.isfinite(u) for u in updates), updates
    (transcript, adapted, _), (jt, jparams, _) = out["port"], out["jax"]
    assert transcript == jt
    assert_same_adaptation(adapted, pristine, jparams, variables)
