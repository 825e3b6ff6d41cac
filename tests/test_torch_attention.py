"""The port's attention (plain version and its autograd.Function on CPU
tensors) against the JAX package's flash attention running JAX's real Pallas
TPU kernel in TPU interpret mode, forward and gradients.  The Hopper kernel
itself is held against the plain version on the card by
tests/test_torch_attention_gpu.py and chip_smoke.py.

Tolerances (fp32): forward 2e-5 on all rows, padding rows included (the
segment semantics make padding queries attend padding keys only, on both
sides); dq/dk/dv 1e-4 (the backward reorders the sums and recomputes P from
the log-sum-exp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dynamic_asr_eval_tpu.kernels.attention import _xla_attention
from dynamic_asr_eval_tpu.kernels.attention import flash_attention as jax_flash_attention
from dynamic_asr_eval_tpu_torch.kernels import attention as A

torch.set_num_threads(1)

B, T, H, D = 2, 256, 2, 128
LENGTHS = [256, 200]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return q, k, v, g, mask


@pytest.fixture(scope="module")
def jax_pallas(case, monkeypatch_module):
    """Forward and (dq, dk, dv) of the JAX package's flash attention through
    the real Pallas kernel in interpret mode (strict: no silent fallback)."""
    monkeypatch_module.setenv("DAE_STRICT_FLASH_ATTENTION", "1")
    q, k, v, g, mask = case
    args = [jnp.asarray(a) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, jnp.asarray(mask)), *args)
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _port(case):
    q, k, v, g, mask = case
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = A.flash_attention(qt, kt, vt, torch.from_numpy(mask))
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in (dq, dk, dv)]


def test_forward_matches_pallas_on_all_rows(case, jax_pallas):
    out, _ = _port(case)
    np.testing.assert_allclose(out, jax_pallas[0], rtol=0, atol=2e-5)


@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
def test_gradients_match_pallas(case, jax_pallas, which):
    i = ["dq", "dk", "dv"].index(which)
    _, grads = _port(case)
    np.testing.assert_allclose(grads[i], jax_pallas[1][i], rtol=0, atol=1e-4)


def test_forward_matches_xla_attention_on_valid_rows(case):
    q, k, v, _, mask = case
    ref = np.asarray(_xla_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask)))
    out, _ = _port(case)
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], rtol=0, atol=2e-5)


def test_plain_backward_matches_autograd_of_plain_forward(case):
    """The kernel's backward algorithm (P from the log-sum-exp, Delta) on the
    CPU equals autograd through the einsum forward."""
    q, k, v, g, mask = case
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    m = torch.from_numpy(mask)
    out, _ = A.attention_reference(qt, kt, vt, m)
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    _, grads = _port(case)
    for a, b in zip(grads, auto):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-4)


def test_cpu_path_launches_no_kernel(case):
    A.reset_counters()
    _port(case)
    assert (A.fwd_launches, A.bwd_launches) == (0, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "head_dim", "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 2, 16)
    mask = torch.ones(1, 8, dtype=torch.bool)
    k = v = q
    if bad == "dtype":
        q = k = v = q.half()
    elif bad == "shape":
        mask = torch.ones(1, 7, dtype=torch.bool)
    elif bad == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 160)
    else:
        q = torch.zeros(1, 8, 16, 2).transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        A.flash_attention(q, k, v, mask)
