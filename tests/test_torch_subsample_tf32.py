"""Why the f32 subsampling kernels take each pointwise product as three TF32
products.

``csrc/fused_subsample.cu`` (route ``"tf32x3"``) runs every pointwise
product of the f32 route on the tensor cores in TF32, which keeps 10 bits of
each operand's mantissa: both stages' products in the forward (and the
backward's recompute), the input gradients gd = gz @ pw^T and the weight
gradients gW = A^T @ Gz.  It splits each operand x once, big = tf32(x) and
small = tf32(x - big) (``cvt.rna.tf32.f32``: to nearest, ties away from
zero), and takes a.b as small_a.big_b + big_a.small_b + big_a.big_b with f32
sums.  The stage-0 conv, the depthwise convs and their gradients stay in f32.

A numerical model of that design (here only: the package holds the kernel
and its plain version) runs the forward and, through autograd, the backward
with every pointwise product, forward and backward, taken by TF32 rounding
by bit masking.  It is held against JAX's ``fused_subsample`` running its
Pallas kernels in interpret mode, in f32, as tests/test_torch_subsample.py
runs it, at that file's bars: forward 2e-5, the gradients of all 11 inputs
2e-4 (rtol and atol).  The same model with one TF32 product per product is
at least 10x further from JAX, in max |error| over max |JAX|, for every
output.  Cases: T 700 and 997, C 16 and 20 (not a multiple of 8, as the
kernels pad channels).  The kernels themselves are held against the plain
version on the card (tests/test_torch_subsample_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.kernels.subsample import fused_subsample as jax_fused_subsample
from dynamic_asr_eval_tpu_torch.kernels import subsample as S

torch.set_num_threads(1)

FEAT = 16
CASES = [(700, 16), (997, 20)]
NAMES = ("out", "x") + S.WEIGHT_NAMES


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero; the low 13 bits zero (inf and NaN kept)."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    return (torch.where(finite, bits + 0x1000, bits) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b in f32 from TF32 products: three (split operands, small terms
    first) or one."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


class PointwiseTF32(torch.autograd.Function):
    """d [M, C] @ pw [C, C] as the kernels take it, forward and backward:
    gd = gz @ pw^T and gW = d^T @ gz through ``mm`` as well."""

    @staticmethod
    def forward(ctx, d, pw, terms):
        ctx.save_for_backward(d, pw)
        ctx.terms = terms
        return mm(d, pw, terms)

    @staticmethod
    def backward(ctx, gz):
        d, pw = ctx.saved_tensors
        return mm(gz, pw.t(), ctx.terms), mm(d.t(), gz, ctx.terms), None


def model(x, ws, terms, act=F.silu):
    """The kernels' forward on x [B, T, F] f32: stage 0 and the depthwise
    convs in f32 (stride 2, padding (1, 1), no masks), the pointwise
    products through ``PointwiseTF32``; -> [B, T/8, F/8, C]."""
    k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2 = ws
    C = k9.shape[1]

    def conv3(h, w9, b, groups):
        return F.conv2d(h, w9.t().reshape(C, 1, 3, 3), b, stride=2, padding=1, groups=groups)

    s = act(conv3(x[:, None], k9, b0, 1))
    for w9, bw, pw, bp in ((dw1, bdw1, pw1, bpw1), (dw2, bdw2, pw2, bpw2)):
        d = conv3(s, w9, bw, C).permute(0, 2, 3, 1)  # [B, T', F', C]
        z = PointwiseTF32.apply(d.reshape(-1, C), pw, terms).view(d.shape) + bp
        s = act(z).permute(0, 3, 1, 2)
    return s.permute(0, 2, 3, 1)


def _inputs(T, C, seed):
    rng = np.random.default_rng(seed)
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = []
    for name in S.WEIGHT_NAMES:
        scale = 1 / 3 if name in ("k9", "dw1", "dw2") else (C ** -0.5 if name.startswith("pw") else 0.1)
        ws.append((rng.standard_normal(shapes.get(name, (C,))) * scale).astype(np.float32))
    x = rng.standard_normal((2, T, FEAT)).astype(np.float32)
    g = rng.standard_normal((2, -(-T // 8), FEAT // 8, C)).astype(np.float32)
    return x, ws, g


@pytest.fixture(scope="module", params=CASES, ids=[f"T{t}-C{c}" for t, c in CASES])
def case(request):
    """(JAX's output and 11 gradients, {terms: the model's}) for one case."""
    T, C = request.param
    x, ws, g = _inputs(T, C, seed=T + C)
    out, vjp = jax.vjp(lambda *a: jax_fused_subsample(*a, act_name="silu", interpret=True),
                       jnp.asarray(x), *map(jnp.asarray, ws))
    ref = [np.asarray(out)] + [np.asarray(r) for r in vjp(jnp.asarray(g))]
    got = {}
    for terms in (1, 3):
        inputs = [torch.tensor(a, requires_grad=True) for a in [x] + ws]
        y = model(inputs[0], inputs[1:], terms)
        grads = torch.autograd.grad(y, inputs, torch.from_numpy(g))
        got[terms] = [y.detach().numpy()] + [gr.numpy() for gr in grads]
    return ref, got


def _err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("i,name", list(enumerate(NAMES)))
def test_three_tf32_products_match_the_pallas_kernel(case, i, name):
    ref, got = case
    bar = 2e-5 if name == "out" else 2e-4
    assert got[3][i].shape == ref[i].shape
    np.testing.assert_allclose(got[3][i], ref[i], rtol=bar, atol=bar, err_msg=name)


@pytest.mark.parametrize("i,name", list(enumerate(NAMES)))
def test_one_tf32_product_is_ten_times_further_from_the_pallas_kernel(case, i, name):
    """One TF32 product per product misses f32 by ~1e-3 relative: what kept
    the f32 route on the CUDA cores before the split."""
    ref, got = case
    assert _err(got[1][i], ref[i]) >= 10 * _err(got[3][i], ref[i]), name


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10  # one TF32 ulp above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one,
                      float("inf"), -float("inf"), 0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one, float("inf"), -float("inf"), 0.0]
    assert torch.isnan(tf32(torch.tensor([float("nan")]))).all()
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - big).abs() <= big.abs() * 2.0 ** -11).all()
    small = tf32(y - big)
    assert ((y - (big + small)).abs() <= y.abs() * 2.0 ** -21).all()


def test_split_keeps_a_product_to_f32_and_one_tf32_product_does_not():
    """The three-product sum of a [64, 256] x [256, 64] product is within
    ~1e-6 of max of the double product; one TF32 product is off by ~1e-3."""
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(64, 256, generator=g), torch.randn(256, 64, generator=g)
    exact = a.double() @ b.double()
    scale = exact.abs().max()
    assert ((mm(a, b, 3).double() - exact).abs().max() / scale) < 2e-6
    assert ((mm(a, b, 1).double() - exact).abs().max() / scale) > 1e-4
