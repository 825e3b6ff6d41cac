"""Why the f32 attention kernels take each product as three TF32 products.

``csrc/flash_attention.cu`` (route ``"tf32x3"``) runs every product of the
f32 route on the tensor cores in TF32, which keeps 10 bits of each
operand's mantissa.  It splits each operand x where it loads it into a
fragment, big = tf32(x) and small = tf32(x - big) (``cvt.rna.tf32.f32``:
to nearest, ties away from zero), and takes a.b as small_a.big_b +
big_a.small_b + big_a.big_b with f32 sums.  A numerical model of that
design (here only: the package holds the kernel and its plain version)
runs the forward and the backward the kernels run, with TF32 rounding by
bit masking, and is held against JAX's Pallas flash attention in TPU
interpret mode (as tests/test_torch_attention.py runs it) at D 128 with a
ragged mask: forward and dq/dk/dv within 1e-4 of max |Pallas|, and at least
10x closer than the same model with one TF32 product.  JAX's Pallas kernel
takes T only in multiples of 128 (its key block), so T is 384 with 300 and
211 valid frames.  The kernels themselves are held against the plain
version on the card (tests/test_torch_attention_gpu.py, chip_smoke.py).
"""

import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dynamic_asr_eval_tpu.kernels.attention import flash_attention as jax_flash_attention
from dynamic_asr_eval_tpu_torch.kernels import attention as A

torch.set_num_threads(1)

B, T, H, D = 2, 384, 2, 128
LENGTHS = [300, 211]
NAMES = ("out", "dq", "dk", "dv")


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


def model(q, k, v, mask, dout, terms):
    """The kernels' forward and backward on [B, T, H, D] f32 with every
    product through ``mm``: out and (dq, dk, dv), the backward from the
    forward's own out and lse."""
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))  # [B, H, T, D]
    scale = 1.0 / math.sqrt(q.shape[-1])
    seg = mask.to(torch.int32)
    same = (seg[:, :, None] == seg[:, None, :])[:, None]  # [B, 1, T, T]
    s = mm(qt, kt.transpose(-1, -2), terms) * scale
    s = s.masked_fill(~same, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, vt, terms) / l
    lse = m + torch.log(l)
    p = torch.exp(mm(qt, kt.transpose(-1, -2), terms) * scale - lse).masked_fill(~same, 0.0)
    delta = (dot * out).sum(-1, keepdim=True)
    ds = p * (mm(dot, vt.transpose(-1, -2), terms) - delta) * scale
    dv = mm(p.transpose(-1, -2), dot, terms)
    dk = mm(ds.transpose(-1, -2), qt, terms)
    dq = mm(ds, kt, terms)
    return [x.transpose(1, 2).numpy() for x in (out, dq, dk, dv)]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return q, k, v, g, mask


@pytest.fixture(scope="module")
def pallas(case):
    """Forward and (dq, dk, dv) of JAX's Pallas kernel in interpret mode
    (strict: no silent fallback)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DAE_STRICT_FLASH_ATTENTION", "1")
    q, k, v, g, mask = case
    try:
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, jnp.asarray(mask)),
                               *(jnp.asarray(a) for a in (q, k, v)))
            grads = vjp(jnp.asarray(g))
    finally:
        mp.undo()
    return [np.asarray(x) for x in (out,) + tuple(grads)]


@pytest.fixture(scope="module")
def models(case):
    q, k, v, g, mask = (torch.from_numpy(a) for a in case)
    return {terms: model(q, k, v, mask, g, terms) for terms in (1, 3)}


def _err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("which", NAMES)
def test_three_tf32_products_match_pallas(models, pallas, which):
    i = NAMES.index(which)
    assert _err(models[3][i], pallas[i]) <= 1e-4


@pytest.mark.parametrize("which", NAMES)
def test_one_tf32_product_is_ten_times_further_from_pallas(models, pallas, which):
    """One TF32 product per product misses f32 by ~1e-3 relative: what made
    the f32 route stay off the tensor cores before the split."""
    i = NAMES.index(which)
    assert _err(models[1][i], pallas[i]) >= 10 * _err(models[3][i], pallas[i])


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10  # one TF32 ulp above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one,
                      float("inf"), 0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one, float("inf"), 0.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - big).abs() <= big.abs() * 2.0 ** -11).all()


def test_routes_send_each_dtype_to_its_source():
    assert A.ROUTES == {torch.bfloat16: "tensor_core", torch.float32: "tf32x3"}
    assert {r: lib.source.name for r, lib in A.LIBRARIES.items()} == {
        "tensor_core": "flash_attention_bf16.cu", "tf32x3": "flash_attention.cu"}
    assert set(A.route_launches) == set(A.ROUTES.values())
    for lib in A.LIBRARIES.values():
        assert lib.source.exists()


def test_both_sources_export_the_same_entry_points():
    """One binding serves both routes: the same C entry points."""
    names = {}
    for route, lib in A.LIBRARIES.items():
        text = lib.source.read_text()
        names[route] = sorted(re.findall(r'extern "C" [\w\s*]+?(dae_\w+)\(', text))
    assert names["tensor_core"] == names["tf32x3"] == [
        "dae_cuda_error_string", "dae_flash_attention_bwd", "dae_flash_attention_fwd"]


@pytest.mark.parametrize("dtype,D,Dk", [(torch.float32, 30, 32), (torch.float32, 3, 4),
                                        (torch.float32, 128, 128), (torch.bfloat16, 64, 64)])
def test_kernel_head_dim_is_whole_16_byte_rows(dtype, D, Dk):
    x = torch.randn(1, 5, 2, D).to(dtype)
    assert A._kernel_head_dim(x) == Dk
    (padded,) = A._padded([x], Dk)
    assert padded.shape == (1, 5, 2, Dk) and torch.equal(padded[..., :D], x)
    assert (padded[..., D:] == 0).all() and (padded is x) == (D == Dk)


def test_f32_operands_are_copied_only_when_misaligned():
    """The f32 kernels' 16-byte copies need rows on 16 bytes: a strided v
    view of a qkv tensor (strides multiples of 4 floats) is taken as it is;
    a view that starts 4 bytes in is copied."""
    qkv = torch.zeros(2, 8, 3, 2, 32)
    v = qkv.unbind(2)[2]
    assert A._aligned(v) is v
    odd = torch.zeros(1 + 2 * 8 * 2 * 32)[1:].view(2, 8, 2, 32)
    copy = A._aligned(odd)
    assert copy is not odd and copy.data_ptr() % 16 == 0 and torch.equal(copy, odd)
