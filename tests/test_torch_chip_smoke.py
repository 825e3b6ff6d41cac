"""Helpers of chip_smoke.py that read text or CPU tensors only: phase 2's
report of nvcc's ``-Xptxas -v`` output, phase 3's checks that the bf16
kernels round where the plain version rounds, and phase 4's kernel names."""

import pytest
import torch

import chip_smoke
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import subsample as S

NS = "_ZN56_GLOBAL__N__53e36a9c_23_flash_attention_bf16_cu_ce332a91"
FWD = NS + "16tc_attention_fwdILi128EEEvPK13__nv_bfloat16S3_S3_NS_7StridesES4_S4_PKiPS1_Pfiiif"
DELTA = NS + "18tc_attention_deltaEPK13__nv_bfloat16S2_Pfxiii"


def test_ptxas_report_pairs_each_entry_with_its_registers_and_spills():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    128 bytes stack frame, 128 bytes spill stores, 188 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 128 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{DELTA}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 31 registers, used 0 barriers",
    ])
    assert chip_smoke.ptxas_report(log) == [(FWD, 168, 128), (DELTA, 31, 0)]


def test_ptxas_report_does_not_carry_spills_to_the_next_entry():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'",
        "    128 bytes stack frame, 128 bytes spill stores, 188 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{DELTA}' for 'sm_90a'",
        "ptxas info    : Used 31 registers, used 0 barriers",
    ])
    assert chip_smoke.ptxas_report(log)[1] == (DELTA, 31, 0)


@pytest.mark.parametrize("T", [37, 200])
@pytest.mark.parametrize("plain_rounds", [True, False])
def test_check_rounding_holds_the_rounding_points(monkeypatch, T, plain_rounds):
    """Outputs of the plain version that rounds as the kernel does pass
    ``check_rounding``; those of a version that does not round P and dS fail
    it: their gradients differ in far more than 5 % of elements."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(2, T, 2, 32, generator=g).bfloat16() for _ in range(4))
    mask = torch.arange(T)[None] < torch.tensor([T, T // 2])[:, None]
    _, lse = A.attention_reference(q, k, v, mask)
    if not plain_rounds:
        monkeypatch.setattr(A, "_round", lambda x, dtype: x)
    got_out, _ = A.attention_reference(q, k, v, mask)
    grads = A.attention_reference_bwd(q, k, v, mask, got_out, lse, dout)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    args = ("case", T, q, k, v, mask, dout, got_out, lse, grads)
    if plain_rounds:
        chip_smoke.check_rounding(A, *args)
    else:
        with pytest.raises(AssertionError, match="elements differ"):
            chip_smoke.check_rounding(A, *args)


def _subsample_case(C=32):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 200, 16, generator=g).bfloat16()
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = [torch.randn(shapes.get(n, (C,)), generator=g)
          * (1 / 3 if n in ("k9", "dw1", "dw2") else (C ** -0.5 if n.startswith("pw") else 0.1))
          for n in S.WEIGHT_NAMES]
    gout = torch.randn(1, S.ceil_chain(200)[2], 2, C, generator=g).bfloat16()
    return x, ws, gout


@pytest.mark.parametrize("plain_rounds", [True, False])
def test_check_subsample_rounding_holds_the_rounding_points(monkeypatch, plain_rounds):
    """Outputs of the plain version on the bf16 tensors (which rounds as the
    kernels do) pass ``check_subsample_rounding``; those of the plain
    version in f32, rounded once at the end, fail it: most of out's elements
    differ."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    x, ws, gout = _subsample_case()
    if plain_rounds:
        out = S.fused_subsample_reference(x, *ws)
        gx, gws = S.fused_subsample_reference_bwd(x, ws, gout, "silu", True)
    else:
        out = S.fused_subsample_reference(x.float(), *ws).bfloat16()
        gx, gws = S.fused_subsample_reference_bwd(x.float(), ws, gout.float(), "silu", True)
        gx = gx.bfloat16()
    args = ("case", x, ws, gout, out, gx, gws)
    if plain_rounds:
        chip_smoke.check_subsample_rounding(S, *args)
    else:
        with pytest.raises(AssertionError, match="elements differ"):
            chip_smoke.check_subsample_rounding(S, *args)


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::tc_pw_kernel<0, 1>((anonymous namespace)::PwArgs)",
     "tc_pw_kernel<0, 1>"),
    ("(anonymous namespace)::reduce_kernel(float const*, long long, long long, long long, float*)",
     "reduce_kernel"),
])
def test_kernel_name_drops_namespace_and_parameters(key, name):
    assert chip_smoke.kernel_name(key) == name
