"""The plain reference held to the program at tiny sizes on the CPU, in
float32: the forward and its gradients for both configurations, the window
plan, the greedy labels, MADGRAD, and a whole NSTI record judged by
``check.judge`` (the reference following the program's labels)."""

import json

import pytest
import torch

from portbench import check, harness, weights as W
from portbench.reference import conformer as ref
from portbench.reference.nsti import MADGRAD, collapse, plan
from portbench.tests import tiny

CONFIGS = ("scconformer_xl", "fastconformer_ctc_large")


def tiny_model(name, **over):
    cfg = json.loads((tiny.ROOT / f"portbench/configs/{name}.json").read_text())
    cfg["model"].update(tiny.TINY, compute_dtype="float32", **over)
    return cfg["model"]


def port(m, P):
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer

    model = SCConformer(ConformerConfig.from_dict(m))
    model.load_state_dict(P, strict=True)
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_gradients_match_the_program(name):
    m = tiny_model(name)
    P = W.make(m, 11, "cpu")
    W.set_blank_bias(P, m, 0.25, 12, frames=512)
    model = port(m, P)
    x = torch.randn(2, m["feat_in"], 300, generator=torch.Generator().manual_seed(3))
    lengths = [300, 211]
    want = ref.forward({k: v.clone().requires_grad_(ref.trainable(k)) for k, v in P.items()},
                       m, x, lengths)
    got = model(x, torch.tensor(lengths))["final_posteriors"]
    for b, n in enumerate(lengths):
        t = ref.subsampled_length(n, 8)
        assert (got[b, :t] - want[b, :t]).abs().max() < 1e-4
    # gradients of a loss on the valid frames
    Pr = {k: v.clone().requires_grad_(ref.trainable(k)) for k, v in P.items()}
    weight = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
    valid = torch.zeros(got.shape[:2])
    for b, n in enumerate(lengths):
        valid[b, :ref.subsampled_length(n, 8)] = 1
    (ref.forward(Pr, m, x, lengths) * weight * valid[..., None]).sum().backward()
    model.zero_grad()
    (model(x, torch.tensor(lengths))["final_posteriors"] * weight * valid[..., None]).sum().backward()
    for k, p in model.named_parameters():
        g_ref = Pr[k].grad
        scale = max(float(g_ref.abs().max()), 1e-3)
        assert float((p.grad - g_ref).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("n", [100, 256, 257, 320, 500, 511, 900, 2048])
def test_plan_matches_the_program(n):
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    starts, lengths = chunk_starts_and_lengths(n, 256, 192)
    assert plan(n, 256, 192) == list(zip(starts, lengths))


def test_collapse_matches_the_program():
    from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_labels

    g = torch.Generator().manual_seed(0)
    lp = torch.randn(200, 6, generator=g)
    lp[:, 5] += 0.8
    labels, length = greedy_labels(lp, 180, 5, 64)
    assert collapse(lp[:180].argmax(-1), 5, 64).tolist() == labels[: int(length)].tolist()


def test_madgrad_matches_the_program():
    from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD as PortMADGRAD

    g = torch.Generator().manual_seed(1)
    a = torch.randn(7, 5, generator=g, requires_grad=True)
    b = a.detach().clone().requires_grad_(True)
    mine, theirs = MADGRAD([a], lr=9e-5), PortMADGRAD([b], lr=9e-5)
    for _ in range(4):
        grad = torch.randn(7, 5, generator=g)
        a.grad, b.grad = grad.clone(), grad.clone()
        mine.step()
        theirs.step()
    assert torch.allclose(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", CONFIGS)
def test_a_record_in_float32_agrees_with_the_reference(tmp_path, name):
    bench = tiny.write(tmp_path, compute_dtype="float32")
    cell = harness.load_cell(f"{name}.nsti.talks", bench, tmp_path / "traffic")
    system = harness.System(cell, 123, "cpu")
    rec = system.records[1]
    out, text, _ = system.run_record(rec, 5)
    program = {"ids": system.hooks.ids, "logits": out.logits, "counts": out.counts,
               "text": text}
    numbers = check.judge(system.weights, system.m, system.engine_cfg,
                          torch.as_tensor(rec["spec"]), rec["masks"], program, system.pieces)
    assert numbers["windows_missing"] == numbers["coverage_mismatch"] == 0
    assert numbers["text_mismatch"] == 0
    assert numbers["label_gap"] < 1e-4 and numbers["stitch_gap"] < 1e-4
    assert numbers["stitch_tv"] < 1e-4
