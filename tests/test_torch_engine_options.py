"""The NSTI engine's options against the JAX package's ``DynamicEvalEngine``,
and the drivers' ``--profile`` and tokenizer wiring.

Tiny fp32 conformer (as in tests/test_torch_engine.py, ``"xla"`` attention
unless said), shared weights via ``params_from_jax``, the zero-mask
augmentation config (the identity on both sides), one online epoch:

- entropy augmentation: the perturbation δ of one window (whole, and the
  ragged last one) within 1e-4 of max |δ| against ``jax.grad`` of JAX's
  mean entropy, which averages over every frame of the padded window; the
  engine on a 700-frame recording whose last window is ragged (188 of 256
  frames): stitched log-probs within 1e-4, adapted weights within 2e-5.
  ``"pallas_flash"`` is held on a recording of whole windows only: there a
  padding query attends only padding keys, while JAX's XLA attention lets it
  attend valid keys, and padding frames enter the entropy mean.
- ``pseudo_label_retokenize`` with a SentencePiece model built here:
  ``retokenize`` and ``divergence_report`` equal JAX's; the engine gives
  JAX's stitched log-probs (1e-4) and transcript, and the round trip did
  change some window's labels; without a tokenizer both engines raise.
- ``print_pseudo_labels``: the captured text equals JAX's, window by window.
- ``run.py --profile DIR`` on the CPU writes one Chrome trace, of repeat 0.
- ``build_engine`` hands the tokenizer to the NSTI engine only.

The JAX engines run with ``lax.scan``'s ``unroll`` dropped
(tests/test_torch_engine.py says why).
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.text.tokenizer import SentencePieceTokenizer as JaxSentencePiece
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu.tta import retokenize as jax_retok
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.evals import common
from dynamic_asr_eval_tpu_torch.evals import run
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.text import SentencePieceTokenizer
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from dynamic_asr_eval_tpu_torch.tta import retokenize as retok
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="xla")
SEQ, OVERLAP, LR = 256, 128, 1e-3
# a unigram model whose merged pieces outscore their splits, so a piece path
# the model emits is often not the canonical segmentation
PIECES = ["▁a", "b", "▁ab", "c", "▁c", "▁abc", "d", "▁d", "e", "▁e", "▁de", "a", "▁b", "▁"]
SCORES = [-2.0, -2.0, -1.0, -2.0, -2.0, -0.5, -2.0, -2.0, -2.0, -2.0, -1.2, -2.5, -2.1, -4.0]


def _tokenizers():
    types = [1] * len(PIECES)
    return (SentencePieceTokenizer(PIECES, SCORES, types),
            JaxSentencePiece(PIECES, SCORES, types))


def _tta(**kw):
    return dict(dict(seq_len=SEQ, overlap=OVERLAP, epochs=1, online=True, shuffle=False,
                     lm_tta_beams=0, optim_args={"lr": LR}), **kw)


def _setup(vocab=30, frames=700, seed=0, **options):
    cfg = dict(TINY, vocab_size=vocab, **options)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(seed), example_T=256)
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    spec = np.random.default_rng(1).standard_normal((TINY["feat_in"], frames)).astype(np.float32)
    return jcfg, model, variables, port, spec


def _run_both(setup, tta, tokenizers=(None, None)):
    jcfg, model, variables, port, spec = setup
    with rolled_scans():
        j = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**tta), tokenizer=tokenizers[1])(
            variables, spec, return_params=True)
        jax.effects_barrier()
    p = DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**tta), tokenizer=tokenizers[0],
                          device="cpu")(port.state_dict(), spec, return_params=True)
    return j, p


def _assert_same_run(j, p, initial):
    np.testing.assert_allclose(p.numpy_logits(), j.numpy_logits(), rtol=0, atol=1e-4)
    back, unmatched = convert_lcasr_checkpoint({k: v.numpy() for k, v in p.params.items()})
    assert unmatched == []
    ref = dict(jax.tree_util.tree_leaves_with_path(j.params))
    init = dict(jax.tree_util.tree_leaves_with_path(initial))
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(np.asarray(ref[path]) - np.asarray(init[path])).max()))
    assert moved > 1e-3


# ---------------------------------------------------------------------------
# entropy augmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_len", [SEQ, 188], ids=["whole", "ragged"])
def test_entropy_perturbation_matches_jax_grad(w_len):
    jcfg, model, variables, port, spec = _setup()
    window = np.zeros((1, TINY["feat_in"], SEQ), np.float32)
    window[..., :w_len] = spec[:, :w_len]

    def mean_entropy(a):
        lp = model.apply(variables, a, length=jnp.full((1,), w_len, jnp.int32))["final_posteriors"]
        return jnp.mean(-jnp.sum(jnp.exp(lp) * lp, axis=-1))

    with jax.disable_jit():
        want = 1e-3 * np.asarray(jax.grad(mean_entropy)(jnp.asarray(window)))
    engine = DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta()), device="cpu")
    engine._load(None)
    delta = engine._entropy_delta(torch.from_numpy(window), w_len).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(delta, want, rtol=0, atol=1e-4 * scale)
    assert not delta[..., w_len:].any()  # the model masks the padded input


def test_entropy_augmentation_engine_matches_jax_on_a_ragged_recording():
    setup = _setup()
    j, p = _run_both(setup, _tta(entropy_augmentation=True))
    _assert_same_run(j, p, setup[2]["params"])


def test_entropy_augmentation_on_the_flash_path_over_whole_windows():
    """640 frames at 256 / 128: four whole windows, no padding frame, so the
    two attention semantics agree."""
    setup = _setup(frames=640, attention_impl="pallas_flash")
    j, p = _run_both(setup, _tta(entropy_augmentation=True))
    assert p.numpy_logits().shape[0] == 80
    _assert_same_run(j, p, setup[2]["params"])


# ---------------------------------------------------------------------------
# pseudo-label re-tokenisation and the debug print
# ---------------------------------------------------------------------------


def test_retokenize_and_divergence_report_equal_jax():
    tok, jtok = _tokenizers()
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, len(PIECES), rng.integers(0, 9)).tolist() for _ in range(60)]
    for ids in seqs:
        assert retok.retokenize(ids, tok) == jax_retok.retokenize(ids, jtok)
    report = retok.divergence_report(seqs, tok)
    assert report == jax_retok.divergence_report(seqs, jtok)
    assert 0 < report["rate"] < 1
    labels = torch.tensor([PIECES.index("▁a"), PIECES.index("b"), 7, 0], dtype=torch.int32)
    new, n = retok.retokenize_labels(labels, 2, tok, 4)
    jnew, jn = jax_retok.make_retokenize_callback(jtok, 4)(labels.numpy(), np.int32(2))
    assert new.tolist() == jnew.tolist() == [PIECES.index("▁ab"), 0, 0, 0]
    assert int(n) == int(jn) == 1


def test_retokenized_engine_matches_jax():
    tok, jtok = _tokenizers()
    setup = _setup(vocab=tok.vocab_size())
    seen = []
    inner = retok.retokenize_labels

    def recording(labels, length, tokenizer, max_tokens):
        out = inner(labels, length, tokenizer, max_tokens)
        seen.append(labels[: int(length)].tolist() != out[0][: int(out[1])].tolist())
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr("dynamic_asr_eval_tpu_torch.tta.runner.retokenize_labels", recording)
    try:
        j, p = _run_both(setup, _tta(pseudo_label_retokenize=True), (tok, jtok))
    finally:
        mp.undo()
    assert len(seen) == 5 and any(seen)  # every window; the round trip changed some
    _assert_same_run(j, p, setup[2]["params"])
    assert tok.decode(p.greedy_ids().tolist()) == jtok.decode(j.greedy_ids().tolist())


def test_retokenize_without_a_tokenizer_raises_as_in_jax():
    jcfg, model, _, port, _ = _setup()
    with pytest.raises(ValueError, match="tokenizer"):
        JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**_tta(pseudo_label_retokenize=True)))
    with pytest.raises(ValueError, match="tokenizer"):
        DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta(pseudo_label_retokenize=True)),
                          device="cpu")


@pytest.mark.parametrize("option", ["pseudo_label_retokenize", "print_pseudo_labels"])
def test_records_batching_refuses_the_host_options_as_in_jax(option):
    tok, jtok = _tokenizers()
    jcfg, model, variables, port, spec = _setup(vocab=tok.vocab_size())
    j = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**_tta(**{option: True})), tokenizer=jtok)
    p = DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta(**{option: True})),
                          tokenizer=tok, device="cpu")
    with pytest.raises(ValueError, match="--dp_records"):
        j.batched(variables, [spec])
    with pytest.raises(ValueError, match="--dp_records"):
        p.batched(None, [spec])


@pytest.mark.parametrize("with_tokenizer", [True, False], ids=["text", "ids"])
def test_print_pseudo_labels_prints_what_jax_prints(capsys, with_tokenizer):
    tok, jtok = _tokenizers()
    setup = _setup(vocab=tok.vocab_size())
    jcfg, model, variables, port, spec = setup
    tta = _tta(print_pseudo_labels=True)
    with rolled_scans():
        JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**tta),
                  tokenizer=jtok if with_tokenizer else None)(variables, spec)
        jax.effects_barrier()
    want = capsys.readouterr().out
    DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**tta),
                      tokenizer=tok if with_tokenizer else None, device="cpu")(None, spec)
    got = capsys.readouterr().out
    assert want.count("Pseudo targets: ") == 5
    assert got.split("\n--\n") == want.split("\n--\n")


# ---------------------------------------------------------------------------
# the drivers: --profile and the tokenizer
# ---------------------------------------------------------------------------


def test_run_profile_writes_one_trace_of_repeat_zero(tmp_path, monkeypatch):
    calls = []
    inner = common.profile_to

    def counting(directory):
        calls.append(directory)
        return inner(directory)

    monkeypatch.setattr(common, "profile_to", counting)
    out = tmp_path / "trace"
    run.cli(["-d", "synthetic", "--quiet", "--device", "cpu", "-r", "2", "--profile", str(out),
             "-kwargs", "epochs=1", "online=true", "seq_len=256", "overlap=128",
             "lm_tta_beams=0"])
    assert calls == [str(out)]
    assert sorted(os.listdir(out)) == sorted([common.PROFILE_TRACE, common.PROFILE_SPANS])
    with open(out / common.PROFILE_TRACE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    with open(out / common.PROFILE_SPANS) as f:
        spans = json.load(f)
    roots = [s for s in spans if s["parent"] is None]
    assert roots and all(s["name"] == "engine.record" for s in roots)


def test_build_engine_hands_the_tokenizer_to_nsti_only():
    tok, _ = _tokenizers()
    cfg = ConformerConfig(compute_dtype="float32", vocab_size=tok.vocab_size(), **TINY)
    model = SCConformer(cfg)
    args = argparse.Namespace(seq_len=SEQ, overlap=OVERLAP, lm_tta_beams=0)
    engines = {kind: common.build_engine(args, model, cfg, kind, device="cpu", tokenizer=tok)
               for kind in ("dynamic_eval", "awmc", "consistency")}
    assert engines["dynamic_eval"].tokenizer is tok
    assert engines["awmc"].tokenizer is None and engines["consistency"].tokenizer is None
