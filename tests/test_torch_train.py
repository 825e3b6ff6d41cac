"""The port's NST finetuning (``train/``) and ``ops/chunk.py::chunk_spectrogram``
against the JAX package.

Pure-host pieces (the chunker, the schedules, the dataset order and the
loader's padding) must be equal.  The trainer: a 2-layer model
(``"pallas_flash"``, plain on the CPU on both sides), weights carried across
by ``params_from_jax``, three recordings of 600 / 650 / 700 frames in
256-frame windows at batch 2, so each recording's second batch holds one
ragged window and one zero-length row; ``warmup_steps=3`` (the lr changes
every step), a ``clip_value`` far below every step's gradient norm (the
clip bites), zero-mask SpecAugment (the identity on both sides).  Bars:
per-step losses within 1e-4 relative, final weights and EMA within 2e-5,
equal step counts.  JAX's jitted step goes through ``.lower().compile()``
with its CTC scan rolled (tests/conftest.py: the jit fast path can return
wrong gradients on this CPU; the compiled path agrees with eager here).
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.train.nst as jax_nst
from dynamic_asr_eval_tpu.config import SpecAugmentConfig as JaxSpecAugment
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.checkpoint import load_checkpoint as jax_load_checkpoint
from dynamic_asr_eval_tpu.ops.chunk import chunk_spectrogram as jax_chunk_spectrogram
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu.train import CosineSchedule as JaxCosine
from dynamic_asr_eval_tpu.train import SequenceWarmupManager as JaxWarmup
from dynamic_asr_eval_tpu.train import SimpleDataset as JaxDataset
from dynamic_asr_eval_tpu.train import VariableBatchLoader as JaxLoader
from dynamic_asr_eval_tpu_torch.config import SpecAugmentConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.ops import chunk_spectrogram
from dynamic_asr_eval_tpu_torch.text import CharTokenizer
from dynamic_asr_eval_tpu_torch.train import (
    CosineSchedule,
    EvalRunner,
    NSTTrainer,
    SequenceWarmupManager,
    SimpleDataset,
    TrainConfig,
    VariableBatchLoader,
)
import dynamic_asr_eval_tpu_torch.train.nst as port_nst
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash", subsampling_impl="conv")
TRAIN = dict(peak_lr=3e-3, warmup_steps=3, seq_len=256, batch_size=2, clip_value=0.05,
             max_epochs=1, save_every_recordings=100)
FRAMES = (600, 650, 700)  # 3 windows each: a full batch, then 1 window + 1 zero-length row


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,seq,overlap,bucket", [(700, 256, 128, True), (700, 256, 128, False),
                                                  (200, 256, 0, True), (1000, 256, 0, False),
                                                  (1300, 512, 64, True)])
def test_chunk_spectrogram_equals_jax(T, seq, overlap, bucket):
    spec = np.random.default_rng(T).standard_normal((1, 8, T)).astype(np.float32)
    got = chunk_spectrogram(spec, seq, overlap, pad_to_bucket=bucket)
    want = jax_chunk_spectrogram(spec, seq, overlap, pad_to_bucket=bucket)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


def test_cosine_schedule_equals_jax():
    for args in ((1e-3, 3, 20), (1e-5, 1, 10_000, 0.1), (2.0, 10, 5)):
        a, b = CosineSchedule(*args), JaxCosine(*args)
        assert [a(s) for s in range(40)] == [b(s) for s in range(40)]
        assert a.state_dict() == b.state_dict()
        assert CosineSchedule.from_state_dict(a.state_dict())(7) == a(7)


def test_sequence_warmup_equals_jax():
    kw = dict(initial_seq_len=1024, max_seq_len=8192, increase_every_steps=2,
              initial_batch_size=8)
    a, b = SequenceWarmupManager(**kw), JaxWarmup(**kw)
    for n in (1, 1, 2, 3, 10):
        assert a.step(n) == b.step(n)
        assert a.rotary_interpolation_factor == b.rotary_interpolation_factor
    assert a.state_dict() == b.state_dict()
    c = SequenceWarmupManager.from_state_dict(a.state_dict())
    assert c.step(2) == b.step(2)


def _records(n):
    return [{"id": f"rec{i}", "duration": float((7 * i) % 5), "text": f"t{i}",
             "spec": np.random.default_rng(i).standard_normal((4, 30 + 11 * i)).astype(np.float32)}
            for i in range(n)]


@pytest.mark.parametrize("subgroup,seed,seen", [(8, 0, ()), (3, 5, ("rec2", "rec7")), (1, 1, ())])
def test_dataset_order_equals_jax(subgroup, seed, seen):
    recs = _records(11)
    a = SimpleDataset(recs, subgroup_size=subgroup, seed=seed, seen_ids=set(seen))
    b = JaxDataset(recs, subgroup_size=subgroup, seed=seed, seen_ids=set(seen))
    for epoch in range(3):
        assert a.epoch_order(epoch) == b.epoch_order(epoch)


def test_loader_batches_equal_jax():
    recs = _records(7)
    pa, pb = SimpleDataset(recs, subgroup_size=3), JaxDataset(recs, subgroup_size=3)
    la = VariableBatchLoader(pa, 3, lambda r: r["spec"][None], epoch=1)
    lb = JaxLoader(pb, 3, lambda r: r["spec"][None], epoch=1)
    got, want = [], []
    for loader, out in ((la, got), (lb, want)):
        it = iter(loader)
        out.append(next(it))
        loader.set_batch_size(2)
        out.extend(it)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["spectrograms"], b["spectrograms"])
        np.testing.assert_array_equal(a["lengths"], b["lengths"])
        assert a["spectrograms"].dtype == b["spectrograms"].dtype
        assert a["texts"] == b["texts"]
    assert pa.seen_ids == pb.seen_ids == {r["id"] for r in recs}


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def compiled_steps():
    """JAX's train step through ``.lower().compile()`` (one executable per
    argument shape), its CTC scan rolled."""
    jit = jax.jit

    def aot(fn):
        jitted, executables = jit(fn), {}

        def call(*args):
            key = str([(np.shape(x), np.result_type(x)) for x in jax.tree.leaves(args)])
            if key not in executables:
                executables[key] = jitted.lower(*args).compile()
            return executables[key](*args)
        return call

    with pytest.MonkeyPatch.context() as mp, rolled_scans():
        mp.setattr(jax_nst.jax, "jit", aot)
        yield


def _recording(i, frames):
    return {"id": f"r{i}", "duration": float(i), "text": "hello world",
            "spec": np.random.default_rng(i).standard_normal((TINY["feat_in"], frames)).astype(
                np.float32)}


def _spec(rec):
    return rec["spec"]


def _port_trainer(state, ckpt_dir, **overrides):
    model = SCConformer(ConformerConfig(compute_dtype="float32", **TINY))
    cfg = TrainConfig(**{**TRAIN, **overrides}, checkpoint_dir=str(ckpt_dir),
                      spec_augment=SpecAugmentConfig(n_freq_masks=0))
    return NSTTrainer(model, state, model.config, cfg, log_fn=lambda d: None, device="cpu")


def _record_losses(trainer, losses):
    run = trainer.train_recording

    def wrapped(*args, **kwargs):
        out = run(*args, **kwargs)
        losses.extend(out)
        return out
    trainer.train_recording = wrapped


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=256)
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    records = [_recording(i, n) for i, n in enumerate(FRAMES)]
    tmp = tmp_path_factory.mktemp("nst")

    jt = jax_nst.NSTTrainer(model, variables, jcfg, jax_nst.TrainConfig(
        **TRAIN, checkpoint_dir=str(tmp / "jax"), spec_augment=JaxSpecAugment(n_freq_masks=0)),
        log_fn=lambda d: None)
    jax_losses = []
    _record_losses(jt, jax_losses)
    with compiled_steps():
        jt.train(JaxDataset(records), _spec)

    pt = _port_trainer(state, tmp / "port")
    port_losses, norms = [], []
    clip = port_nst.clip_by_global_norm_
    _record_losses(pt, port_losses)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_nst, "clip_by_global_norm_",
                   lambda grads, max_norm: norms.append(float(clip(grads, max_norm))))
        pt.train(SimpleDataset(records), _spec)
    return dict(jax=jt, port=pt, jax_losses=jax_losses, port_losses=port_losses, norms=norms,
                state=state, records=records, jcfg=jcfg, jax_model=model, tmp=tmp)


def _as_port(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def test_trainer_losses_match_jax(trained):
    j, p = np.array(trained["jax_losses"]), np.array(trained["port_losses"])
    assert len(j) == len(p) == 2 * len(FRAMES)
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=0)
    assert trained["port"].step_count == trained["jax"].step_count == 2 * len(FRAMES)
    assert trained["port"].recordings_seen == trained["jax"].recordings_seen == len(FRAMES)
    # the bar is meaningful: the clip bit on every step, and the lr varied
    assert min(trained["norms"]) > 10 * TRAIN["clip_value"]
    assert len({trained["port"].schedule(s) for s in range(4)}) == 4


@pytest.mark.parametrize("which", ["params", "ema"])
def test_trainer_weights_match_jax(trained, which):
    jt, pt = trained["jax"], trained["port"]
    want = _as_port(jt.params if which == "params" else jt.ema_params)
    got = pt.model.state_dict() if which == "params" else pt.teacher.state_dict()
    moved = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
        moved = max(moved, (v - trained["state"][k]).abs().max().item())
    assert moved > 1e-3


def test_nan_losses_skip_and_abort_as_in_jax(trained):
    """A NaN recording: each step's loss is non-finite, nothing moves but
    ``step_count``, and the second strike aborts with JAX's message."""
    jt, pt = trained["jax"], trained["port"]
    bad = np.full((TINY["feat_in"], 600), np.nan, np.float32)
    before_p = {k: v.clone() for k, v in pt.model.state_dict().items()}
    before_e = {k: v.clone() for k, v in pt.teacher.state_dict().items()}
    before_opt = pt._opt_state()
    before_j = jax.tree.map(np.asarray, jt.params)
    outs = {}
    for name, trainer, call in (("jax", jt, lambda: jt.train_recording(bad, jax.random.PRNGKey(1))),
                                ("port", pt, lambda: pt.train_recording(bad))):
        trainer.cfg.nan_strikes = 2
        steps = trainer.step_count
        buf = io.StringIO()
        with compiled_steps(), contextlib.redirect_stdout(buf), pytest.raises(RuntimeError) as e:
            call()
        outs[name] = (buf.getvalue(), str(e.value), trainer.step_count - steps, trainer.nan_count)
        trainer.cfg.nan_strikes = 100
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].splitlines() == ["NaN/inf loss skipped (1/2)",
                                            "NaN/inf loss skipped (2/2)"]
    assert "consecutive non-finite losses" in outs["port"][1]
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, before_p[k]), k
    for k, v in pt.teacher.state_dict().items():
        assert torch.equal(v, before_e[k]), k
    after_opt = pt._opt_state()
    assert after_opt["count"] == before_opt["count"] == pt.step_count - 1  # the abort: no += 1
    for key in ("grad_sum", "grad_sum_sq", "x0"):
        assert all(torch.equal(after_opt[key][n], before_opt[key][n]) for n in before_opt[key])
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jt.params), before_j)
    pt.nan_count = jt.nan_count = 0


def test_checkpoint_loads_into_jax_and_resumes_bit_for_bit(trained):
    pt, tmp = trained["port"], trained["tmp"]
    ckpt = os.path.join(str(tmp / "port"), "epoch_0.ckpt")
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".train_state.pkl")
    _, variables, cfg = jax_load_checkpoint(ckpt)
    assert cfg.n_layers == TINY["n_layers"] and cfg.attention_impl == "pallas_flash"
    for k, v in _as_port(variables["params"]).items():
        assert torch.equal(v, pt.model.state_dict()[k]), k
    with open(ckpt + ".train_state.pkl", "rb") as f:
        side = pickle.load(f)
    assert set(side) == {"ema_params", "opt_state", "step_count", "recordings_seen", "seen_ids",
                         "seq_warmup"}

    path = os.path.join(str(tmp), "again.ckpt")
    ds = SimpleDataset(trained["records"], seen_ids={"r1"})
    pt.save(path, ds)
    other = _port_trainer(trained["state"], tmp / "other")
    ds2 = SimpleDataset(trained["records"])
    other.resume(path, ds2)
    assert ds2.seen_ids == {"r1"}
    assert (other.step_count, other.recordings_seen) == (pt.step_count, pt.recordings_seen)
    for mod_a, mod_b in ((other.model, pt.model), (other.teacher, pt.teacher)):
        for k, v in mod_b.state_dict().items():
            assert torch.equal(mod_a.state_dict()[k], v), k
    a, b = other._opt_state(), pt._opt_state()
    assert a["count"] == b["count"] > 0
    for key in ("grad_sum", "grad_sum_sq", "x0"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in b[key])
    # a resumed trainer takes the next step as the original does
    spec = trained["records"][0]["spec"][:, :512]
    assert other.train_recording(spec) == pt.train_recording(spec)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_resume_gives_the_teacher_the_checkpoints_batch_statistics(tmp_path):
    """JAX's teacher runs on the checkpoint's ``extra_vars``: a batch-renorm
    model started from non-default running statistics, saved, then resumed
    into a fresh trainer, gives that trainer's teacher those statistics and
    the saved teacher's outputs bit for bit."""
    cfg = ConformerConfig(compute_dtype="float32", default_norm="batch_renorm", **TINY)
    g = torch.Generator().manual_seed(0)
    state = SCConformer(cfg).state_dict()
    for k in state:
        if k.endswith("running_mean"):
            state[k] = 0.5 * torch.randn(state[k].shape, generator=g)
        elif k.endswith("running_var"):
            state[k] = 0.5 + 2.0 * torch.rand(state[k].shape, generator=g)
    tcfg = TrainConfig(**TRAIN, checkpoint_dir=str(tmp_path),
                       spec_augment=SpecAugmentConfig(n_freq_masks=0))
    saved = NSTTrainer(SCConformer(cfg), state, cfg, tcfg, log_fn=lambda d: None, device="cpu")
    path = str(tmp_path / "br.ckpt")
    saved.save(path)
    fresh = NSTTrainer(SCConformer(cfg), None, cfg, tcfg, log_fn=lambda d: None, device="cpu")
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert stats and not torch.equal(fresh.teacher.state_dict()[stats[0]], state[stats[0]])
    fresh.resume(path)
    for k, v in saved.teacher.state_dict().items():
        assert torch.equal(fresh.teacher.state_dict()[k], v), k
    x = torch.randn(2, TINY["feat_in"], 256, generator=g)
    lengths = torch.tensor([256, 100])
    with torch.no_grad():
        want = saved.teacher(x, lengths)["final_posteriors"]
        assert torch.equal(fresh.teacher(x, lengths)["final_posteriors"], want)


def test_eval_runner_wer_equals_jax(trained):
    """Dev WER of JAX's EMA weights through each package's engine with
    ``epochs=0``, on two records (one shorter than a window)."""
    jt, pt = trained["jax"], trained["port"]
    spec = {rec["id"]: rec["spec"] for rec in trained["records"]}
    recs = [{"id": rid, "process_fn": lambda r: (spec[r["id"]][:, : 700 - 500 * (r["id"] == "r0")],
                                                 "hello world")} for rid in ("r0", "r2")]
    ema = jax.tree.map(np.asarray, jt.ema_params)
    want = jax_nst.EvalRunner(trained["jax_model"], trained["jcfg"], recs, JaxCharTokenizer(),
                              seq_len=256, overlap=128)({"params": ema})
    got = EvalRunner(pt.model, pt.model_config, recs, CharTokenizer(), seq_len=256, overlap=128,
                     device="cpu")(_as_port(ema))
    assert got == want
    assert np.isfinite(got)


@pytest.mark.parametrize("norm", [2e-3, 1e-3 * (1 + 1e-6), 5e-4, 3.0])
def test_clip_is_optax_rule(norm):
    """optax's ``clip_by_global_norm``: scale by ``max_norm / norm`` when
    ``norm >= max_norm``, with no epsilon (``clip_grad_norm_``'s ``norm +
    1e-6`` differs by ~1e-3 relative at these norms)."""
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 5), (7,), (2, 2, 2))]
    scale = norm / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [(g * scale).astype(np.float32) for g in grads]
    want, _ = optax.clip_by_global_norm(1e-3).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    port_nst.clip_by_global_norm_(got, 1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("lengths,label_lengths", [((6, 0), (0, 0)), ((6, 0), (2, 0)),
                                                   ((0, 3), (1, 2)), ((6, 3), (0, 0))])
def test_ctc_loss_counts_a_zero_input_length_as_one_frame_as_jax(lengths, label_lengths):
    """JAX's recursion always takes frame 0, so a zero-length row of a
    padded training batch costs -log P(blank) of its first frame (and an
    impossible label its 1e30 floor)."""
    from dynamic_asr_eval_tpu.ops.ctc import ctc_loss as jax_ctc_loss
    from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss

    rng = np.random.default_rng(sum(lengths))
    lp = rng.standard_normal((2, 6, 5)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    labels = np.array([[1, 2, 0], [3, 3, 0]], np.int32)
    want = float(jax_ctc_loss(jnp.asarray(lp), jnp.asarray(lengths), jnp.asarray(labels),
                              jnp.asarray(label_lengths), blank_id=4))
    got = float(ctc_loss(torch.from_numpy(lp), torch.tensor(lengths), torch.from_numpy(labels),
                         torch.tensor(label_lengths), blank_id=4))
    assert got == pytest.approx(want, rel=1e-5)
