"""The port's consistency engine (``tta/consistency.py``), its mixing matrix
and its Adafactor (``optim/adafactor.py``) against the JAX package's
``ConsistencyEngine``, ``sequential_mix_matrix`` and ``optax.adafactor``.

Bars: the mixing matrix within 1e-6 (padding chunks included); Adafactor
within 1e-6 relative of optax over 5 steps (of the element, or of the leaf's
largest for elements near 0) on factored, unfactored, vector, square,
transposed and conv leaves; the engine (tiny f32 config, shared weights,
a 470-frame recording in 256-frame windows with 128 overlap: 3 windows, the
last ragged at 214 frames, one padding chunk in the bucket of 4), 2 epochs,
online and offline, ``"conv"`` and ``"pallas"`` subsampling: stitched
log-probs within 1e-4, each chunk's adapted weights (through
``convert_lcasr_checkpoint``) within 2e-5.  Adafactor's first step moves
each element by about ``lr · rms(p)`` whatever the size of its gradient, so
an element whose mixed gradient cancels to rounding noise (below 1e-6 of its
tensor's largest; 1 of ~150k here) moves the way rounding points it: such
elements are held to the steps' size instead.  JAX's ``chunk_grad`` calls its
augmentation pipeline itself, so no masks can be injected: augmentation is
off on both sides (the zero-mask config).  The JAX engine runs jitted with
the CTC scan's ``unroll`` dropped, as in tests/test_torch_engine.py.
"""

import contextlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.ops.ctc as jax_ctc
from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.tta import ConsistencyEngine as JaxConsistency
from dynamic_asr_eval_tpu.tta.consistency import sequential_mix_matrix as jax_mix
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.optim import Adafactor
from dynamic_asr_eval_tpu_torch.optim.adafactor import factored_dims
from dynamic_asr_eval_tpu_torch.tta import ConsistencyEngine
from dynamic_asr_eval_tpu_torch.tta.consistency import sequential_mix_matrix

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash")
SEQ, OVERLAP, LR, EPOCHS, FRAMES = 256, 128, 1e-3, 2, 470
N_REAL = 3


# ---------------------------------------------------------------------------
# the mixing matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", [[1] * 5, [1, 1, 1, 0], [1] * 9 + [0] * 3, [1, 0, 1, 1, 0],
                                  [1]])
@pytest.mark.parametrize("decay", [0.95, 0.5])
def test_mix_matrix_matches_jax(mask, decay):
    m = np.asarray(mask, np.float32)
    want = np.asarray(jax_mix(jnp.asarray(m), decay))
    got = sequential_mix_matrix(torch.from_numpy(m), decay).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pad = np.nonzero(m == 0)[0]
    np.testing.assert_array_equal(got[pad], np.eye(len(m), dtype=np.float32)[pad])
    assert not got[np.ix_(m > 0, pad)].any()  # padding enters no real row


def test_mix_matrix_reproduces_the_in_place_loop():
    """The matrix equals walking the chunks in order and overwriting each
    gradient before the later chunks read it (the reference's loop)."""
    rng = np.random.default_rng(0)
    G = rng.standard_normal((6, 4))
    mixed = G.copy()
    for i in range(6):
        d = 0.95 ** np.abs(i - np.arange(6))
        d[i] = 0.0
        mixed[i] = (mixed[i] + d @ mixed) / (1.0 + d.sum())
    got = sequential_mix_matrix(torch.ones(6), 0.95).double().numpy() @ G
    np.testing.assert_allclose(got, mixed, rtol=1e-6)


# ---------------------------------------------------------------------------
# Adafactor against optax.adafactor
# ---------------------------------------------------------------------------

# (port shape, optax shape, transposed): optax holds flax's [in, out]
LEAVES = {
    "factored": ((128, 192), False),
    "unfactored": ((64, 48), False),
    "vector": ((192,), False),
    "square": ((128, 128), True),
    "transposed": ((192, 128), True),
    "conv": ((256, 1, 3, 3), False),
    "small_first_axis": ((3, 130, 129), False),
}


@pytest.mark.parametrize("name", list(LEAVES))
@pytest.mark.parametrize("lr", [1e-2, 9e-5])
def test_adafactor_matches_optax_over_five_steps(name, lr):
    shape, transposed = LEAVES[name]
    rng = np.random.default_rng(len(name))
    p0 = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32) * 10.0 ** rng.uniform(-3, 1)
             for _ in range(5)]
    to_optax = (lambda a: a.T) if transposed else (lambda a: a)

    tx = optax.adafactor(learning_rate=lr)
    jp = jnp.asarray(to_optax(p0))
    state = tx.init(jp)
    p = torch.tensor(p0, requires_grad=True)
    opt = Adafactor([p], lr=lr)
    for g in grads:
        upd, state = tx.update(jnp.asarray(to_optax(g)), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    want = to_optax(np.asarray(jp))
    got = p.detach().numpy()
    # a step moves an element by up to about lr · rms(p0)
    assert np.abs(want - p0).max() > 0.5 * lr * np.sqrt(np.mean(p0 ** 2))
    # relative to each element, or to the leaf's largest for elements near 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_factoring_follows_the_two_largest_axes():
    assert factored_dims((128, 192)) == (0, 1)
    assert factored_dims((192, 128)) == (1, 0)
    assert factored_dims((64, 48)) is None and factored_dims((300,)) is None
    assert factored_dims((3, 130, 129)) == (2, 1)
    opt = Adafactor([torch.zeros(192, 128, requires_grad=True)], lr=1.0)
    st = next(iter(opt.state.values()))
    # rows: the mean over the largest axis (192); columns: over the other
    assert st["v_row"].shape == (128,) and st["v_col"].shape == (192,)


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------


def _tta(online):
    return dict(seq_len=SEQ, overlap=OVERLAP, epochs=EPOCHS, online=online, shuffle=False,
                lm_tta_beams=0, optim_args={"lr": LR})


@contextlib.contextmanager
def rolled_scans():
    scan = jax.lax.scan
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", lambda *a, unroll=1, **kw: scan(*a, **kw))
    jax_ctc.ctc_loss.clear_cache()
    try:
        yield
    finally:
        mp.undo()
        jax_ctc.ctc_loss.clear_cache()


def _setup(impl):
    cfg = dict(TINY, subsampling_impl=impl)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=256)
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    port.load_state_dict(state)
    spec = np.random.default_rng(1).standard_normal((TINY["feat_in"], FRAMES)).astype(np.float32)
    return jcfg, model, variables, state, port, spec


def _recording_steps(mp, steps):
    """Adafactor steps record the gradients they are given (in call order:
    chunk by chunk, epoch after epoch)."""
    step = Adafactor.step

    def recorded(self, closure=None):
        steps.append([p.grad.clone() for p in self.param_groups[0]["params"]])
        return step(self, closure)

    mp.setattr(Adafactor, "step", recorded)


@pytest.fixture(scope="module", params=["conv", "pallas"])
def runs(request):
    jcfg, model, variables, state, port, spec = _setup(request.param)
    out = {"initial": variables["params"], "state": state}
    for mode, online in (("online", True), ("offline", False)):
        with rolled_scans():
            j = JaxConsistency(model, jcfg.blank_id, 8, JaxTTAConfig(**_tta(online)))(
                variables, spec, return_params=True)
        steps, mp = [], pytest.MonkeyPatch()
        _recording_steps(mp, steps)
        try:
            p = ConsistencyEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta(online)),
                                  device="cpu")(state, spec, return_params=True)
        finally:
            mp.undo()
        assert len(steps) == N_REAL * EPOCHS
        out[mode] = (j, p, steps)
    return out


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_stitched_log_probs_match(runs, mode):
    j, p, _ = runs[mode]
    a, b = j.numpy_logits(), p.numpy_logits()
    assert a.shape == b.shape == (-(-FRAMES // 8), TINY["vocab_size"] + 1)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(p.greedy_ids(), j.greedy_ids())


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_each_chunks_weights_match(runs, mode):
    j, p, steps = runs[mode]
    assert len(p.params) == N_REAL
    init = dict(jax.tree_util.tree_leaves_with_path(runs["initial"]))
    stacked = dict(jax.tree_util.tree_leaves_with_path(j.params))
    assert next(iter(stacked.values())).shape[0] == 4  # JAX keeps the padding chunk
    n_noise = n_all = 0
    for c, chunk in enumerate(p.params):
        # elements whose mixed gradient cancelled to rounding noise in a step
        noise = {k: torch.zeros(v.shape, dtype=torch.bool) for k, v in chunk.items()}
        for grads in steps[c::N_REAL]:
            for k, g in zip(chunk, grads):
                noise[k] |= g.abs() < 1e-6 * g.abs().max()
        back, unmatched = convert_lcasr_checkpoint({k: v.numpy() for k, v in chunk.items()})
        flags, _ = convert_lcasr_checkpoint({k: v.numpy() for k, v in noise.items()})
        flags = dict(jax.tree_util.tree_leaves_with_path(flags["params"]))
        assert unmatched == []
        moved = 0.0
        for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
            ref, start = np.asarray(stacked[path][c]), np.asarray(init[path])
            held = ~flags[path]
            np.testing.assert_allclose(np.asarray(leaf)[held], ref[held], rtol=0, atol=2e-5)
            step = LR * max(np.sqrt(np.mean(start ** 2)), 1e-3) * 1.01
            assert np.all(np.abs(np.asarray(leaf) - ref)[~held] <= 2 * EPOCHS * step)
            moved = max(moved, float(np.abs(ref - start).max()))
            n_noise, n_all = n_noise + int((~held).sum()), n_all + held.size
        assert moved > 1e-4  # adaptation moved this chunk's weights
    assert n_noise <= 1e-4 * n_all
    for path, leaf in stacked.items():  # the padding chunk never moves
        np.testing.assert_array_equal(np.asarray(leaf[N_REAL]), np.asarray(init[path]))


def test_chunks_end_with_different_weights(runs):
    _, p, _ = runs["offline"]
    a, b = p.params[0], p.params[2]
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_callers_weights_are_not_modified():
    _, _, _, state, port, spec = _setup("conv")
    before = {k: v.clone() for k, v in state.items()}
    ConsistencyEngine(port, TINY["vocab_size"], 8, TTAConfig(**_tta(True)), device="cpu")(
        state, spec)
    assert all(torch.equal(state[k], before[k]) for k in state)


def test_epochs_zero_adapts_one_epoch():
    """``max(epochs, 1)``, as in the JAX engine."""
    _, _, _, state, port, spec = _setup("conv")
    outs = [ConsistencyEngine(port, TINY["vocab_size"], 8,
                              TTAConfig(**dict(_tta(False), epochs=e)), device="cpu")(state, spec)
            for e in (0, 1)]
    np.testing.assert_array_equal(outs[0].numpy_logits(), outs[1].numpy_logits())


def test_each_chunk_runs_one_forward_per_epoch_and_one_reinference():
    """Per epoch one batch-2 forward (augmented and clean) per real chunk,
    then offline one batch-1 forward per chunk: the launch counts the chip
    smoke requires (padding chunks run nothing)."""
    _, _, _, state, port, spec = _setup("conv")
    engine = ConsistencyEngine(port, TINY["vocab_size"], 8, TTAConfig(**_tta(False)),
                               device="cpu")
    batches = []
    engine._work.register_forward_hook(lambda mod, args, out: batches.append(args[0].shape[0]))
    engine(state, spec)
    assert batches == [2] * N_REAL * EPOCHS + [1] * N_REAL
