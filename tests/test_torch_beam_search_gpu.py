"""The n-gram LM and the beam search on the card against the same functions
on the CPU, at the flagship's vocabulary (4095 pieces + blank), beam 20 and
32 candidate tokens a frame.  Marked ``gpu``: they skip where there is no
CUDA device.  No JAX is imported, so on a machine with a card they run as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_*_gpu.py

Bars: ``score_next`` equal bit for bit (lookups and f32 adds in the same
order); the live beams in the same order with equal tokens and lengths, and
scores within 1e-5 relative (the log-sum-exp merges round differently on the
two devices)."""

import pytest
import torch

import chip_smoke
from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
from dynamic_asr_eval_tpu_torch.ops import beam_search as P
from dynamic_asr_eval_tpu_torch.text import load_tokenizer

V, B, K = 4095, 20, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    vocab, arpa, _ = chip_smoke.write_synthetic_lm(str(d), seed=1,
                                                   counts=(20_000, 50_000, 50_000))
    return vocab, arpa


def _adapters(lm_files, cuda):
    vocab, arpa = lm_files
    tok = load_tokenizer(vocab)
    return load_lm_adapter(arpa, tok, device="cpu"), load_lm_adapter(arpa, tok, device=cuda)


def _log_probs(T, seed, blank_lean):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(T, V + 1, generator=g) * 2.5
    logits[:, V] += blank_lean
    return torch.log_softmax(logits, dim=-1)


@pytest.mark.gpu
def test_score_next_equals_the_cpu(cuda, lm_files):
    cpu, gpu = _adapters(lm_files, cuda)
    g = torch.Generator().manual_seed(0)
    ctx = torch.randint(-1, V, (B, 3), generator=g)
    lens = torch.randint(0, 4, (B,), generator=g)
    ctx = torch.where(torch.arange(3)[None] >= 3 - lens[:, None], ctx, -1)
    want = cpu.lm.score_next(ctx, lens)
    got = gpu.lm.score_next(ctx.to(cuda), lens.to(cuda))
    assert got.shape == (B, V) and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("blank_lean,seed", [(0.0, 0), (6.0, 1)])
def test_beam_equals_the_cpu(cuda, lm_files, blank_lean, seed):
    """Token-dense frames (no blank lean) and blank-dominated ones, where
    the blank-only branch and the lazy LM carry run."""
    cpu, gpu = _adapters(lm_files, cuda)
    lp = _log_probs(160, seed, blank_lean)
    kw = dict(beam_width=B, top_k_tokens=K, alpha=0.45, beta=1.53)
    chip_smoke.check_live_beams("beam, card against CPU",
                                P.beam_search_device(lp.to(cuda), gpu, **kw),
                                P.beam_search_device(lp, cpu, **kw))


@pytest.mark.gpu
def test_segmented_decode_and_collapse_equal_the_cpu(cuda, lm_files):
    cpu, gpu = _adapters(lm_files, cuda)
    lp = _log_probs(300, 2, 4.0)
    on_card, n = P.collapse_blank_frames_device(lp.to(cuda), threshold=0.9)
    host = P.collapse_blank_frames(lp.numpy(), threshold=0.9)
    assert int(n) == host.shape[0] and torch.equal(on_card[: int(n)].cpu(), torch.from_numpy(host))
    kw = dict(beam_width=B, top_k_tokens=K, segment_frames=64)
    chip_smoke.check_live_beams("segmented beam, card against CPU",
                                P.beam_search_segmented(on_card[: int(n)], gpu, **kw),
                                P.beam_search_segmented(torch.from_numpy(host), cpu, **kw))
