"""Encoder-decoder TTA with RL (GRPO / MaxRL) or teacher-CE updates.

Counterpart of the JAX package's ``tta/encdec_rl.py``.  Per chunk of the
recording (the chunks never overlap):

1. the teacher's greedy decode of the clean copy;
2. where the filters need them, the teacher-forced pass (mean max
   probability, mean entropy, the CTC branch's greedy text) and a sampled
   agreement decode; :func:`..tta.filters.should_skip_teacher` vetoes the
   chunk (``Skipping teacher update: {reason}`` is printed);
3. the update, on the augmented copy:
   - ``teacher_ce``: the joint CTC + CE loss against the teacher transcript
     at batch 1, the CTC term normalised by the chunk's real downsampled
     length (×100) and weighted by ``ctc_loss_weight``, the CE term summed
     over the text positions and divided by their count;
   - ``grpo`` / ``maxrl``: ``num_rollouts`` samples from the augmented copy,
     rewards against the teacher (:func:`calc_rewards`; the chunk is skipped
     when their mean exceeds ``reward_skip_threshold``), then the policy loss
     at batch ``num_rollouts`` (the audio repeated): GRPO the sequence-mean
     log-probability times the group-normalised advantage, MaxRL the
     per-token log-probability times the binarised pass-rate advantage
     (skipped when every rollout passes or none does);
4. a MADGRAD step (``optim_args``, lr default 9e-5); the decoder's
   ``pos_enc`` is frozen: no gradient, no update, no optimizer state.

The transcript is :func:`enc_dec_inference` with the adapted weights.  The
CTC term is :func:`..ops.ctc.ctc_loss`: a teacher transcript that cannot
align to the chunk's frames costs 1e30 there with no gradient (JAX's −1e30
floor gives the same value and a path-count gradient that overflows at a
few hundred frames; ROADMAP, known behaviours).  Random draws (SpecAugment,
rollouts, the agreement decode) come from one ``torch.Generator`` seeded
from ``rng``.  Runs on ``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.augment.spec_augment import spec_augment
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig, generate_encdec
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_decode
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD
from dynamic_asr_eval_tpu_torch.text.bleu import bleu
from dynamic_asr_eval_tpu_torch.text.wer import word_error_rate_detail
from dynamic_asr_eval_tpu_torch.tta.filters import TeacherFilterConfig, should_skip_teacher

TRAINING_MODES = ("grpo", "maxrl", "teacher_ce")
FROZEN = ("pos_enc.weight",)


def calc_rewards(ref: str, hyps: List[str]) -> List[float]:
    """Mean of (1−WER, 1−CER, BLEU/100) per hypothesis; 1 when both are
    empty, minus the hypothesis' word count when only the reference is."""
    rewards = []
    for hyp in hyps:
        if len(hyp.strip()) == 0 and len(ref.strip()) == 0:
            rewards.append(1.0)
            continue
        if len(ref.strip()) == 0 and len(hyp.strip()) > 0:
            rewards.append(len(hyp.strip().split()) * -1.0)
            continue
        wer = 1.0 - word_error_rate_detail([hyp], [ref])[0]
        cer = 1.0 - word_error_rate_detail([hyp], [ref], use_cer=True)[0]
        rewards.append((wer + cer + bleu(hyp, ref) / 100.0) / 3.0)
    return rewards


def add_eos_and_targets(tokens_bos: torch.Tensor, lengths_bos: torch.Tensor, eos_id: int):
    """Shift-left targets with EOS at each sequence's end, and the mask of
    the positions inside ``lengths_bos``."""
    targets = torch.cat([tokens_bos[:, 1:], torch.zeros_like(tokens_bos[:, :1])], dim=1)
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    targets = torch.where(pos == (lengths_bos - 1)[:, None],
                          torch.full_like(targets, eos_id), targets)
    return targets, pos < lengths_bos[:, None]


def _with_bos(tokens: torch.Tensor, bos_id: int) -> torch.Tensor:
    bos = torch.full((tokens.shape[0], 1), bos_id, dtype=torch.int64, device=tokens.device)
    return torch.cat([bos, tokens.long()], dim=1)


def _token_log_probs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    lps = torch.log_softmax(logits, dim=-1)
    return torch.gather(lps, -1, targets.long()[..., None])[..., 0]


def _ids(tokens: torch.Tensor, length) -> List[int]:
    return [int(x) for x in tokens.tolist()[: int(length)]]


class EncDecDynamicEvalEngine:
    def __init__(
        self,
        model,
        config: EncDecConfig,
        tta_config: TTAConfig,
        filter_config: Optional[TeacherFilterConfig] = None,
        training_mode: str = "grpo",  # grpo | maxrl | teacher_ce
        num_rollouts: int = 4,
        max_generate: int = 256,
        maxrl_success_threshold: float = 0.9,
        reward_skip_threshold: float = 0.95,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if training_mode not in TRAINING_MODES:
            raise ValueError(f"training_mode {training_mode!r}: one of {TRAINING_MODES}")
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.tta = tta_config
        self.filters = filter_config or TeacherFilterConfig()
        self.training_mode = training_mode
        self.num_rollouts = num_rollouts
        self.max_generate = max_generate
        self.maxrl_success_threshold = maxrl_success_threshold
        self.reward_skip_threshold = reward_skip_threshold
        opt_args = dict(tta_config.optim_args)
        self.lr = opt_args.pop("lr", 9e-5)
        self.opt_args = opt_args
        self._work = copy.deepcopy(model).to(self.device)

    def _load(self, params: Optional[Dict[str, torch.Tensor]]) -> List[torch.nn.Parameter]:
        """The working copy at ``params``; returns the trained parameters
        (all but the frozen ``pos_enc``)."""
        src = self.model.state_dict() if params is None else params
        self._work.load_state_dict(src, strict=True)
        trained = []
        for name, p in self._work.named_parameters():
            p.requires_grad_(name not in FROZEN)
            if name not in FROZEN:
                trained.append(p)
        return trained

    def _generator(self, rng: Union[int, torch.Generator, None]) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(int(rng or 0))

    # -- losses ---------------------------------------------------------------

    def _policy_loss(self, audio, a_len, hyp_tokens, hyp_lengths, advantages, per_token: bool):
        """The policy-gradient loss over the rollouts, at their batch."""
        cfg = self.config
        B = hyp_tokens.shape[0]
        tokens_bos = _with_bos(hyp_tokens, cfg.bos_id)
        lengths_bos = hyp_lengths.long() + 1
        out = self._work(audio.repeat(B, 1, 1), tokens_bos, length=a_len.repeat(B),
                         text_lengths=lengths_bos)
        targets, mask = add_eos_and_targets(tokens_bos, lengths_bos, cfg.eos_id)
        tok_lps = _token_log_probs(out["final_posteriors_lm"], targets)
        if per_token:  # maxrl: mean over all tokens of -lp * adv
            per_tok = torch.where(mask, -tok_lps * advantages[:, None], torch.zeros_like(tok_lps))
            return per_tok.sum() / torch.clamp(mask.sum(), min=1)
        # grpo: sequence-mean log-prob × advantage
        counts = torch.clamp(mask.sum(dim=-1), min=1)
        seq_mean = (tok_lps * mask).sum(dim=-1) / counts
        return -(seq_mean * advantages).mean()

    def _teacher_ce_loss(self, audio, a_len, teacher_tokens, teacher_len: int):
        """The joint CTC + CE loss against the teacher transcript."""
        cfg = self.config
        B = audio.shape[0]
        tokens = teacher_tokens[None].repeat(B, 1)
        t_lens = torch.full((B,), teacher_len, dtype=torch.int64, device=self.device)
        tokens_bos = _with_bos(tokens, cfg.bos_id)
        lengths_bos = t_lens + 1
        out = self._work(audio, tokens_bos, length=a_len.repeat(B), text_lengths=lengths_bos)
        w = cfg.ctc_loss_weight
        loss = 0.0
        if w > 0:
            ctc_lp, ds_len = out["final_posteriors_ctc"], out["length"]
            # over the chunk's real downsampled length, not the padded one
            ctc = ctc_loss(ctc_lp, ds_len, tokens, t_lens, blank_id=cfg.encoder.blank_id) / (
                ctc_lp.shape[0] * torch.clamp(ds_len[0], min=1)) * 100
            loss = loss + w * ctc
        logits = out["final_posteriors_lm"]
        targets, mask = add_eos_and_targets(tokens_bos, lengths_bos, cfg.eos_id)
        nll = -_token_log_probs(logits, targets)
        ce = torch.where(mask, nll, torch.zeros_like(nll)).sum() / (logits.shape[0]
                                                                     * logits.shape[1])
        return loss + (1 - w) * ce

    def _step(self, opt: MADGRAD, loss: torch.Tensor) -> None:
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    # -- the teacher and its filters -------------------------------------------

    def _generate(self, audio, a_len, generator, sample=1, greedy=True, temperature=1.0,
                  encoder_out=None):
        return generate_encdec(self._work, audio, self.config, generator=generator,
                               sample=sample, greedy=greedy, temperature=temperature,
                               max_generate=self.max_generate, length=a_len,
                               encoder_out=encoder_out)

    @torch.no_grad()
    def _teacher_forced(self, audio, a_len, teacher_tokens: List[int], tokenizer):
        """(mean max prob, mean entropy, the CTC branch's greedy text or None)
        of the teacher-forced pass."""
        cfg = self.config
        t_len = len(teacher_tokens)
        tf_tokens = torch.tensor([[cfg.bos_id] + teacher_tokens], dtype=torch.int64,
                                 device=self.device)
        out = self._work(audio, tf_tokens, length=a_len)
        probs = torch.softmax(out["final_posteriors_lm"][0, :t_len], dim=-1)
        mean_max_prob = float(probs.max(dim=-1).values.mean())
        plogp = probs * torch.log(torch.clamp(probs, min=1e-12))
        mean_entropy = float((-plogp.sum(dim=-1)).mean())
        ctc_text = None
        if self.filters.ctc_agreement_enabled:
            ctc_text = greedy_decode(out["final_posteriors_ctc"][0], tokenizer,
                                     cfg.encoder.blank_id,
                                     input_length=int(out["length"][0])).strip()
        return mean_max_prob, mean_entropy, ctc_text

    # -- main -------------------------------------------------------------------

    def __call__(
        self,
        params: Optional[Dict[str, torch.Tensor]],
        spec: np.ndarray,
        seq_len: int,
        tokenizer,
        rng: Union[int, torch.Generator, None] = None,
        return_params: bool = False,
    ):
        """Adapt over ``spec`` ([F, T] or [1, F, T]) from ``params`` (a state
        dict; ``None``: the engine's own model's weights; not modified) →
        (transcript, the adapted state dict when ``return_params``, elapsed
        seconds)."""
        cfg = self.config
        tta = self.tta
        spec = np.asarray(spec)
        if spec.ndim == 3:
            spec = spec[0]
        spec_n = spec.shape[-1]
        seq_len = min(seq_len, spec_n)
        starts, lengths = chunk_starts_and_lengths(spec_n, seq_len, 0)
        trained = self._load(params)
        gen = self._generator(rng)
        opt = MADGRAD(trained, lr=self.lr, **self.opt_args)
        opt.zero_grad(set_to_none=True)

        t0 = time.time()
        for _ in range(max(tta.epochs, 0)):
            for s, L in zip(starts, lengths):
                chunk_p = np.zeros((spec.shape[0], seq_len), np.float32)
                chunk_p[:, :L] = spec[:, s:s + L]
                audio = torch.as_tensor(chunk_p, device=self.device)[None]
                a_len = torch.tensor([L], dtype=torch.int64, device=self.device)
                aug = spec_augment(audio, gen, tta.spec_augment)

                # the teacher: greedy decode of the clean copy
                t_toks, t_lens, enc_out = self._generate(audio, a_len, gen)
                t_len = int(t_lens[0])
                teacher_tokens = _ids(t_toks[0], t_len)
                teacher_text = tokenizer.decode(teacher_tokens).strip()

                mean_max_prob = mean_entropy = ctc_text = agreement_text = None
                if self.filters.needs_teacher_forced_pass and t_len > 0:
                    mean_max_prob, mean_entropy, ctc_text = self._teacher_forced(
                        audio, a_len, teacher_tokens, tokenizer)
                if self.filters.needs_agreement_decode:
                    ag_toks, ag_lens, _ = self._generate(
                        audio, a_len, gen, greedy=False,
                        temperature=self.filters.decode_agreement_temperature,
                        encoder_out=enc_out)
                    agreement_text = tokenizer.decode(_ids(ag_toks[0], ag_lens[0])).strip()

                skip, reason = should_skip_teacher(
                    self.filters, teacher_tokens, teacher_text, L,
                    agreement_text, mean_max_prob, mean_entropy, ctc_text)
                if skip:
                    print(f"Skipping teacher update: {reason}")
                    continue

                if self.training_mode == "teacher_ce":
                    if t_len == 0:
                        continue
                    self._step(opt, self._teacher_ce_loss(
                        aug, a_len, torch.tensor(teacher_tokens, dtype=torch.int64,
                                                 device=self.device), t_len))
                    continue
                # rollouts from the augmented copy
                r_toks, r_lens, _ = self._generate(aug, a_len, gen, sample=self.num_rollouts,
                                                   greedy=False)
                r_lens_host = r_lens.tolist()
                hyps = [tokenizer.decode(_ids(r_toks[i], r_lens_host[i])).strip()
                        for i in range(self.num_rollouts)]
                rewards = calc_rewards(teacher_text, hyps)
                if sum(rewards) / len(rewards) > self.reward_skip_threshold:
                    continue
                if self.training_mode == "maxrl":
                    binr = np.array([1.0 if r >= self.maxrl_success_threshold else 0.0
                                     for r in rewards], np.float32)
                    pass_rate = binr.mean()
                    if pass_rate <= 0 or pass_rate >= 1:
                        continue
                    advs = (binr - pass_rate) / (pass_rate + 1e-6)
                else:
                    r = np.asarray(rewards, np.float32)
                    advs = (r - r.mean()) / (r.std() + 1e-7)
                self._step(opt, self._policy_loss(
                    aug, a_len, r_toks, r_lens, torch.as_tensor(advs, device=self.device),
                    per_token=self.training_mode == "maxrl"))

        transcript = enc_dec_inference(self._work, spec, seq_len, tokenizer, cfg,
                                       max_generate=self.max_generate)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.time() - t0
        adapted = None
        if return_params:
            adapted = {k: v.detach().clone() for k, v in self._work.state_dict().items()}
        return transcript, adapted, elapsed


@torch.no_grad()
def enc_dec_inference(model, spec, seq_len: int, tokenizer, config: EncDecConfig,
                      max_generate: int = 256) -> str:
    """Chunked greedy AR transcription of ``spec`` ([F, T] or [1, F, T]) with
    ``model``'s weights, on the model's device."""
    spec = np.asarray(spec)
    if spec.ndim == 3:
        spec = spec[0]
    spec_n = spec.shape[-1]
    seq_len = min(seq_len, spec_n)
    dev = next(model.parameters()).device
    texts = []
    for s, L in zip(*chunk_starts_and_lengths(spec_n, seq_len, 0)):
        chunk_p = np.zeros((spec.shape[0], seq_len), np.float32)
        chunk_p[:, :L] = spec[:, s:s + L]
        toks, lens, _ = generate_encdec(
            model, torch.as_tensor(chunk_p, device=dev)[None], config,
            max_generate=max_generate, length=torch.tensor([L], dtype=torch.int64, device=dev))
        texts.append(tokenizer.decode(_ids(toks[0], lens[0])).strip())
    return " ".join(texts).replace("  ", " ").strip()
