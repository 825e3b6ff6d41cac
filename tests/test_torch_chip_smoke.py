"""Helpers of chip_smoke.py that read text or CPU tensors only: phase 2's
report of nvcc's ``-Xptxas -v`` output, phase 3's checks that the bf16
kernels round where the plain version rounds, phase 4's kernel names,
phase 9's checkpoint round trip (at a small width) and phase 10's launch
checks on the AWMC path."""

import json

import pytest
import torch

import chip_smoke
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.perf import kernel_name

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
    assert kernel_name(key) == name


def _awmc_counts(n_layers, n_windows):
    return {"attention": (4 * n_layers * n_windows, n_layers * n_windows),
            "subsample": (4 * n_windows, n_windows)}


def test_check_awmc_run_holds_the_per_window_counts(monkeypatch):
    """24 attention forwards and 6 backwards, 4 subsampling forwards and 1
    backward per window at the flagship's 6 layers, all on the bf16 route."""
    monkeypatch.setattr(chip_smoke, "check_driver_output", lambda *args: "output checked")
    cfg, n = chip_smoke.flagship_config(), chip_smoke.N_WINDOWS
    good = _awmc_counts(cfg.n_layers, n)
    assert good["attention"] == (24 * n, 6 * n)
    routes = {"attention": {"tensor_core": good["attention"], "tf32x3": (0, 0)},
              "subsample": {"tensor_core": good["subsample"], "tf32x3": (0, 0)}}
    assert chip_smoke.check_awmc_run(cfg, good, routes, 1.0, {}, None) == "output checked"
    nsti_like = dict(good, attention=(6 * n, 6 * n))
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_awmc_run(cfg, nsti_like, routes, 1.0, {}, None)
    f32_launch = dict(routes, subsample={"tensor_core": (4 * n - 1, n), "tf32x3": (1, 0)})
    with pytest.raises(AssertionError, match="route"):
        chip_smoke.check_awmc_run(cfg, good, f32_launch, 1.0, {}, None)
    f32_attention = dict(routes, attention={"tensor_core": (24 * n, 6 * n - 1), "tf32x3": (0, 1)})
    with pytest.raises(AssertionError, match="route"):
        chip_smoke.check_awmc_run(cfg, good, f32_attention, 1.0, {}, None)


def test_check_checkpoints_round_trips_at_a_small_width(monkeypatch, tmp_path):
    flagship = chip_smoke.flagship_config
    small = dict(n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
                 subsampling_conv_channels=16, conv_kernel_size=5)
    monkeypatch.setattr(chip_smoke, "flagship_config", lambda **kw: flagship(**{**small, **kw}))
    path = chip_smoke.check_checkpoints(str(tmp_path))
    with open(path, "rb") as f:
        assert f.read(4) == b"DAE1"


def test_synthetic_pieces_are_distinct_word_starts():
    pieces = chip_smoke.synthetic_pieces(chip_smoke.LM_VOCAB)
    assert len(set(pieces)) == chip_smoke.LM_VOCAB
    assert pieces[:3] == ["▁a", "▁b", "▁c"] and pieces[26] == "▁aa"
    assert all(p[0] == "▁" and p[1:].isalpha() for p in pieces)


def test_synthetic_lm_loads_with_every_ngram_kept(tmp_path):
    """Phase 13's files at a small size: the vocabulary file is the
    tokenizer, every n-gram maps onto it, and each higher-order n-gram
    extends a lower-order one (so contexts are found, not only backed off)."""
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.lm.ngram import _hash_ctx
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    vocab, arpa, counts = chip_smoke.write_synthetic_lm(str(tmp_path), vocab=50,
                                                        counts=(300, 400, 400))
    tok = load_tokenizer(vocab)
    assert tok.vocab_size() == 50 and counts[0] == 50 and all(c > 250 for c in counts[1:])
    lm = load_lm_adapter(arpa, tok, device="cpu").lm
    assert [lm.keys[k].numel() for k in range(1, 5)] == counts
    from dynamic_asr_eval_tpu_torch.lm import arpa_native

    vocab_list, raw = arpa_native.parse_arpa(arpa)
    ids = {p: tok.pieces.index(p) for p in vocab_list}
    tri = raw[3][0][:20]
    contexts = {_hash_ctx([ids[vocab_list[i]] for i in row[:2]]) for row in tri}
    bigrams = set(lm.keys[2].numpy().view("uint64").tolist())
    assert contexts <= bigrams


def test_wer_pair_has_every_kind_of_edit():
    from dynamic_asr_eval_tpu_torch.text import wer

    hyp, ref = chip_smoke.wer_pair(400)
    assert len(ref.split()) == 400
    counts = wer.wer_counts(hyp, ref)
    assert all(c > 0 for c in counts[:3])
    assert tuple(counts[:3]) == wer._edit_ops(hyp.split(), ref.split())


def test_stored_wer_counts_are_those_of_the_long_pair():
    """Phase 12 holds the native counts of its long pair against stored
    counts (the Python DP's); the pair comes from a seed, so they must agree."""
    from dynamic_asr_eval_tpu_torch.text import wer

    hyp, ref = chip_smoke.wer_pair(chip_smoke.WER_WORDS)
    assert tuple(int(x) for x in wer.wer_counts(hyp, ref)[:3]) == chip_smoke.WER_COUNTS


def test_check_native_libraries_prints_both_pairs(monkeypatch, capsys):
    import json

    monkeypatch.setattr(chip_smoke, "WER_DP_WORDS", 300)
    chip_smoke.check_native_libraries("card")
    line = [json.loads(x) for x in capsys.readouterr().out.splitlines() if "native_wer" in x]
    (res,) = [x["native_wer"] for x in line]
    assert res["ins_del_sub"] == list(chip_smoke.WER_COUNTS) and res["dp_words"] == 300
    assert res["python_dp_s"] >= 0 and res["dp_native_s"] >= 0


def test_check_live_beams_holds_tokens_order_and_scores():
    toks = torch.tensor([[3, 4, 0], [3, 0, 0], [0, 0, 0]])
    lens, scores = torch.tensor([2, 1, 0]), torch.tensor([-1.0, -2.0, -1e30])
    want = (toks, lens, scores)
    assert chip_smoke.check_live_beams("case", want, want) == 0.0
    with pytest.raises(AssertionError, match="tokens"):
        chip_smoke.check_live_beams("case", (toks.flip(0), lens.flip(0), scores), want)
    with pytest.raises(AssertionError, match="relative"):
        chip_smoke.check_live_beams("case", (toks, lens, scores * 1.001), want)


def test_check_launches_exact_holds_forwards_too():
    """Phases 14 and 15 hold the forwards exactly (online NSTI runs no
    re-inference); the default holds them as a lower bound."""
    expect = {"attention": (6, 6)}
    chip_smoke.check_launches({"attention": (18, 18)}, expect, windows=3, exact=True)
    chip_smoke.check_launches({"attention": (19, 18)}, expect, windows=3)
    with pytest.raises(AssertionError, match="=="):
        chip_smoke.check_launches({"attention": (19, 18)}, expect, windows=3, exact=True)


def test_check_routes_refuses_an_f32_launch():
    launches = {"attention": (6, 6)}
    chip_smoke.check_routes("case", launches,
                            {"attention": {"tensor_core": (6, 6), "tf32x3": (0, 0)}})
    with pytest.raises(AssertionError, match="not all on the bf16"):
        chip_smoke.check_routes("case", launches,
                                {"attention": {"tensor_core": (5, 6), "tf32x3": (1, 0)}})


def test_weight_change_of_the_consistency_engine_is_its_least_moved_chunk():
    params = {"w": torch.zeros(3)}
    chunks = [{"w": torch.tensor([0.0, 0.5, 0.0])}, {"w": torch.tensor([0.0, 0.0, -0.25])}]
    assert chip_smoke.weight_change(chunks, params) == 0.25
    assert chip_smoke.weight_change(chunks[0], params) == 0.5
    assert chip_smoke.weight_change(chunks + [params], params) == 0.0


class _Recorder:
    def __init__(self, epochs, n_chunks):
        class Engine:
            config = type("C", (), {"epochs": epochs})

        self.engine = Engine()
        self.outputs = [type("O", (), {"params": [{}] * n_chunks})]


@pytest.mark.parametrize("epochs", [0, 1, 2])
def test_check_consistency_run_holds_the_per_chunk_counts(monkeypatch, epochs):
    """Per chunk and epoch 6 attention forwards and backwards and one
    subsampling forward and backward, then the re-inference's forwards; all
    bf16; one set of weights per chunk."""
    monkeypatch.setattr(chip_smoke, "check_driver_output", lambda *args: "output checked")
    cfg, n = chip_smoke.flagship_config(), chip_smoke.N_WINDOWS
    e = max(epochs, 1)
    good = {"attention": ((e + 1) * 6 * n, e * 6 * n), "subsample": ((e + 1) * n, e * n)}
    routes = {"attention": {"tensor_core": good["attention"], "tf32x3": (0, 0)},
              "subsample": {"tensor_core": good["subsample"], "tf32x3": (0, 0)}}
    rec = _Recorder(epochs, n)
    assert chip_smoke.check_consistency_run(cfg, good, routes, 1.0, {}, rec) == "output checked"
    online_like = dict(good, attention=(e * 6 * n, e * 6 * n))
    with pytest.raises(AssertionError, match="re-inference"):
        chip_smoke.check_consistency_run(cfg, online_like, routes, 1.0, {}, rec)
    with pytest.raises(AssertionError, match="chunks' weights"):
        chip_smoke.check_consistency_run(cfg, good, routes, 1.0, {}, _Recorder(epochs, n - 1))


def test_write_transformer_lm_round_trips_both_files(tmp_path):
    """Phase 14's LM at the published shape over a 50-piece vocabulary: the
    DLM1 file and the lming pickle read back to the same weights."""
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    dlm, pt, cfg, n_params, _ = chip_smoke.write_transformer_lm(str(tmp_path), vocab=50)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.max_cache_length) == (6, 512, 8, 128)
    assert n_params == sum(p.numel() for p in
                           load_lm_adapter(pt, load_tokenizer(chip_smoke.write_vocab(
                               str(tmp_path), 50)), device="cpu").model.parameters())
    with open(dlm, "rb") as f:
        assert f.read(4) == b"DLM1"


class _F32Run:
    """What ``main_path`` returns for one of phase 5c's driver runs."""

    def __init__(self, logits, routes, sub_routes=None):
        import numpy as np

        out = type("Out", (), {"numpy_logits": lambda self: logits,
                               "greedy_ids": lambda self: np.argmax(logits, -1)})()
        by_route = {"attention": routes}
        if sub_routes is not None:
            by_route["subsample"] = sub_routes
        self.result = (1.0, 2.0, {"attention": routes[A.ROUTES[torch.float32]]}, by_route, {},
                       type("R", (), {"outputs": [out]})())


def _f32_path(monkeypatch, capsys, kernel_routes, shift=0.0, sub_routes=None, sub_shift=0.0):
    """Phase 5c's checks on stand-in driver runs: the kernel run with
    ``kernel_routes``, the xla run with no launch, log-probs ``shift`` apart,
    then the fused-subsampling run with ``kernel_routes`` and ``sub_routes``
    (default: 1 / 1 a window on the f32 route), log-probs ``sub_shift``
    apart; returns the launches and the ``{"f32_path": ...}`` line."""
    import json

    import numpy as np

    n = chip_smoke.N_WINDOWS
    if sub_routes is None:
        sub_routes = {"tensor_core": (0, 0), "tf32x3": (n, n)}
    logits = -np.abs(np.random.default_rng(0).standard_normal((50, 7))) * 10
    runs = iter([_F32Run(logits, kernel_routes),
                 _F32Run(logits + shift, {r: (0, 0) for r in A.ROUTES.values()}),
                 _F32Run(logits + sub_shift, kernel_routes, sub_routes)])
    monkeypatch.setattr(chip_smoke, "main_path", lambda cfg, modules: next(runs).result)
    monkeypatch.setattr(chip_smoke, "check_driver_output", lambda *args: None)
    monkeypatch.setattr(chip_smoke, "warm_run_ms", lambda recorder: 90.0)
    launches = chip_smoke.f32_path("card", A, S)
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if "f32_path" in x]
    return launches, line["f32_path"]


def test_f32_path_holds_exact_launches_on_the_f32_route(monkeypatch, capsys):
    """Phase 5c: 6 forward and 6 backward attention launches per window, all
    on the f32 route, and in the third run 1 / 1 subsampling launches per
    window on it; its line carries every run's ms per window and RTFx."""
    n = chip_smoke.N_WINDOWS
    good = {"tensor_core": (0, 0), "tf32x3": (6 * n, 6 * n)}
    launches, line = _f32_path(monkeypatch, capsys, good)
    assert launches == {"flash_attention_f32": (6 * n, 6 * n), "fused_subsample_f32": (n, n)}
    assert line["launches"] == [6 * n, 6 * n] and line["subsample_launches"] == [n, n]
    assert line["route"] == line["subsample_route"] == "tf32x3" and line["max_abs_err"] == 0.0
    for name in ("pallas_flash", "xla", "pallas_subsampling"):
        assert line[name]["ms_per_window"] == 90.0 / n
        assert line[name]["rtfx"] == chip_smoke.N_FRAMES / 100.0 / 0.09


@pytest.mark.parametrize("routes", [{"tensor_core": (1, 0), "tf32x3": (54, 54)},
                                    {"tensor_core": (0, 0), "tf32x3": (55, 54)},
                                    {"tensor_core": (0, 0), "tf32x3": (54, 53)}])
def test_f32_path_refuses_other_launch_counts(monkeypatch, capsys, routes):
    with pytest.raises(AssertionError, match="f32 path: attention launches"):
        _f32_path(monkeypatch, capsys, routes)


@pytest.mark.parametrize("sub_routes", [{"tensor_core": (1, 0), "tf32x3": (9, 9)},
                                        {"tensor_core": (0, 0), "tf32x3": (10, 9)},
                                        {"tensor_core": (0, 0), "tf32x3": (9, 8)}])
def test_f32_path_refuses_other_subsampling_launch_counts(monkeypatch, capsys, sub_routes):
    good = {"tensor_core": (0, 0), "tf32x3": (54, 54)}
    with pytest.raises(AssertionError, match="f32 path: subsampling launches"):
        _f32_path(monkeypatch, capsys, good, sub_routes=sub_routes)


def test_f32_path_refuses_log_probs_past_its_bar(monkeypatch, capsys):
    """Stitched log-probs more than 1e-3 of max |log-prob| from the kernel
    attention run fail the phase (the stand-in's max |log-prob| is ~40), for
    the xla run and for the fused-subsampling run."""
    good = {"tensor_core": (0, 0), "tf32x3": (54, 54)}
    _f32_path(monkeypatch, capsys, good, shift=0.02, sub_shift=0.02)
    with pytest.raises(AssertionError, match="xla vs the kernel attention run"):
        _f32_path(monkeypatch, capsys, good, shift=0.08)
    with pytest.raises(AssertionError, match="pallas_subsampling vs the kernel attention run"):
        _f32_path(monkeypatch, capsys, good, sub_shift=0.08)


def test_subsample_bounds_take_the_products_as_three_tf32_products():
    """Phase 4's f32 subsampling bound at the flagship window: the pointwise
    products three times at 495 TFLOP/s, the rest at 67 on the CUDA cores
    (0.222 / 0.620 ms); the same work all on the CUDA cores 0.460 / 1.334."""
    work = chip_smoke.subsample_work(*chip_smoke.SUB_FLAGSHIP, torch.float32)
    got = {k: chip_smoke.tf32x3_bound(f, p, b) for k, (f, b, p) in work.items()}
    cuda_core = {k: chip_smoke.bound(f, b, chip_smoke.F32_FLOPS) for k, (f, b, _) in work.items()}
    assert [round(got[k][0], 3) for k in ("fwd", "bwd")] == [0.222, 0.620]
    assert [round(cuda_core[k][0], 3) for k in ("fwd", "bwd")] == [0.460, 1.334]
    assert {by for _, by in got.values()} == {"operations"}


# ---------------------------------------------------------------------------
# phases 16-16c: the protocol drivers' plans and checks
# ---------------------------------------------------------------------------


def test_half_concat_plan_at_the_flagship():
    """Phase 16: each fold adapts only on a 61440-frame concatenation (24
    windows) and evaluates 2 records of 9 windows (3 forwards of 4, 4, 1
    windows each); the baseline evaluates all 4 records."""
    assert chip_smoke.n_windows(2 * chip_smoke.N_FRAMES) == 24
    plan = chip_smoke.half_concat_plan(chip_smoke.N_FRAMES, chip_smoke.HALF_RECORDS, 4)
    assert (plan["adapted"], plan["evaluated"], plan["forwards"]) == (48, 72, 12 + 2 * (24 + 6))
    assert (plan["adapt_calls"], plan["eval_calls"]) == (2, 8)
    assert chip_smoke.plan_launches(plan, 6) == {"attention": (432, 288), "subsample": (72, 48)}


def test_loo_plan_at_the_flagship():
    """Phase 16b: 10 chunks of 65536 frames every 8192 (the last 57344);
    chunks {0, 1, 8, 9} have audio-disjoint partners: 4 adaptations (26, 26,
    26 and 22 windows, each re-inferred offline) and 6 windowed inferences."""
    plan = chip_smoke.loo_plan(chip_smoke.LOO_FRAMES, chip_smoke.LOO_SEQ, chip_smoke.LOO_OVERLAP, 4)
    assert (plan["n_chunks"], plan["usable"], plan["pairs"]) == (10, [0, 1, 8, 9], 6)
    assert (plan["adapted"], plan["discarded"], plan["evaluated"]) == (100, 100, 148)
    assert plan["forwards"] == 100 + (7 + 7 + 7 + 6) + (7 + 6) + 6 + 7 + (7 + 7)


def test_seq_plan_at_the_flagship():
    """Phase 16c: 6 outer chunks (five of 32768 frames, the stop rule adds
    one of 28672), of 10, 10, 10, 10, 10 and 8 windows, each adapted and
    re-inferred."""
    plan = chip_smoke.seq_plan(chip_smoke.SEQ_FRAMES, chip_smoke.NSTI_SEQ,
                               chip_smoke.NSTI_OVERLAP, 4)
    assert plan["inner_windows"] == [10, 10, 10, 10, 10, 8]
    assert (plan["adapted"], plan["forwards"]) == (58, 58 + 5 * 3 + 2)
    assert chip_smoke.plan_launches(plan, 6) == {"attention": (450, 348), "subsample": (75, 58)}


def test_check_protocol_launches_is_exact_and_bf16_only():
    want = {"attention": (432, 288), "subsample": (72, 48), "softdtw": (0, 0)}
    routes = {"attention": {"tensor_core": (432, 288), "tf32x3": (0, 0)},
              "subsample": {"tensor_core": (72, 48), "tf32x3": (0, 0)}}
    chip_smoke.check_protocol_launches("case", want, routes, want)
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_protocol_launches("case", dict(want, subsample=(73, 48)), routes, want)
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_protocol_launches("case", dict(want, softdtw=(1, 0)), routes, want)
    f32 = dict(routes, attention={"tensor_core": (431, 288), "tf32x3": (1, 0)})
    with pytest.raises(AssertionError, match="not all on the bf16"):
        chip_smoke.check_protocol_launches("case", want, f32, want)


def _tiny_protocol(monkeypatch, driver):
    """Phase 16's machinery on the CPU at a tiny size: records of 320
    frames, windows of 256 / 192."""
    flagship = chip_smoke.flagship_config
    small = dict(n_layers=1, d_model=32, n_heads=2, head_dim=16, vocab_size=30,
                 subsampling_conv_channels=8, conv_kernel_size=3, compute_dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "SEQ", 256)
    monkeypatch.setattr(chip_smoke, "OVERLAP", 192)
    monkeypatch.setattr(chip_smoke.n_windows, "__defaults__", (256, 192))
    parse = driver.parse_args
    monkeypatch.setattr(driver, "parse_args", lambda argv: parse(["--device", "cpu"] + argv))
    return flagship(**small)


def test_half_concat_checks_hold_the_driver_run(monkeypatch):
    """The driver's own run passes ``check_half_concat``: adapt-only folds
    from the pristine weights, which stay unchanged, and each evaluation
    with its fold's weights; an evaluation with the wrong weights fails."""
    from dynamic_asr_eval_tpu_torch.evals import run_half_concat_eval as driver

    cfg = _tiny_protocol(monkeypatch, driver)
    run = chip_smoke.ProtocolRun(driver)
    result, _, launches, _, detail = run(cfg, [320] * 4, ["-ao", "192"], {"attention": A},
                                         "r.pkl")
    plan = chip_smoke.half_concat_plan(320, 4, run.adapt.infer_batch)
    assert (plan["adapted"], plan["eval_calls"]) == (2 * 8, 8)
    assert launches == {"attention": (0, 0)}  # nothing counts on the CPU
    # adapt-only folds never re-infer; each evaluation is one timed inference
    assert run.adapt.infer_seconds == []
    assert len(run.eval.infer_seconds) == len(run.eval.calls) == plan["eval_calls"]
    moved = chip_smoke.check_half_concat(run, result, detail, plan)
    assert len(moved) == 2 and min(moved) > 0
    run.eval.calls[-1] = (run.params,) + run.eval.calls[-1][1:]
    with pytest.raises(AssertionError, match="wrong weights"):
        chip_smoke.check_half_concat(run, result, detail, plan)
    next(iter(run.params.values())).add_(1.0)
    with pytest.raises(AssertionError, match="pristine weights changed"):
        run.check_pristine("half-concat")


def test_check_stitched_refuses_a_gap_and_non_finite_values():
    import numpy as np

    cfg = chip_smoke.flagship_config()
    good = np.zeros((16, cfg.n_classes), np.float32)
    chip_smoke.check_stitched("case", good, 128, cfg)
    with pytest.raises(AssertionError, match="stitched"):
        chip_smoke.check_stitched("case", good[:-1], 128, cfg)
    good[3, 2] = np.nan
    with pytest.raises(AssertionError, match="finite False"):
        chip_smoke.check_stitched("case", good, 128, cfg)


def test_softdtw_chain_reads_the_kernels_constants():
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D

    text = D.SOURCE.read_text()
    for name in ("PANEL", "CHUNK", "FWD_WARPS", "BWD_WARPS"):
        value = chip_smoke.softdtw_constant(D, name)
        assert f"constexpr int {name} = {value};" in text
    assert chip_smoke.SDTW_STRIP[1] == 32  # a single strip: one warp, no ring to wait on


def test_softdtw_chain_floor_is_the_steps_at_one_steps_latency(monkeypatch, capsys):
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D

    steps = {"fwd": {"cycles": 90.0, "ns": 50.0, "mhz": 1800.0},
             "bwd": {"cycles": 36.0, "ns": 20.0, "mhz": 1800.0}}
    monkeypatch.setattr(D, "chain_step",
                        lambda backward=False: dict(steps["bwd" if backward else "fwd"]))
    # the kernels on the strip: 544 steps (a 512-column panel takes 543,
    # rounded up to chunks of 8) in each of 8 panels
    monkeypatch.setattr(chip_smoke, "softdtw_kernel_ms", lambda D_, shape, iters: (0.8704, 0.4352))
    floors = chip_smoke.softdtw_chain(D, "card", ((4, 256, 256), (1, 64, 64)))
    assert floors["(4, 256, 256)"] == pytest.approx({"fwd": 511 * 50e-6, "bwd": 511 * 20e-6})
    assert floors["(1, 64, 64)"] == pytest.approx({"fwd": 127 * 50e-6, "bwd": 127 * 20e-6})
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["softdtw_chain"]
    assert line["chain_step"] == steps and line["floor_ms"] == floors
    strip = line["single_strip"]
    assert strip["steps"] == 8 * 544
    assert strip["step_ns"] == pytest.approx({"fwd": 0.8704e6 / 4352, "bwd": 0.4352e6 / 4352})
