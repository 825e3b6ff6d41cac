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

torch.set_num_threads(1)

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
    path = chip_smoke.check_checkpoints(str(tmp_path), device="cpu")
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


def _graphed_engine(captures, replays):
    graphs = type("Graphs", (), {"captures": captures, "replays": replays})()
    return type("Engine", (), {"graphs": graphs})()


def test_graph_offset_is_two_a_capture_less_one_a_replay():
    """The NSTI engine's graphs: a capture's warm-up and capture passes run
    the kernels' wrappers, a replay none; an engine without graphs, or
    none, adds nothing."""
    assert chip_smoke.graph_offset() == 0
    assert chip_smoke.graph_offset(None, object()) == 0
    assert chip_smoke.graph_offset(_graphed_engine(1, 8)) == -6
    assert chip_smoke.graph_offset(_graphed_engine(1, 8), None, _graphed_engine(2, 3)) == -5


def test_check_launches_counts_the_adapt_steps_graphed_passes():
    """9 windows, one capture and 8 replays: the counters see 3 adapt-step
    passes; with ``graphed`` only that part of the plan is scaled."""
    offset = chip_smoke.graph_offset(_graphed_engine(1, 8))
    expect = {"attention": (6, 6)}
    chip_smoke.check_launches({"attention": (18, 18)}, expect, windows=9, exact=True,
                              offset=offset)
    with pytest.raises(AssertionError, match="== 18"):
        chip_smoke.check_launches({"attention": (54, 54)}, expect, windows=9, offset=offset)
    plan = {"attention": (12, 12), "subsample": (2, 2)}
    graphed = {"attention": (6, 6), "subsample": (1, 1)}
    chip_smoke.check_launches({"attention": (72, 72), "subsample": (12, 12)}, plan, windows=9,
                              exact=True, offset=offset, graphed=graphed)
    assert chip_smoke.plan_launches({"forwards": 72, "adapted": 48}, 6, offset) == {
        "attention": (396, 252), "subsample": (66, 42)}


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

    def __init__(self, logits, routes, sub_routes=None, graphs=None):
        import numpy as np

        out = type("Out", (), {"numpy_logits": lambda self: logits,
                               "greedy_ids": lambda self: np.argmax(logits, -1)})()
        by_route = {"attention": routes}
        if sub_routes is not None:
            by_route["subsample"] = sub_routes
        recorder = {"outputs": [out]}
        if graphs is not None:
            recorder["graphs"] = type("Graphs", (), dict(zip(("captures", "replays"), graphs)))()
        self.result = (1.0, 2.0, {"attention": routes[A.ROUTES[torch.float32]]}, by_route, {},
                       type("R", (), recorder)())


def _f32_path(monkeypatch, capsys, kernel_routes, shift=0.0, sub_routes=None, sub_shift=0.0,
              graphs=None):
    """Phase 5c's checks on stand-in driver runs: the kernel run with
    ``kernel_routes``, the xla run with no launch, log-probs ``shift`` apart,
    then the fused-subsampling run with ``kernel_routes`` and ``sub_routes``
    (default: 1 / 1 a window on the f32 route), log-probs ``sub_shift``
    apart, the two kernel runs' engines with ``graphs`` (captures, replays);
    returns the launches and the ``{"f32_path": ...}`` line."""
    import json

    import numpy as np

    n = chip_smoke.N_WINDOWS
    if sub_routes is None:
        sub_routes = {"tensor_core": (0, 0), "tf32x3": (n, n)}
    logits = -np.abs(np.random.default_rng(0).standard_normal((50, 7))) * 10
    runs = iter([_F32Run(logits, kernel_routes, graphs=graphs),
                 _F32Run(logits + shift, {r: (0, 0) for r in A.ROUTES.values()}),
                 _F32Run(logits + sub_shift, kernel_routes, sub_routes, graphs=graphs)])
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


def test_f32_path_counts_the_graphed_passes(monkeypatch, capsys):
    """Engines that captured one graph and replayed 8 windows: the kernel
    runs' counters see 3 passes of 6 / 6 attention and 1 / 1 subsampling
    launches; the 9 windows' eager counts are refused."""
    graphed = {"tensor_core": (0, 0), "tf32x3": (18, 18)}
    launches, _ = _f32_path(monkeypatch, capsys, graphed, graphs=(1, 8),
                            sub_routes={"tensor_core": (0, 0), "tf32x3": (3, 3)})
    assert launches == {"flash_attention_f32": (18, 18), "fused_subsample_f32": (3, 3)}
    with pytest.raises(AssertionError, match="f32 path: attention launches"):
        _f32_path(monkeypatch, capsys, {"tensor_core": (0, 0), "tf32x3": (54, 54)},
                  graphs=(1, 8), sub_routes={"tensor_core": (0, 0), "tf32x3": (3, 3)})


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


# ---------------------------------------------------------------------------
# phases 17 and 18: entropy augmentation and the NeMo preset
# ---------------------------------------------------------------------------


def test_phases_17_and_18_are_listed_and_driven():
    doc = chip_smoke.__doc__
    assert "\n17. entropy augmentation" in doc and "\n18. the NeMo preset" in doc
    import inspect

    main = inspect.getsource(chip_smoke.main)
    assert "entropy_path(card, A, S, D" in main and "nemo_path(tmp, card, A, S, D)" in main


def _routes(launches):
    return {k: {"tensor_core": v, "tf32x3": (0, 0)} for k, v in launches.items()
            if k != "softdtw"}


def test_entropy_plan_is_12_12_2_2_with_one_gx_per_window():
    """Per adapted window at the flagship's 6 layers: 12 attention forwards
    and backwards (the batch-1 entropy pass and the batch-2 step), 2
    subsampling forwards and backwards, exactly one of them with gx."""
    n = chip_smoke.N_WINDOWS
    plan = chip_smoke.entropy_plan(chip_smoke.flagship_config().n_layers)
    assert plan == {"attention": (12, 12), "subsample": (2, 2), "softdtw": (0, 0), "gx": 1}
    good = {"attention": (12 * n, 12 * n), "subsample": (2 * n, 2 * n), "softdtw": (0, 0)}
    chip_smoke.check_path_launches("entropy", good, _routes(good), n, plan)
    with pytest.raises(AssertionError, match="gx"):
        chip_smoke.check_path_launches("entropy", good, _routes(good), 2 * n, plan)
    nsti_like = dict(good, attention=(6 * n, 6 * n))
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_path_launches("entropy", nsti_like, _routes(nsti_like), n, plan)
    f32 = _routes(good)
    f32["subsample"] = {"tensor_core": (2 * n - 1, 2 * n), "tf32x3": (1, 0)}
    with pytest.raises(AssertionError, match="route"):
        chip_smoke.check_path_launches("entropy", good, f32, n, plan)


def test_nemo_plan_is_no_attention_and_one_relu_subsampling_pair():
    n = chip_smoke.N_WINDOWS
    plan = chip_smoke.NEMO_PLAN
    good = {"attention": (0, 0), "subsample": (n, n), "softdtw": (0, 0)}
    acts = {"silu": (0, 0), "relu": (n, n), "gelu": (0, 0)}
    chip_smoke.check_path_launches("nemo", good, _routes(good), 0, plan, acts=acts, act="relu")
    with pytest.raises(AssertionError, match="activation"):
        chip_smoke.check_path_launches("nemo", good, _routes(good), 0, plan,
                                       acts=dict(acts, relu=(0, 0), silu=(n, n)), act="relu")
    flash = dict(good, attention=(6 * n, 6 * n))
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_path_launches("nemo", flash, _routes(flash), 0, plan, acts=acts,
                                       act="relu")
    with pytest.raises(AssertionError, match="gx"):
        chip_smoke.check_path_launches("nemo", good, _routes(good), 1, plan, acts=acts,
                                       act="relu")


def test_synthetic_nemo_state_converts_shape_complete_with_moved_statistics():
    """Phase 18's state dict (NeMo names) through the port's converter at a
    small width loads strictly, running statistics as drawn."""
    import dataclasses

    from dynamic_asr_eval_tpu_torch.models import SCConformer
    from dynamic_asr_eval_tpu_torch.models.nemo_convert import (
        convert_nemo_state_dict,
        load_default_instance,
    )

    cfg = dataclasses.replace(load_default_instance(), n_layers=2, d_model=32, n_heads=2,
                              head_dim=16, vocab_size=20, subsampling_conv_channels=8)
    sd = chip_smoke.synthetic_nemo_state(cfg)
    model = SCConformer(cfg)
    model.load_state_dict(convert_nemo_state_dict(sd, cfg), strict=True)
    var = model.layers[1].conv.norm_mid.running_var
    assert torch.equal(var, sd["encoder.layers.1.conv.batch_norm.running_var"])
    assert 0.5 <= var.min() and var.max() <= 2.0 and var.std() > 0.1


def test_subsample_bound_with_gx_adds_stage_zeros_operations_and_gx_bytes():
    B, T, F, C = chip_smoke.SUB_FLAGSHIP
    work = chip_smoke.subsample_work(B, T, F, C, torch.bfloat16)
    T0 = S.ceil_chain(T)[0]
    stage0 = 18 * B * T0 * F // 2 * C
    assert work["bwd_gx"][0] == work["bwd"][0] + stage0
    assert work["bwd_gx"][1] == work["bwd"][1] + B * T * F * 2
    assert work["bwd_gx"][2] == work["bwd"][2]


@pytest.mark.parametrize("plain_rounds", [True, False])
def test_check_subsample_relu_rounding_holds_the_rounding_points(monkeypatch, plain_rounds):
    """Phase 3's relu case: the plain version on the bf16 tensors passes;
    the plain version in f32, rounded once at the end, fails (out's
    elements differ)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    x, ws, gout = _subsample_case()
    if plain_rounds:
        out = S.fused_subsample_reference(x, *ws, act_name="relu")
        gx, gws = S.fused_subsample_reference_bwd(x, ws, gout, "relu", True)
    else:
        out = S.fused_subsample_reference(x.float(), *ws, act_name="relu").bfloat16()
        gx, gws = S.fused_subsample_reference_bwd(x.float(), ws, gout.float(), "relu", True)
        gx = gx.bfloat16()
    args = ("case", x, ws, gout, out, gx, gws)
    if plain_rounds:
        errs = chip_smoke.check_subsample_relu_rounding(S, *args)
        assert errs["gx"] == 0 and set(errs) == {"gx", *S.WEIGHT_NAMES}
    else:
        with pytest.raises(AssertionError, match="differ"):
            chip_smoke.check_subsample_relu_rounding(S, *args)


def test_relu_gx_bars_hold_the_norm_and_the_share_beyond_tolerance(monkeypatch):
    """A kink flip (one of 64000 gx elements off by a fifth of gx's max)
    passes; gx off everywhere by 2 % fails the L2 bar."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    g = torch.Generator().manual_seed(2)
    C = 16
    x = torch.randn(1, 2000, 32, generator=g).bfloat16()
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = [torch.randn(shapes.get(n, (C,)), generator=g) * 0.3 for n in S.WEIGHT_NAMES]
    gout = torch.randn(1, S.ceil_chain(2000)[2], 4, C, generator=g).bfloat16()
    out = S.fused_subsample_reference(x, *ws, act_name="relu")
    gx, gws = S.fused_subsample_reference_bwd(x, ws, gout, "relu", True)
    flipped = gx.clone().reshape(-1)
    flipped[7] += 0.2 * gx.abs().max()
    chip_smoke.check_subsample_relu_rounding(S, "case", x, ws, gout, out,
                                             flipped.reshape(gx.shape), gws)
    with pytest.raises(AssertionError, match="relative L2"):
        chip_smoke.check_subsample_relu_rounding(S, "case", x, ws, gout, out,
                                                 (gx.float() * 1.02).bfloat16(), gws)


# ---------------------------------------------------------------------------
# phases 19 and 20: the utterance path and wav2vec2-base
# ---------------------------------------------------------------------------


def test_phases_19_and_20_are_listed_and_driven():
    doc = chip_smoke.__doc__
    assert "\n19. the utterance path" in doc and "\n20. wav2vec2-base" in doc
    import inspect

    main = inspect.getsource(chip_smoke.main)
    assert "utterance_path(card, A, S, D)" in main and "wav2vec2_path(card, A, S, D)" in main
    for key in ("utterance_launches", "utterance_softdtw_launches", "wav2vec2_launches"):
        assert f'"{key}": {key}[name][i]' in main


def test_utterance_plans_per_utterance_at_the_flagship():
    """Phase 19: 60 utterances of 512 frames, each one batch-2 forward and
    backward (6 / 6 attention, 1 / 1 subsampling, no gx), no final pass; with
    the soft-DTW weight one R and one E each as well."""
    n = chip_smoke.N_FRAMES // chip_smoke.UTT_SEGMENT
    assert n == 60
    layers = chip_smoke.flagship_config().n_layers
    plan = chip_smoke.utterance_plan(layers)
    assert plan == {"attention": (6, 6), "subsample": (1, 1), "softdtw": (0, 0), "gx": 0}
    assert chip_smoke.utterance_plan(layers, soft_dtw=True)["softdtw"] == (1, 1)
    good = {"attention": (6 * n, 6 * n), "subsample": (n, n), "softdtw": (0, 0)}
    chip_smoke.check_path_launches("utterance", good, _routes(good), 0, plan, windows=n)
    final_pass = dict(good, attention=(12 * n, 6 * n), subsample=(2 * n, n))
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_path_launches("utterance", final_pass, _routes(final_pass), 0, plan,
                                       windows=n)
    sdtw_plan = chip_smoke.utterance_plan(layers, soft_dtw=True)
    m = sum(c for _, c in chip_smoke.UTT_SDTW)
    with_sdtw = {"attention": (6 * m, 6 * m), "subsample": (m, m), "softdtw": (m, m)}
    chip_smoke.check_path_launches("soft-DTW", with_sdtw, _routes(with_sdtw), 0, sdtw_plan,
                                   windows=m)
    for missing in ((m - 1, m), (m, 0)):
        bad = dict(with_sdtw, softdtw=missing)
        with pytest.raises(AssertionError, match="softdtw"):
            chip_smoke.check_path_launches("soft-DTW", bad, _routes(bad), 0, sdtw_plan, windows=m)


def test_wav2vec2_plan_runs_no_kernel_of_the_repository():
    plan = chip_smoke.W2V_PLAN
    zero = {"attention": (0, 0), "subsample": (0, 0), "softdtw": (0, 0)}
    chip_smoke.check_path_launches("wav2vec2", zero, _routes(zero), 0, plan, windows=30)
    flash = dict(zero, attention=(1, 0))
    with pytest.raises(AssertionError, match="attention"):
        chip_smoke.check_path_launches("wav2vec2", flash, _routes(flash), 0, plan, windows=30)


def test_phase_20_recording_is_a_minute_in_thirty_windows():
    from dynamic_asr_eval_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    rec = chip_smoke.long_wave_record(chip_smoke.W2V_SAMPLES)
    assert rec["wave"].shape == (960000,) and rec["wave"].dtype.name == "float32"
    assert chip_smoke.stitched_frames(Wav2Vec2Config(), chip_smoke.W2V_SAMPLES) == 2999
    chip_smoke.check_wav2vec2_config(Wav2Vec2Config())
    with pytest.raises(AssertionError, match="wav2vec2-base"):
        chip_smoke.check_wav2vec2_config(Wav2Vec2Config(hidden=64, n_layers=2))


def test_cut_utterances_follows_the_plan_and_refuses_a_short_recording():
    import numpy as np

    rec = np.arange(2 * 100).reshape(2, 100)
    utts = chip_smoke.cut_utterances(rec, ((10, 3), (40, 1)))
    assert [u["spectrogram"].shape for u in utts] == [(2, 10)] * 3 + [(2, 40)]
    assert utts[3]["spectrogram"][0, 0] == 30
    with pytest.raises(AssertionError, match="needs"):
        chip_smoke.cut_utterances(rec, ((60, 2),))


def test_check_engine_softdtw_holds_value_and_gradient(monkeypatch):
    """Phase 19b's check of the engine's D: both kernels against the plain
    version as phase 3 holds them, and ``soft_dtw`` giving their R and E
    bit for bit; a wrong E or a wrapper off by 1e-3 fails."""
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    Dmat = torch.rand(1, 12, 9, generator=torch.Generator().manual_seed(0)) * 2
    out = chip_smoke.check_engine_softdtw(D, Dmat)
    assert out["R_rel"] == 0.0 and out["E"] == 0.0 and out["E_max"] > 0
    assert out["shape"] == [1, 12, 9] and len(out["value"]) == 1
    real_sdtw, real_E = D.soft_dtw, D.softdtw_E
    monkeypatch.setattr(D, "soft_dtw", lambda x, g, b, p: real_sdtw(x, g, b, p) * 1.001)
    with pytest.raises(AssertionError, match="not the kernels' R and E"):
        chip_smoke.check_engine_softdtw(D, Dmat)
    monkeypatch.setattr(D, "soft_dtw", real_sdtw)
    monkeypatch.setattr(D, "softdtw_E", lambda *a: real_E(*a) * 1.001)
    with pytest.raises(AssertionError, match="E err"):
        chip_smoke.check_engine_softdtw(D, Dmat)


def test_fixed_perturbation_makes_the_engines_D_asymmetric():
    """Phase 19b's ``augment_fn``: the same perturbation for the same width,
    and with it the augmented-against-clean D is asymmetric where the clean
    copy against itself is not."""
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D

    batch = torch.randn(1, 8, 64, generator=torch.Generator().manual_seed(0))
    aug = chip_smoke.fixed_perturbation(batch, None, 64)
    assert torch.equal(aug, chip_smoke.fixed_perturbation(batch, None, 64))
    assert not torch.equal(aug, batch)
    p_clean, p_aug = batch.softmax(1).transpose(1, 2), aug.softmax(1).transpose(1, 2)
    assert chip_smoke.asymmetry(D.pairwise_sq_dist(p_clean, p_clean)) <= 1e-6
    assert chip_smoke.asymmetry(D.pairwise_sq_dist(p_aug, p_clean)) > chip_smoke.ASYMMETRY_MIN


def test_utterance_checks_hold_the_driver_run(monkeypatch):
    """Phase 19a's machinery on the CPU at a tiny size: the driver's run
    passes ``check_utterance_run``; a non-finite output, a missing utterance
    or unmoved weights fail."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.evals import run_utterance_eval as driver

    cfg = _tiny_protocol(monkeypatch, driver)
    wer, _, launches, _, detail, recorder = chip_smoke.main_path(
        cfg, {"attention": A}, driver, ("--segment_frames", "256"), frames=1024)
    assert launches == {"attention": (0, 0)}  # nothing counts on the CPU

    def out_len(T):
        return -(-T // 8)

    def check():
        return chip_smoke.check_utterance_run("u", wer, detail, recorder, [256] * 4, out_len,
                                              cfg.n_classes)
    assert check() > 0
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_utterance_run("u", wer, detail, recorder, [256] * 5, out_len,
                                       cfg.n_classes)
    outs, adapted, elapsed = recorder.outputs[0]
    outs[1] = np.full_like(outs[1], np.nan)
    with pytest.raises(AssertionError, match="finite False"):
        check()
    outs[1] = np.zeros_like(outs[1])
    recorder.outputs[0] = (outs, recorder.calls[0][0], elapsed)
    with pytest.raises(AssertionError, match="did not move"):
        check()


@pytest.mark.parametrize("name,hit", [
    ("(anonymous namespace)::fwd_kernel(float const*, float*, int, int, float)", True),
    ("(anonymous namespace)::bwd_kernel(float const*, float const*, float*, int, int, int, float)",
     True),
    ("void (anonymous namespace)::dw_bwd_kernel<true>((anonymous namespace)::DwBwdArgs)", False),
    ("void at::native::vectorized_elementwise_kernel<4, fwd_kernel>", False),
])
def test_softdtw_kernel_names_are_told_apart(name, hit):
    assert bool(chip_smoke.SOFTDTW_KERNEL.search(name)) == hit


def test_softdtw_kernels_are_the_named_globals():
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D

    src = D.SOURCE.read_text()
    assert "namespace {" in src
    assert " fwd_kernel(" in src and " bwd_kernel(" in src


# phases 21-21c: the encoder-decoder path

def _tiny_encdec():
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig
    from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig, init_encdec

    cfg = EncDecConfig(encoder=ConformerConfig(feat_in=16, n_layers=2, d_model=32, n_heads=2,
                                               head_dim=16, vocab_size=29, subsampling_factor=4,
                                               subsampling_conv_channels=8, conv_kernel_size=5,
                                               compute_dtype="float32"),
                       decoder_layers=1, decoder_d_model=32, decoder_heads=2, max_text_len=16)
    return cfg, init_encdec(cfg, seed=1)


class _IdTokenizer:
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("mode,filtered", [("teacher_ce", False), ("grpo", False),
                                           ("grpo", True)])
def test_branch_log_reads_each_branch_of_an_engine_run(mode, filtered):
    """The branches of a CPU run of the engine: a teacher and a final decode
    per chunk, the filters' teacher-forced pass and agreement decode, the
    rollouts and the updates with their batches; the plan's launches follow
    from them; the wrapped functions are restored after the run."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.tta import encdec_rl as R
    from dynamic_asr_eval_tpu_torch.tta.filters import TeacherFilterConfig

    cfg, model = _tiny_encdec()
    filters = TeacherFilterConfig(low_confidence_enabled=True, min_mean_max_prob=0.0,
                                  max_mean_entropy=99.0,
                                  decode_agreement_enabled=True,
                                  decode_agreement_min_similarity=0.0) if filtered else None
    engine = R.EncDecDynamicEvalEngine(model, cfg, TTAConfig(optim_args={"lr": 1e-3}),
                                       filter_config=filters, training_mode=mode,
                                       max_generate=4, reward_skip_threshold=2.0, device="cpu")
    saved = (R.generate_encdec, R.EncDecDynamicEvalEngine._policy_loss)
    spec = np.random.default_rng(0).standard_normal((16, 96)).astype(np.float32)
    with chip_smoke.BranchLog() as branches:
        engine(None, spec, 48, _IdTokenizer())
    assert (R.generate_encdec, R.EncDecDynamicEvalEngine._policy_loss) == saved
    chunks, rollouts = 2, branches.rollouts()
    assert sum(1 for s, e in branches.generates if s == 1 and e) == 2 * chunks
    assert sum(1 for _, e in branches.generates if not e) == (chunks if filtered else 0)
    assert branches.teacher_forced == (chunks if filtered else 0)
    assert rollouts == (chunks if mode == "grpo" else 0)
    assert branches.updates == [4 if mode == "grpo" else 1] * len(branches.updates)
    assert 0 < len(branches.updates) <= chunks
    n_fwd = branches.encodes + branches.teacher_forced + len(branches.updates)
    assert branches.plan(6) == {"attention": (6 * n_fwd, 6 * len(branches.updates)),
                                "subsample": (n_fwd, len(branches.updates)),
                                "softdtw": (0, 0), "gx": 0}


class _EncDecRecorder:
    def __init__(self, mode, params, adapted):
        self.engine = type("E", (), {"training_mode": mode, "num_rollouts": 4})()
        self.calls, self.outputs = [(params, None)], [("words here", adapted, 1.0)]


def _branches(generates, teacher_forced=0, updates=()):
    b = chip_smoke.BranchLog()
    b.generates, b.teacher_forced, b.updates = list(generates), teacher_forced, list(updates)
    return b


def test_check_encdec_run_holds_branches_weights_and_pos_enc():
    n = chip_smoke.ENCDEC_CHUNKS
    params = {"pos_enc.weight": torch.zeros(3), "head.weight": torch.zeros(2)}
    moved = dict(params, **{"head.weight": torch.ones(2)})
    grpo = [(1, True), (4, True)] * n + [(1, True)] * n
    detail = {"model_output": ["words here"]}

    def check(mode, branches, adapted, filtered=False, wer=1.0, out=detail):
        return chip_smoke.check_encdec_run("case", None, wer, out,
                                           _EncDecRecorder(mode, params, adapted), branches,
                                           filtered)

    assert check("grpo", _branches(grpo, updates=[4] * n), moved) == 1.0
    assert check("teacher_ce", _branches([(1, True)] * 2 * n, updates=[1] * 3), moved) == 1.0
    filtered = [(1, True), (1, False)] * n + [(1, True)] * n
    assert check("grpo", _branches(filtered, teacher_forced=n), params, filtered=True) == 0.0
    with pytest.raises(AssertionError, match="updates at batches"):  # an update at batch 1
        check("grpo", _branches(grpo, updates=[1]), moved)
    with pytest.raises(AssertionError, match="updates at batches"):  # a teacher decode missing
        check("teacher_ce", _branches([(1, True)] * (2 * n - 1), updates=[1]), moved)
    with pytest.raises(AssertionError, match="2 updates"):  # updates that moved nothing
        check("teacher_ce", _branches([(1, True)] * 2 * n, updates=[1, 1]), params)
    with pytest.raises(AssertionError, match="pos_enc moved"):
        check("grpo", _branches(grpo, updates=[4]), dict(moved, **{"pos_enc.weight":
                                                                   torch.ones(3)}))
    with pytest.raises(AssertionError, match="non-finite"):
        check("grpo", _branches(grpo, updates=[4]), dict(moved, **{"head.weight":
                                                                   torch.full((2,), float("nan"))}))
    with pytest.raises(AssertionError, match="transcript"):
        check("grpo", _branches(grpo, updates=[4]), moved, out={"model_output": [" "]})


def test_encdec_config_is_the_flagship_encoder_and_the_default_decoder():
    cfg = chip_smoke.encdec_config()
    assert cfg.encoder == chip_smoke.flagship_config(subsampling_impl="pallas")
    assert (cfg.decoder_layers, cfg.decoder_d_model, cfg.decoder_heads, cfg.head_dim,
            cfg.decoder_ff_mult, cfg.max_text_len) == (4, 512, 8, 64, 4, 256)
    assert chip_smoke.ENCDEC_CHUNKS == 8 and chip_smoke.ENCDEC_SEQ // 8 == 256


def test_phases_22_and_23_are_listed_and_driven():
    doc = chip_smoke.__doc__
    for heading in ("\n22. NST finetuning", "\n22b. one NST step", "\n23. word-level LM fusion"):
        assert heading in doc
    assert "[4, 2048, 6, 128] with lengths [2048, 1100, 0, 0]" in " ".join(doc.split())
    import inspect

    main = inspect.getsource(chip_smoke.main)
    for call in ("train_path(tmp, card, A, S, D)", "check_train_parity(A, S)",
                 "word_fusion_path(tmp, card)", "[2048, 1100, 0, 0], [1024, 0, 0, 0]"):
        assert call in main
    assert '"trainer_launches": trainer_launches[name][i]' in main
    assert '"train_parity_launches": train_parity[name][i]' in main


def test_train_plan_at_the_flagship():
    """Two recordings of 4.5 windows: 2 steps each, the second with one
    8192-frame window and three zero-length rows; per step the teacher's and
    the student's forward and the student's backward."""
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_spectrogram

    assert chip_smoke.train_steps() == 2
    spec = torch.zeros(1, chip_smoke.TRAIN_FRAMES).numpy()
    _, lengths, _, n_real = chunk_spectrogram(spec, chip_smoke.TRAIN_SEQ, 0, pad_to_bucket=False)
    assert n_real == 5 and lengths.tolist() == [16384] * 4 + [8192]
    L = chip_smoke.flagship_config().n_layers
    assert chip_smoke.TRAIN_PLAN == {"attention": (2 * L, L), "subsample": (2, 1),
                                     "softdtw": (0, 0), "gx": 0}


def test_write_wav_featurizes_to_the_frames(tmp_path):
    from dynamic_asr_eval_tpu_torch.audio.features import log_mel_spectrogram
    from dynamic_asr_eval_tpu_torch.audio.io import load_audio

    path = chip_smoke.write_wav(str(tmp_path / "a.wav"), 301, seed=1)
    assert log_mel_spectrogram(load_audio(path)).shape == (1, 80, 301)


def test_train_yaml_gives_the_flagship_without_pyyaml(tmp_path, monkeypatch):
    import dataclasses
    import sys

    from dynamic_asr_eval_tpu_torch.config import load_yaml
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig

    path = chip_smoke.train_yaml(str(tmp_path / "t.yaml"), str(tmp_path / "ck"))
    monkeypatch.setitem(sys.modules, "yaml", None)
    raw = load_yaml(path)
    fields = {f.name for f in dataclasses.fields(ConformerConfig)}
    cfg = ConformerConfig.from_dict({k: v for k, v in raw["model"].items() if k in fields})
    assert cfg == chip_smoke.flagship_config(subsampling_impl="pallas")
    assert raw["audio_chunking"] == {"size": 16384, "overlap": 0}
    assert raw["training"]["batch_size"] == 4 and raw["spec_augment"]["n_freq_masks"] == 6


def test_check_ema_between_holds_the_projection():
    g = torch.Generator().manual_seed(0)
    init = {"a": torch.randn(5, generator=g), "b": torch.randn(3, generator=g)}
    trained = {k: v + torch.randn(v.shape, generator=g) for k, v in init.items()}
    ema = {k: 0.7 * init[k] + 0.3 * trained[k] for k in init}
    proj, ratio = chip_smoke.check_ema_between(init, trained, ema)
    assert proj == pytest.approx(0.3, abs=1e-5) and ratio == pytest.approx(0.3, abs=1e-5)
    for bad in (init, trained, {k: 2 * trained[k] - init[k] for k in init}):
        with pytest.raises(AssertionError, match="EMA not between"):
            chip_smoke.check_ema_between(init, trained, bad)


def _tiny_phase(monkeypatch):
    """Phase 22 / 22b at a tiny width and length on the CPU: nothing counts
    and the profiler sees no device there."""
    big = chip_smoke.flagship_config
    monkeypatch.setattr(chip_smoke, "flagship_config", lambda **o: big(**{**dict(
        n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=40,
        subsampling_conv_channels=16, conv_kernel_size=5), **o}))
    monkeypatch.setattr(chip_smoke, "TRAIN_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN_FRAMES", 1152)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 256)
    monkeypatch.setattr(chip_smoke, "TRAIN_PARITY_LENGTHS", (256, 128, 0, 0))
    monkeypatch.setattr(chip_smoke, "TRAIN_PROFILED_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "kernel_ms", lambda fn, cpu=True: (fn(), {})[1])
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)


def test_train_path_rehearsed_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The whole of phase 22 (cli.main on two wavs, losses, EMA, checkpoint,
    resume bit for bit, timing) at a tiny width; the launch check sees the
    CPU's zero counts and is stood in for."""
    _tiny_phase(monkeypatch)
    seen = []
    monkeypatch.setattr(chip_smoke, "check_path_launches",
                        lambda what, launches, routes, gx, plan, windows: seen.append(
                            (what, plan, windows)))
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D

    launches, _ = chip_smoke.train_path(str(tmp_path), "card", A, S, D)
    assert seen == [("trainer", chip_smoke.TRAIN_PLAN, 4)]
    line = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"train_path"')][0]["train_path"]
    assert line["steps"] == 4 and len(line["losses"]) == 4
    assert 0 < line["ema_projection"] < 1 and line["timing"]["idle_share"] == "not measured"


def test_train_parity_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 22b's comparison at a tiny width: the kernel and the plain
    configurations agree on the CPU within its bars, given the f32 route's
    counts (nothing counts here); with the CPU's zero counts it fails."""
    _tiny_phase(monkeypatch)
    with pytest.raises(AssertionError, match=r"launches \{'attention': \(0, 0\)"):
        chip_smoke.check_train_parity(A, S)
    f32 = {"attention": (4, 2), "subsample": (2, 1)}
    monkeypatch.setattr(chip_smoke, "counted", lambda modules, fn: (
        fn(), f32, {k: {"tf32x3": v, "tensor_core": (0, 0)} for k, v in f32.items()}))
    assert chip_smoke.check_train_parity(A, S) == f32
    assert "weight gradients" in capsys.readouterr().out


def test_word_fusion_path_rehearsed_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 23 at a small lexicon and text, its "card" side on the CPU."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "TRAIN_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "WORD_COUNTS", (400, 800, 800, 800))
    monkeypatch.setattr(chip_smoke, "WORD_TEXT_WORDS", 6)
    monkeypatch.setattr(chip_smoke, "WORD_BEAMS", 8)
    chip_smoke.word_fusion_path(str(tmp_path), "card")
    line = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"word_fusion"')][0]["word_fusion"]
    assert line["max_rel_score_diff"] == 0.0 and line["words_spelled"] == 6
    assert line["lexicon_words_out_of_lexicon"] == 0


def test_records_plan_at_the_flagship():
    """Phase 24's group: 9, 9, 5 and 1 windows, the engine's own plan; a
    group step launches the attention once a layer for all 4 records and
    the subsampling once a record."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

    L = chip_smoke.flagship_config().n_layers
    steps, plan = chip_smoke.records_plan(chip_smoke.RECORDS_FRAMES, L)
    assert steps == 9 and plan == {"attention": (9 * L, 9 * L), "subsample": (36, 36)}
    cfg = chip_smoke.flagship_config(n_layers=1, d_model=64, n_heads=2, head_dim=32,
                                     subsampling_conv_channels=8)
    engine = DynamicEvalEngine(init_conformer(cfg), cfg.blank_id, 8,
                               TTAConfig(seq_len=chip_smoke.SEQ, overlap=chip_smoke.OVERLAP),
                               device="cpu")
    specs = [np.zeros((80, n), np.float32) for n in chip_smoke.RECORDS_FRAMES]
    _, W, _, n_reals, _, _, _ = engine._records_plan(specs, -1, -1)
    assert W == chip_smoke.SEQ and n_reals == [9, 9, 5, 1]
    assert chip_smoke.records_plan(chip_smoke.RECORDS_PARITY_FRAMES, L)[1] == {
        "attention": (L, L), "subsample": (2, 2)}


def test_main_drives_phases_24_to_24d():
    import inspect

    main = inspect.getsource(chip_smoke.main)
    for call in ("check_vmap(A, S)", "records_path(card, A, S)", "check_records_parity(A, S)",
                 "records_driver_path(card, A, S)", "remat_path(card, A, S)"):
        assert call in main
    for key in ('"records_launches"', '"remat_launches"', '"vmap_launches"',
                "records_parity_launches=", "records_driver_launches="):
        assert key in main


def test_vmap_cases_rehearsed_on_the_cpu(monkeypatch):
    """Phase 3's vmap cases at a tiny shape: bit for bit against the loop;
    the launch check sees the CPU's zero counts and fails, and passes with
    the card's counts stood in."""
    monkeypatch.setattr(chip_smoke, "RECORDS_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "VMAP_ATTENTION", (2, 40, 2, 16))
    monkeypatch.setattr(chip_smoke, "VMAP_LENGTHS", ((40, 31), (9, 40), (1, 40)))
    monkeypatch.setattr(chip_smoke, "VMAP_SUBSAMPLE", (2, 64, 16, 8))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(AssertionError, match="attention under vmap: launches"):
        chip_smoke.check_vmap(A, S)
    R = chip_smoke.VMAP_R
    card = {"attention": (1, 1), "subsample": (R, R)}
    monkeypatch.setattr(chip_smoke, "counted", lambda modules, fn: (
        fn(), {k: card[k] for k in modules},
        {k: {"tensor_core": card[k], "tf32x3": (0, 0)} for k in modules}))
    assert chip_smoke.check_vmap(A, S) == card


def test_engine_recorder_keeps_the_records_batched_calls():
    class Engine:
        mesh, config = "mesh", "config"

        def batched(self, params, specs, *args, return_params=False, **kwargs):
            return [(s, return_params) for s in specs]

    recorder = chip_smoke.EngineRecorder()
    recorder.wrap(lambda: Engine())()
    assert recorder.batched("p", ["a", "b"], 1, rngs=[0, 1]) == [("a", True), ("b", True)]
    assert recorder.calls == [("p", "a"), ("p", "b")] and recorder.mesh == "mesh"


def test_main_drives_phase_25():
    import inspect

    main = inspect.getsource(chip_smoke.main)
    for call in ("check_query_block(A, dtype)", "parallel_path(card)"):
        assert call in main
    for key in ('"tp_launches"', '"sp_launches"', "query_block_ms=", "query_block_full_ms="):
        assert key in main
    assert "PARALLEL_RANK" in inspect.getsource(chip_smoke)


def test_phase_25_shapes():
    """25a's recording is 3 windows; 25b's longest row downsamples to 1024
    frames a rank on 2 ranks; 25c's blocks are two of 1024 rows."""
    assert chip_smoke.n_windows(chip_smoke.TP_FRAMES) == 3
    assert max(chip_smoke.SP_LENGTHS) // 8 // 2 == 1024
    assert chip_smoke.QB_SHAPE[1] // 2 == 1024


def _rank_result(rank, heads=3, blocks=None, tp_diff=5e-6, tp_grad=1e-5, sp_grad=1e-5):
    def launches(att, sub, route):
        other = "tf32x3" if route == "tensor_core" else "tensor_core"
        return {"launches": {"attention": att, "subsample": sub},
                "routes": {"attention": {route: att, other: [0, 0]},
                           "subsample": {route: sub, other: [0, 0]}}}

    tp = {"bf16": {**launches([18, 18], [3, 3], "tensor_core"), "layers": 6, "windows": 3},
          "f32": {**launches([6, 6], [3, 3], "tf32x3"), "layers": 2, "windows": 3}}
    for run in tp.values():
        run.update(heads=[heads], wall_s=1.0, max_abs_log_prob_diff=1e-3, scale=14.0,
                   same_argmax_share=1.0, greedy_equal=True)
    tp["f32"].update(repeat_max_abs_log_prob_diff=3e-4, held={
        "infer_max_abs_log_prob_diff": tp_diff, "infer_scale": 14.0, "infer_greedy_equal": True,
        "infer_same_argmax_share": 1.0, "step_max_abs_log_prob_diff": 5e-6, "step_scale": 14.0,
        "max_grad_diff": tp_grad, "grad_scale": 1.2})
    sp = {"bf16": launches([6, 12], [1, 2], "tensor_core"),
          "f32": launches([2, 4], [1, 2], "tf32x3")}
    for name, run in sp.items():
        layers = 6 if name == "bf16" else 2
        run.update(query_blocks=blocks or [[6, 1024, 2048, 1024 * rank]],
                   query_block_launches=layers, same_argmax_share=1.0,
                   max_abs_log_prob_diff=1e-6, scale=13.0, max_grad_diff=sp_grad,
                   grad_scale=1.2, ctc_max_grad_diff=1e-3, ctc_grad_scale=1.3, loss=6.4,
                   unsharded_loss=6.4, peak_gb=2.0, unsharded_peak_gb=2.5)
    return {"rank": rank, "tp": tp, "sp": sp}


@pytest.mark.parametrize("fault", [None, "heads", "blocks", "tp_diff", "tp_grad", "sp_grad"])
def test_parallel_path_holds_each_ranks_results(monkeypatch, capsys, fault):
    """Phase 25's parent side on the ranks' JSON (written by a stand-in for
    ``torch.distributed.run``): it passes the card's expected results
    (the adapted f32 run's tp difference and repeat spread only printed)
    and refuses a tp launch of other heads, a sequence block other than
    this rank's, an unadapted tp log-prob difference past 1e-4 of max, and
    tp or sp gradients past 1e-4 of max."""
    import os
    import subprocess

    kwargs = {"heads": {"heads": 6}, "blocks": {"blocks": [[6, 1024, 2048, 0]]},
              "tp_diff": {"tp_diff": 1.5e-3}, "tp_grad": {"tp_grad": 2e-4},
              "sp_grad": {"sp_grad": 2e-4}}.get(fault, {})

    def run(cmd, env, **_):
        for r in range(2):
            with open(os.path.join(env[chip_smoke.PARALLEL_RANK], f"rank{r}.json"), "w") as f:
                json.dump(_rank_result(r, **kwargs), f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", run)
    if fault is None:
        out = chip_smoke.parallel_path("card")
        assert out["tp"]["bf16"]["launches"]["attention"] == [18, 18]
        assert '{"parallel": ' in capsys.readouterr().out
    else:
        with pytest.raises(AssertionError, match="phase 25"):
            chip_smoke.parallel_path("card")
