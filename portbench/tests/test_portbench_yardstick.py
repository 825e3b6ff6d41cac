"""The frozen arithmetic against hand-worked cases: the 95th percentile, the
union of intervals, RTFx with a record in flight, the operation and byte
counts of the kernels' work, and the model's FLOP count."""

import json
import math

import pytest

from portbench import yardstick as Y
from portbench.tests import tiny
from portbench.tracing import Trace


def test_p95_is_the_nearest_rank():
    assert Y.p95(list(range(1, 101))) == 95
    assert Y.p95([5.0]) == 5.0
    assert Y.p95([3, 1, 2]) == 3  # ceil(2.85) = 3rd of 3
    assert Y.p95(list(range(20))) == 18  # ceil(19.0) = 19th


def test_union_counts_overlaps_once():
    assert Y.union_length([(0, 10), (5, 15), (20, 25)]) == 20
    assert Y.union_length([(0, 10), (2, 3), (3, 4)]) == 10
    assert Y.union_length([]) == 0


def test_rtfx_counts_the_record_in_flight():
    # three records of 6, 12 and 18 minutes; the window closed at 2.0 s while
    # the third ran, and it finished at 3.0 s: all of its audio counts, and
    # all of its time
    frames = [36000, 72000, 108000]
    assert Y.rtfx(frames, 3.0) == pytest.approx(2160 / 3.0)


def test_attention_work_counts_valid_pairs_only():
    flops, nbytes = Y.attention_work(2, 2048, 6, 128, [2048, 1600])["fwd"]
    pairs = (2048 ** 2 + 1600 ** 2) * 6
    assert flops == 4 * 128 * pairs
    assert nbytes == 4 * (2 * 2048 * 6 * 128 * 2) + 2 * 6 * 2048 * 4 + 2 * 2048 * 4
    bwd = Y.attention_work(2, 2048, 6, 128, [2048, 1600])["bwd"][0]
    assert bwd == 2.5 * flops
    # at the flagship's shape the forward is bound by its operations:
    # 25.8 GFLOP at 989 TFLOP/s
    full = Y.attention_work(2, 2048, 6, 128, [2048, 2048])["fwd"]
    assert Y.bound_s(*full) == pytest.approx(4 * 128 * 2 * 2048 ** 2 * 6 / 989e12)


def test_subsample_work_by_hand():
    # B 1, T 16, F 16, C 2: rows 8, 4, 2; stage 0 at 8 x 8 positions, the
    # depthwise and pointwise stages at 4 x 4 and 2 x 2
    flops, nbytes = Y.subsample_work(1, 16, 16, 2)["fwd"]
    stage0 = 2 * 9 * 64 * 2
    dw = 2 * 9 * (16 + 4) * 2
    pw = 2 * (16 + 4) * 2 * 2
    assert flops == stage0 + dw + pw
    assert nbytes == 16 * 16 * 2 + 4 * 2 * 2 + (32 * 2 + 2 * 4) * 4
    assert Y.subsample_work(1, 16, 16, 2)["bwd"][0] == 2 * stage0 + 3 * dw + 3 * pw


def test_forward_flops_by_hand():
    # one layer, d 4, vocab 3 + blank, C 2, F 8, T 8 -> T' 1, no
    # self-conditioning: subsampling, out projection, the block, the head
    m = {"d_model": 4, "vocab_size": 3, "n_layers": 1, "subsampling_conv_channels": 2,
         "expansion_factor": 4, "conv_kernel_size": 3, "subsampling_factor": 8, "feat_in": 8,
         "self_conditioning": False}
    sub = 2 * 9 * 4 * 4 * 2 + (2 * 9 * 2 * 2 * 2 + 2 * 2 * 2 * 2 * 2) \
        + (2 * 9 * 1 * 1 * 2 + 2 * 1 * 1 * 2 * 2) + 2 * 1 * 2 * 4
    ff = 2 * (2 * 4 * 16)
    attn = 2 * 4 * 12 + 2 * 2 * 4 + 2 * 16
    conv = 2 * 4 * 8 + 2 * 3 * 4 + 2 * 16
    head = 2 * 4 * 4
    assert Y.conformer_forward_flops(m, 8) == sub + 2 * ff + attn + conv + head
    rel = dict(m, position_encoding="rel_pos")
    assert Y.conformer_forward_flops(rel, 8, batch=2) == \
        2 * (sub + 2 * ff + attn + conv + head + 2 * 4) + 2 * 1 * 16


def test_window_flops_at_the_flagship():
    m = json.loads((tiny.ROOT / "portbench/configs/scconformer_xl.json").read_text())["model"]
    one = Y.conformer_forward_flops(m, 16384)
    assert Y.window_flops(m, 16384) == pytest.approx(4 * one)
    assert 2.2e12 < Y.window_flops(m, 16384) < 2.4e12


def test_trace_reads_launches_busy_time_and_gaps():
    ops = [("k1", 0, 10, 1), ("k2", 5, 20, 2), ("opt_a", 30, 40, 3), ("opt_b", 40, 45, 4),
           ("k3", 60, 70, 5)]
    runtime = {1: ("cudaLaunchKernel", 0, 1), 2: ("cudaLaunchKernel", 2, 3),
               3: ("cudaLaunchKernel", 26, 27), 4: ("cudaLaunchKernel", 27, 28),
               5: ("cudaStreamSynchronize", 50, 58)}
    spans = [("forward", 0, 4), ("optimizer", 25, 29), ("forward", 59, 61)]
    t = Trace(ops, runtime, spans)
    assert t.busy_ns() == 20 + 15 + 10
    assert t.ms_launched_in("optimizer") == pytest.approx(15 / 1e6)
    assert t.ms_launched_in("nothing") is None
    assert t.ms_where(lambda n: n.startswith("k")) == pytest.approx(35 / 1e6)
    # gap 20-30 (middle 25: inside the optimizer span), gap 45-60 (middle 52:
    # between the optimizer and the next forward, in a synchronisation)
    assert dict(t.idle_gaps()) == {
        "optimizer": pytest.approx(10 / 1e9),
        "stitch, next window (cudaStreamSynchronize)": pytest.approx(15 / 1e9)}
    assert t.phase(10) == "labels, CTC loss, backward"
    assert t.phase(100) == "driver: decode, word errors"
    assert math.isclose(t.top_ops(1)[0][1], 15 / 1e9)


def test_host_readings_over_an_interval():
    from portbench import host

    a = {"t": 10.0, "thread_cpu": 1.0, "process_cpu": 2.0, "nivcsw": 5, "nvcsw": 7,
         "ticks": [100, 0, 50, 1000, 0, 0, 0, 10]}
    b = {"t": 12.0, "thread_cpu": 2.5, "process_cpu": 5.0, "nivcsw": 9, "nvcsw": 17,
         "ticks": [100 + 300, 0, 50 + 100, 1000 + 1180, 0, 0, 0, 10 + 20]}
    out = host.between(a, b)
    hz = __import__("os").sysconf("SC_CLK_TCK")
    assert out["launcher_cpu_share"] == pytest.approx(0.75)
    assert out["process_cores"] == pytest.approx(1.5)
    assert out["launcher_involuntary_switches"] == 4 and out["launcher_voluntary_switches"] == 10
    assert out["steal_share"] == pytest.approx(20 / 1600)
    assert out["machine_busy_cores"] == pytest.approx(400 / hz / 2.0)
    assert out["other_busy_cores"] == pytest.approx(400 / hz / 2.0 - 1.5)
    # counters that do not advance give no machine readings
    assert "steal_share" not in host.between(a, dict(b, ticks=a["ticks"]))


def test_quiet_collector_restores_the_collector():
    import gc

    from portbench import host

    with host.quiet_collector():
        assert not gc.isenabled() and gc.get_freeze_count() > 0
    assert gc.isenabled() and gc.get_freeze_count() == 0
