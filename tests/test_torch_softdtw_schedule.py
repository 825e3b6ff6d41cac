"""The soft-DTW kernels' parts that the CPU can check.

1. The plain versions of the backward's two stages, as the E kernel splits
   them (the weights from D and R alone, then the E recursion):
   ``backward_weights_reference`` and ``backward_E_from_weights``.  Their
   composition is held against JAX's ``_backward_E`` on the shapes and γ of
   tests/test_torch_softdtw.py wherever JAX is finite, within 1e-5 of max |E|
   at γ 0.5 and 1 and 5e-5 at γ 0.01 (``JAX_BAR``), against the same
   recursion in float64 within 1e-6 (with a band too, where the path's end
   lies inside it), and against the per-anti-diagonal backward that the port
   ran before the split, bit for bit.  The weights alone are held against
   float64 numpy, within the rounding of their exponent.
2. A model of the kernels' schedule (``csrc/softdtw.cu``), parameterised by
   the constants the source declares (strip height 32, warps per block,
   panel width, the staging ring's columns and look-ahead, 32-column blocks)
   and by the lag a strip keeps behind the strip above (32: lane 0 at step t
   waits for the slot lane 31 above writes at its step t + 31).  It runs the
   warps tick by tick and checks that every cell is computed exactly once and
   after its three neighbours, that lane 0 reads from the boundary ring the
   cell it needs, and that the staging ring never overwrites a block in use,
   over N, M in {1, 7, 31, 32, 33, 64, 100, 300}, in both directions, with
   the kernel's panel and with a panel of 64 columns (so that several panels
   run), with the warps in lockstep and drifting apart.  Mutated models (a
   lag one step short, a boundary ring or a staging ring one block too
   small) fail the check.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.kernels import softdtw as J
from dynamic_asr_eval_tpu_torch.kernels import softdtw as S

torch.set_num_threads(1)

SOURCE = Path(S.__file__).resolve().parent / "csrc" / "softdtw.cu"


def _D(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 2, size=(2,) + shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the backward's stages
# ---------------------------------------------------------------------------


def _backward_E_per_diagonal(D, R, gamma):
    """The port's plain backward before it was split into two stages: each
    anti-diagonal's weights and E in one vectorised update."""
    B, N, M = D.shape
    D_ = torch.zeros((B, N + 2, M + 2), dtype=D.dtype)
    D_[:, 1:N + 1, 1:M + 1] = D
    R_ = R.clone()
    R_[:, :, M + 1] = -S.INF
    R_[:, N + 1, :] = -S.INF
    R_[:, N + 1, M + 1] = R[:, N, M]
    E = torch.zeros((B, N + 2, M + 2), dtype=D.dtype)
    E[:, N + 1, M + 1] = 1.0

    def weight(di, dj, r, i, j):
        return torch.exp(torch.clamp((R_[:, i + di, j + dj] - r - D_[:, i + di, j + dj]) / gamma,
                                     max=0.0))

    for k in range(N + M - 2, -1, -1):
        i = S._diagonal(k, N, M, D.device) + 1
        j = k - i + 2
        r = R_[:, i, j]
        E[:, i, j] = (E[:, i + 1, j] * weight(1, 0, r, i, j) + E[:, i, j + 1] * weight(0, 1, r, i, j)
                      + E[:, i + 1, j + 1] * weight(1, 1, r, i, j))
    return E[:, 1:N + 1, 1:M + 1]


# of max |E|.  At γ 0.01 JAX's own f32 backward is 1.2e-5 to 3.7e-5 of max
# |E| from the float64 recursion (its exponents' rounding, amplified by 1/γ),
# where the port's is within 7e-8: the bar there is JAX's distance, rounded up.
JAX_BAR = {0.01: 5e-5, 0.5: 1e-5, 1.0: 1e-5}


@pytest.mark.parametrize("bandwidth", [0, 1])
@pytest.mark.parametrize("gamma", [0.01, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(4, 4), (5, 8), (8, 5)])
def test_backward_stages_match_jax(shape, gamma, bandwidth):
    D = _D(shape, seed=3)
    mask = J._band_mask(*shape, bandwidth)
    if mask is not None:
        D = np.where(mask[None], np.float32(J.INF), D)
    R = np.asarray(jax.vmap(lambda d: J._forward_R(d, gamma))(jnp.asarray(D)))
    ref = np.asarray(jax.vmap(lambda d, r: J._backward_E(d, r, gamma))(jnp.asarray(D),
                                                                      jnp.asarray(R)))
    Dt, Rt = torch.from_numpy(D.copy()), torch.from_numpy(R.copy())
    W = S.backward_weights_reference(Dt, Rt, gamma)
    E = S.backward_E_from_weights(W).numpy()
    assert W.shape == (3, 2) + shape and np.isfinite(E).all()
    finite = np.isfinite(ref)
    assert finite.any() and (bandwidth > 0 or finite.all())
    np.testing.assert_allclose(E[finite], ref[finite], rtol=0,
                               atol=JAX_BAR[gamma] * np.abs(ref[finite]).max())
    if abs(shape[0] - shape[1]) <= bandwidth or bandwidth == 0:
        # the same recursion in float64 on the same f32 inputs.  Not where
        # the path's end lies outside the band: R[N, M] is INF-sized there,
        # and float64's exact differences of INF-sized f32 values give
        # weights that f32's rounded ones do not (E reaches 1e143)
        E64 = S.backward_E_from_weights(S.backward_weights_reference(Dt.double(), Rt.double(),
                                                                     gamma)).numpy()
        np.testing.assert_allclose(E, E64, rtol=0, atol=1e-6 * np.abs(E64).max())


@pytest.mark.parametrize("bandwidth", [0, 2])
@pytest.mark.parametrize("gamma", [0.01, 0.1, 1.0])
@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (6, 9), (17, 11), (40, 33)])
def test_backward_stages_compose_to_the_per_diagonal_backward_bit_for_bit(shape, gamma,
                                                                          bandwidth):
    D = S._apply_band(torch.from_numpy(_D(shape, seed=4)) * 3, bandwidth)
    R = S.forward_R_reference(D, gamma)
    want = _backward_E_per_diagonal(D, R, gamma)
    got = S.backward_E_from_weights(S.backward_weights_reference(D, R, gamma))
    assert torch.equal(got, want)
    assert torch.equal(S.backward_E_reference(D, R, gamma), want)


@pytest.mark.parametrize("gamma", [0.05, 1.0])
def test_backward_weights_match_float64(gamma):
    D = torch.from_numpy(_D((7, 10), seed=5))
    R = S.forward_R_reference(D, gamma)
    W = S.backward_weights_reference(D, R, gamma).numpy()
    d, r = D.double().numpy(), R.double().numpy()
    N, M = d.shape[1:]
    d_ = np.zeros((2, N + 2, M + 2))
    d_[:, 1:N + 1, 1:M + 1] = d
    r_ = r.copy()
    r_[:, :, M + 1] = -S.INF
    r_[:, N + 1, :] = -S.INF
    r_[:, N + 1, M + 1] = r[:, N, M]
    eps = np.finfo(np.float32).eps
    for n, (di, dj) in enumerate(((1, 0), (0, 1), (1, 1))):
        diff = r_[:, 1 + di:N + 1 + di, 1 + dj:M + 1 + dj] - r_[:, 1:N + 1, 1:M + 1]
        d_nb = d_[:, 1 + di:N + 1 + di, 1 + dj:M + 1 + dj]
        x = np.minimum((diff - d_nb) / gamma, 0.0)
        # f32 rounds the difference, the subtraction of D and the division
        # once each (the exponent's error, which exp makes relative), and
        # exp rounds its result
        x_err = eps * (np.abs(diff) + np.abs(diff - d_nb)) / gamma + eps * np.abs(x)
        bound = np.exp(x) * (np.expm1(np.minimum(x_err, 1.0)) + 2 * eps) + 1e-37
        assert (np.abs(W[n] - np.exp(x)) <= bound).all()
    assert ((W >= 0) & (W <= 1)).all()


# ---------------------------------------------------------------------------
# the kernels' schedule
# ---------------------------------------------------------------------------


def kernel_constants():
    """The schedule's constants as ``csrc/softdtw.cu`` declares them."""
    text = SOURCE.read_text()
    names = ("FWD_WARPS", "BWD_WARPS", "PANEL", "TILE", "AHEAD", "CHUNK", "EDGE")
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1)) for n in names}


STRIP = 32  # rows per strip: one per lane
BLOCK = 32  # columns per staged block (one group of 32 steps)
LAG = STRIP - 1  # lane 31 computes column t - 31 at step t, and publishes it so


def simulate(N, M, *, warps, panel, tile, ahead, chunk, lag=LAG, ring_slots=None,
             backward=False, pace=None, seed=0):
    """Run the kernels' schedule for one batch element; returns the faults
    found (an empty list when the schedule is sound).

    As in the kernels: a warp runs its strips one after the other, a step at a
    time, lane l on column t - l; at the start of a chunk of ``chunk`` steps
    it waits until the ring slots of the chunk's columns hold the strip above
    (checked by the strip's number, as the kernels do), and at its end lane 31
    publishes the columns it computed in it (``lag`` steps behind lane 0);
    staged blocks are loaded ``ahead`` groups early into a ring of ``tile``
    columns, and written out at the end of the group after their last cell.
    Each tick every warp that may move runs one step; with ``pace`` (one
    probability per warp) it runs it with that probability, so that warps
    drift apart as they may on the card.

    Cells are (i, j), 0-based in D; the backward's strips and columns run
    from the bottom right (its logical cell (i', j') is (N-1-i', M-1-j'))
    and each cell needs the cells below, to the right and below right."""
    faults = []
    S_ = -(-N // STRIP)
    NW = min(warps, S_)
    P = min(panel, M)
    Q = -(-M // P)
    edge = kernel_constants()["EDGE"]
    slots = ring_slots(P) if ring_slots else edge + P
    rings = [[None] * slots for _ in range(NW)]  # (virtual strip, column or "edge")
    tiles = [[None] * (tile // BLOCK) for _ in range(NW)]  # [strip, block, flushed]
    done = np.full((N, M), -1, dtype=np.int64)  # tick at which each cell was computed
    jobs = [[(q, s) for q in range(Q) for s in range(w, S_, NW)] for w in range(NW)]
    state = [None] * NW
    rng = np.random.default_rng(seed)

    def actual(il, jl):
        return (N - 1 - il, M - 1 - jl) if backward else (il, jl)

    def computed_before(il, jl, tick):
        return il < 0 or jl < 0 or 0 <= done[actual(il, jl)] < tick

    def load(w, v, b, nb):
        if b >= nb:
            return
        old = tiles[w][b % len(tiles[w])]
        if old is not None and not old[2]:
            faults.append(f"strip {v}: block {b} loaded over block {old[1]} of strip {old[0]}")
        tiles[w][b % len(tiles[w])] = [v, b, False]

    def flush(w, st, b):
        entry = tiles[w][b % len(tiles[w])]
        if entry is None or entry[:2] != [st["v"], b]:
            faults.append(f"strip {st['v']}: block {b} flushed from a slot holding {entry}")
            return
        for r in range(STRIP):
            il = STRIP * st["s"] + r
            for c in range(BLOCK * b, min(BLOCK * (b + 1), st["Pq"])):
                if il < N and done[actual(il, st["c0"] + c)] < 0:
                    faults.append(f"strip {st['v']}: cell {(il, st['c0'] + c)} flushed before "
                                  f"it was computed")
        entry[2] = True

    def ready(w, st, t):
        """The ring slots lane 0 needs for the chunk from step t, as the
        kernels check them: by the writing strip's number."""
        if st["v"] == 0:
            return True
        cols = ["edge"] if t < 0 else [c for c in range(t, t + chunk) if c < st["Pq"]]
        for c in cols:
            got = rings[w][0 if c == "edge" else (edge + c) % slots]
            if got is None or got[0] != st["v"] - 1:
                return False
            if st["s"] > 0 and got[1] != (c if c == "edge" else st["c0"] + c):
                faults.append(f"strip {st['v']}: lane 0 reads {got} for column {c}")
        return True

    tick = idle = 0
    while any(jobs[w] or state[w] for w in range(NW)) and len(faults) < 20:
        tick += 1
        moved = False
        writes = []
        for w in range(NW):
            if pace is not None and rng.random() >= pace[w % len(pace)]:
                continue
            if state[w] is None:
                if not jobs[w]:
                    continue
                q, s = jobs[w].pop(0)
                Pq = min(P, M - q * P)
                steps = Pq + STRIP - 1
                G = -(-steps // BLOCK)
                last = BLOCK * (G - 1) + -(-(steps - BLOCK * (G - 1)) // chunk) * chunk
                state[w] = dict(q=q, s=s, v=q * S_ + s, c0=q * P, Pq=Pq, nb=-(-Pq // BLOCK),
                                steps=steps, G=G, run=last, t=-1, flushed=0, pending=[])
            st = state[w]
            t, v = st["t"], st["v"]
            if t < 0:  # the strip's start: slot 0, then its own slot 0
                if not ready(w, st, -1):
                    continue
                succ = (st["s"] + 1) % NW if st["s"] + 1 < S_ else 0
                writes.append((succ, 0, (v, "edge")))
                for b in range(ahead):
                    load(w, v, b, st["nb"])
                st["t"] = 0
                moved = True
                continue
            if t % chunk == 0 and not ready(w, st, t):
                continue
            moved = True
            for lane in range(STRIP):
                il, jl = STRIP * st["s"] + lane, t - lane
                slot = tiles[w][(jl % tile) // BLOCK]
                if not 0 <= jl < st["Pq"]:
                    # an idle lane writes its garbage into its column of the
                    # staging ring: no cell of a block in use may be there
                    if slot is not None and not slot[2] and BLOCK * slot[1] + jl % BLOCK < st["Pq"]:
                        faults.append(f"strip {v} step {t}: idle lane {lane} writes over "
                                      f"block {slot[1]}")
                    continue
                if slot is None or slot[:2] != [v, jl // BLOCK] or slot[2]:
                    faults.append(f"strip {v} step {t}: lane {lane} finds {slot} in its tile slot")
                if il >= N:
                    continue
                j = st["c0"] + jl
                for di, dj in ((1, 0), (0, 1), (1, 1)):
                    if not computed_before(il - di, j - dj, tick):
                        faults.append(f"cell {actual(il, j)} before its neighbour "
                                      f"{actual(il - di, j - dj)}")
                if done[actual(il, j)] >= 0:
                    faults.append(f"cell {actual(il, j)} computed twice")
                done[actual(il, j)] = tick
            label, computed = t - lag, t - (STRIP - 1)
            if 0 <= label < st["Pq"] and computed < st["Pq"]:
                succ = (st["s"] + 1) % NW if st["s"] + 1 < S_ else 0
                st["pending"].append((succ, (edge + label) % slots, (v, st["c0"] + computed)))
            t += 1
            if t % chunk == 0:  # the chunk's end: lane 31 publishes
                writes += st["pending"]
                st["pending"] = []
            g = (t - 1) // BLOCK
            if t == min(BLOCK * (g + 1), st["run"]):  # the group's end: flush, then load
                upto = st["nb"] if t == st["run"] else g
                for b in range(st["flushed"], upto):
                    flush(w, st, b)
                st["flushed"] = max(st["flushed"], upto)
                load(w, v, g + ahead, st["nb"])
            st["t"] = t
            if t == st["run"]:
                state[w] = None
        for succ, k, val in writes:
            rings[succ][k] = val
        idle = 0 if moved else idle + 1
        if idle > 1000:
            faults.append("no warp can move: the schedule deadlocks")
            break
    missing = int((done < 0).sum())
    if missing:
        faults.append(f"{missing} cells never computed")
    return faults


SIZES = (1, 7, 31, 32, 33, 64, 100, 300)


def _cases():
    c = kernel_constants()
    for backward in (False, True):
        warps = c["BWD_WARPS"] if backward else c["FWD_WARPS"]
        for panel in (c["PANEL"], 64):
            yield pytest.param(warps, panel, backward,
                               id=f"{'bwd' if backward else 'fwd'}-panel{panel}")


# per-warp probabilities of moving in a tick: the upper strips fast and the
# lower slow (the rings fill), and the reverse
PACES = {"lockstep": None, "consumers slow": (1.0, 0.05), "producers slow": (0.05, 1.0)}


@pytest.mark.parametrize("pace", list(PACES))
@pytest.mark.parametrize("warps,panel,backward", list(_cases()))
def test_schedule_computes_every_cell_once_after_its_neighbours(warps, panel, backward, pace):
    c = kernel_constants()
    for N in SIZES:
        for M in SIZES:
            faults = simulate(N, M, warps=warps, panel=panel, tile=c["TILE"], ahead=c["AHEAD"],
                              chunk=c["CHUNK"], backward=backward, pace=PACES[pace])
            assert not faults, f"N={N} M={M}: {faults[:5]}"


def test_the_model_reads_the_kernels_constants():
    c = kernel_constants()
    assert c["TILE"] % BLOCK == 0 and c["AHEAD"] < c["TILE"] // BLOCK
    assert min(c["FWD_WARPS"], c["BWD_WARPS"]) >= 1 and c["PANEL"] >= BLOCK
    assert BLOCK % c["CHUNK"] == 0 and c["CHUNK"] % 2 == 0
    text = SOURCE.read_text()
    assert "const int col = t0 + k - 31;" in text  # lane 31 publishes its own column
    assert "return EDGE + P + (P & 1);" in text  # a ring holds a panel's row


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("mutation", ["lag one step short", "ring one block too small",
                                      "staging ring one block too small"])
def test_a_mutated_schedule_fails_the_check(mutation, backward):
    c = kernel_constants()
    kw = dict(warps=c["BWD_WARPS"] if backward else c["FWD_WARPS"], panel=c["PANEL"],
              tile=c["TILE"], ahead=c["AHEAD"], chunk=c["CHUNK"], backward=backward,
              pace=PACES["consumers slow"])
    assert not simulate(100, 300, **kw)
    if mutation == "lag one step short":
        kw["lag"] = LAG - 1
    elif mutation == "ring one block too small":
        kw["ring_slots"] = lambda P: c["EDGE"] + P - BLOCK
    else:
        kw["tile"] = c["TILE"] - BLOCK
    assert simulate(100, 300, **kw)
