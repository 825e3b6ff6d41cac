"""Driver: host milliseconds a record spends outside the engine's call
(the spectrogram hand-off, greedy decode, normalizer, word errors): each
record's wall on the host clock minus its ``EngineOutput.elapsed``, averaged
over the window's records but the profiled one."""


def read(run):
    gaps = [(r.wall_s - r.engine_s) * 1e3 for r in run.records if not r.profiled]
    return sum(gaps) / len(gaps) if gaps else None
