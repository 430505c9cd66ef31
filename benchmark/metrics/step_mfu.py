"""The whole train step's share of the H100's f32 peak: the f32 operations
a step needs (reference/work.step_flop over the reference's counts on the
traced steps' views) times the measured window's step rate, over 67
TFLOP/s, in per cent."""

from benchmark.reference import work


def read(data):
    ws = data.get("work")
    if not ws or data.get("unit") != "step":
        return None
    flop = sum(work.step_flop(w, data["kind"]) for w in ws) / len(ws)
    return 100.0 * flop * data["steps_per_s"] / work.F32_FLOP_PER_S
