"""The whole frame's share of the H100's f32 peak: the f32 operations a
frame needs (reference/work.frame_flop over the reference's counts on the
traced frames) times the measured window's frame rate, over 67 TFLOP/s,
in per cent."""

from benchmark.reference import work


def read(data):
    ws = data.get("work")
    if not ws or data.get("unit") != "frame":
        return None
    flop = sum(work.frame_flop(w, data["kind"]) for w in ws) / len(ws)
    return 100.0 * flop * data["fps"] / work.F32_FLOP_PER_S
