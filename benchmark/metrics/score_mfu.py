"""The whole score pass's share of the H100's f32 peak: the f32
operations a pass needs (reference/score.pass_flop over the reference's
counts on the pass's views: projection and SH colour of the visible
rows, the candidates' OBB test, kernel 8's walk, the max over views and
the cut) times the measured window's pass rate, over 67 TFLOP/s, in per
cent."""

from benchmark.reference import score, work


def read(data):
    ws = data.get("work")
    if not ws or data.get("kind") != "score":
        return None
    flop = score.pass_flop(ws, data["rows"])
    return 100.0 * flop * data["steps_per_s"] / work.F32_FLOP_PER_S
