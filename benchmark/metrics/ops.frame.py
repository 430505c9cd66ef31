"""Device operations (kernels, copies, sets) that one graph call of the
program launches, a frame: the captured graphs' node counts from the
program's records (benchmark/program.py)."""

from benchmark import program


def read(data):
    got = program.per_call(data, "frame")
    return None if got is None else got[0]
