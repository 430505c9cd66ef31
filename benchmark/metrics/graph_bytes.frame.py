"""Megabytes (1e6 bytes) that one graph call of the program copies into
its static inputs and clones out of its outputs, a frame: from the
program's records (benchmark/program.py)."""

from benchmark import program


def read(data):
    got = program.per_call(data, "frame")
    return None if got is None else got[1] * 1e-6
