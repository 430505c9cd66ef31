"""Megabytes (1e6 bytes) that one graph call of the program copies into
its static inputs and clones out of its outputs, a step: from the
program's records (benchmark/program.py)."""

from benchmark import program


def read(data):
    got = program.per_call(data, "step")
    return None if got is None else got[1] * 1e-6
