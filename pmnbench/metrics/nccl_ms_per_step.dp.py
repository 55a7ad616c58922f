"""NCCL kernels' device ms a step per rank, waiting for the other ranks
included (a collective's kernel runs until every rank has joined it)."""
from pmnbench import readers


def read(window):
    return readers.per_unit(window, readers.group_s(window, ("nccl",)))
