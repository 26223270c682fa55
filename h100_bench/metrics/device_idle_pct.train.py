"""The share of the traced steps' wall time in which no operation ran on
the card."""

from h100_bench.metrics._shares import idle_pct


def read(view):
    return idle_pct(view)
