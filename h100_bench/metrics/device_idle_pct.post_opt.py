"""The share of the traced stretch in which no operation ran on the card."""

from h100_bench.metrics._shares import idle_pct


def read(view):
    return idle_pct(view)
