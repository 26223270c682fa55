"""The concat-cost kernel's share of its roofline (counts/bounds.py) over
the traced requests' launches."""

from h100_bench.metrics._shares import concat_roofline_pct


def read(view):
    return concat_roofline_pct(view)
