"""The attention kernel's share of its roofline (counts/bounds.py) over
the traced requests' launches."""

from h100_bench.metrics._shares import attention_roofline_pct


def read(view):
    return attention_roofline_pct(view)
