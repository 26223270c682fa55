"""knnsvc_torch's streaming conversion against the JAX package's on the CPU,
as test_torch_streaming.py runs it, for wavlm_only (the single-lane carry,
concat reselection without the optimizer: test_torch_streaming.py runs the
optimizer per window) and device f0 on the windowed encoder (one Viterbi
per window)."""

import pytest

from test_torch_streaming import check_stream_against_jax, pair  # noqa: F401  (fixture)


@pytest.mark.parametrize("ckpt_type,kwargs,f0_method", [
    ("wavlm_only", dict(post_opt="no_post_opt_0.2"), "fast"),
    ("mix", dict(), "device"),
])
def test_stream_convert_chunks_matches_jax(pair, ckpt_type, kwargs, f0_method):  # noqa: F811
    check_stream_against_jax(pair, ckpt_type, kwargs, f0_method)
