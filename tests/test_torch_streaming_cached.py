"""knnsvc_torch's streaming conversion through the cached K/V encoder
(encoder='cached': each chunk encodes its new frames over the cache, host
f0 of the window) against the JAX package's on the CPU, as
test_torch_streaming.py runs it, with the concat-cost reselection (the
carry across chunks; no_post_opt_0.2: test_torch_streaming.py runs the
optimizer per window) and without."""

import pytest

from test_torch_streaming import check_stream_against_jax, pair  # noqa: F401  (fixture)


@pytest.mark.parametrize("post_opt", ["no_post_opt_0.2", "no_post_opt"])
def test_cached_stream_matches_jax(pair, post_opt):  # noqa: F811
    check_stream_against_jax(pair, "mix", dict(encoder="cached", post_opt=post_opt), "fast")
