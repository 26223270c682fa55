"""The relative-key attention's share of its roofline: the summed bound
(counts/w2vbert.py: the attention kernel's full-bias entry at each layer
run on each 30-s chunk of both files) over the summed kernel time of the
traced requests' full-bias launches. Nothing when those launches are not
the layers the program counted over the traced requests
(`w2vbert.layers_run`), or when each request's layers run are not the
configuration's layers on every chunk."""

import re

from h100_bench.counts.w2vbert import rel_attention_bound_ms

# the full-bias instances of the kernel, gated_bias_attention_kernel<PASSES,
# true, ...>, by their demangled or their mangled name
FULL_BIAS = re.compile(r"gated_bias_attention_kernel(<\d+, true|ILi\d+ELb1E)")


def read(view):
    if not view.has_device or not view.units:
        return None
    w, layers = view.config["w2vbert"], view.config["encoder_layers_run"]
    kernels = [k for k in view.kernel_us if FULL_BIAS.search(k)]
    kernel_ms = sum(view.kernel_us[k] for k in kernels) / 1e3
    launches = sum(view.kernel_count[k] for k in kernels)
    chunks = [[T for T in u["src_chunks"] + u["tgt_chunks"]] for u in view.units]
    if kernel_ms <= 0 or any(u.get("w2vbert_layers_run") != layers * len(c)
                             for u, c in zip(view.units, chunks)) \
            or launches != sum(u["w2vbert_layers_run"] for u in view.units):
        return None
    bound = sum(layers * rel_attention_bound_ms(w, T)[0] for c in chunks for T in c)
    return 100.0 * bound / kernel_ms
