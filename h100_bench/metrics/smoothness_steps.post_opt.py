"""Smoothness optimizer steps a post_opt request (both selections), from the
program's counters (utils/profiling.counters()): `smoothness.steps` over
`smoothness.runs`, times the optimizer calls a request makes. It assumes one
call per selection: two for the mix family, one for wavlm_only.

The counters run from the process's start, and a run is one process, so
this is the mean over every post_opt request of the run (set-up's, the
window's and the traced ones), not over the traced requests alone. Nothing
where the program has no such counters, or they counted nothing."""


def read(view):
    try:
        from knnsvc_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c["smoothness.steps"]:
        return None
    calls_a_request = 2 if view.config["family"] == "mix" else 1
    return c["smoothness.steps"] / c["smoothness.runs"] * calls_a_request
