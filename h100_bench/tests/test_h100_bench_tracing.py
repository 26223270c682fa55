"""The port's trace probes seen by the harness: part spans (`knnsvc:<part>`)
leave every field of the reduced trace as it was, and the reader of the
smoothness counters reads a traced CPU run."""

from __future__ import annotations

import json

import pytest

from h100_bench import run
from h100_bench.harness import load_cell, reduce_trace

PAIR_CELLS = ["mix.pair_new", "mix.pair_post_opt", "wavlm_only.pair_new"]
NEW_METRICS = {"smoothness_steps.post_opt"}


def _event(eid, name, start, end, parent=None, cuda=False, annotation=False):
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    e = FunctionEvent(eid, name, thread=1, start_us=start, end_us=end,
                      device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                      is_user_annotation=annotation)
    if parent is not None:
        e.set_cpu_parent(parent)
    return e


def _request_trace(with_part: bool):
    """One request as torch.profiler records it on a card: the root span,
    a stage, its kernels launched by runtime calls (correlated by id), the
    device-side copies of the spans, and the part span `knnsvc:pos_conv`
    around the first launch when `with_part`."""
    root = _event(1, "knnsvc.convert_pair", 0, 1000)
    build = _event(2, "knnsvc.pool_build", 10, 600, root)
    part = _event(3, "knnsvc:pos_conv", 100, 300, build) if with_part else None
    events = [root, build] + ([part] if part else [])
    events += [_event(5, "cudaLaunchKernel", 150, 160, part or build),
               _event(6, "cudaLaunchKernel", 400, 410, build),
               _event(7, "knnsvc.write_wav", 800, 900, root),
               _event(5, "implicit_convolve_sgemm", 200, 260, cuda=True),
               _event(6, "sm90_xmma_gemm", 420, 500, cuda=True),
               _event(8, "knnsvc.pool_build", 200, 500, cuda=True, annotation=True)]
    if with_part:
        events.append(_event(9, "knnsvc:pos_conv", 200, 260, cuda=True, annotation=True))
    return events


def test_part_spans_leave_the_reduced_trace_as_it_was():
    fields = ("span_host_us", "span_device_us", "kernel_us", "kernel_count", "idle_gaps",
              "busy_s", "n_device_events")
    without = reduce_trace(_request_trace(False), window_s=1e-3)
    with_part = reduce_trace(_request_trace(True), window_s=1e-3)
    assert {f: getattr(with_part, f) for f in fields} == {f: getattr(without, f) for f in fields}
    assert with_part.span_device_us == {"pool_build": 140.0}
    assert not any(k.startswith("knnsvc") for k, _ in with_part.device_ops())
    assert with_part.busy_s == pytest.approx(140e-6)


@pytest.mark.parametrize("workload", PAIR_CELLS)
def test_traced_pair_cell_reads_the_new_metrics(capsys, tiny_root, workload):
    rc = run.main(["--workload", workload, "--seed", "4_000_000_007", "--seconds", "0.5",
                   "--trace", "1"], root=str(tiny_root), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    cell = load_cell(workload, str(tiny_root))
    listed = {m["name"] for m in cell.per_layer} & NEW_METRICS
    if workload == "mix.pair_post_opt":
        assert listed == {"smoothness_steps.post_opt"}
        assert result["metrics"]["smoothness_steps.post_opt"]["value"] > 0
    else:
        assert listed == set()
        assert "smoothness_steps.post_opt" not in result["metrics"]
