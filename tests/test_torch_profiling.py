"""The port's profiling hooks (``gymrl_tpu_torch/utils/profiling.py``) on
the CPU: ``trace`` writes a Chrome trace that Perfetto and
``chrome://tracing`` open; on the CPU it holds the host's ops and no device
kernel. The program's spans are ``test_torch_tracing.py``'s.
"""

import json

import torch

from gymrl_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), device="cpu") as prof:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    path = logdir / "trace.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
    stats = profiling.kernel_stats(prof)
    assert stats == {"kernels": 0, "kernel_ms": 0.0, "busy_ms": 0.0}


def test_kernel_stats_counts_device_events_only():
    """Copies and memsets are no kernels; overlapping kernels count once
    toward the busy time."""

    class Ev:
        def __init__(self, name, start, end, dev=torch.autograd.DeviceType.CUDA):
            self._n, self._s, self._e, self._d = name, start, end, dev

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def end_ns(self):
            return self._e

        def device_type(self):
            return self._d

    class Results:
        def events(self):
            return [Ev("gemm", 0, 1_000_000), Ev("tanh", 500_000, 2_000_000),
                    Ev("Memcpy HtoD", 3_000_000, 9_000_000),
                    Ev("aten::mm", 0, 9_000_000, torch.autograd.DeviceType.CPU),
                    Ev("relu", 4_000_000, 5_000_000)]

    class Prof:
        class profiler:
            kineto_results = Results()

    assert profiling.kernel_stats(Prof()) == {"kernels": 3, "kernel_ms": 3.5, "busy_ms": 3.0}
