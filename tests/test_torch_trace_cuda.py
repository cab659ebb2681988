"""The span log (``orbslamm_tpu_torch/utils/trace.py``) on the card: its
entries and the device trace share one clock. A ``stage`` entry meets its
``record_function`` event within 50 us at both ends, and the kernels
launched inside it run on the device between the entry's start and end
(the stage waits for them). Every test here needs an NVIDIA GPU and skips
without one; the file imports nothing of JAX (run it on the card with
``python -m pytest --noconftest -m cuda -q tests/test_torch_trace_cuda.py``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orbslamm_tpu_torch.utils import trace as ttrace

NAME = "orb.extract"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device trace's clock)")
    return torch.device("cuda")


def _session(x, n):
    tr = ttrace.get_tracer()
    tr.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with ttrace.stage(NAME, i=i):
                x @ x
                torch.cuda.synchronize()
    host, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.name() == NAME:  # the range, and its copy on the device's timeline
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(span)
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append(span)
    return [e for e in tr.spans() if e.name == NAME], sorted(host), sorted(kernels)


@pytest.mark.cuda
def test_stage_entries_share_the_device_trace_clock():
    dev = _card()
    x = torch.randn(512, 512, device=dev)
    _session(x, 3)  # the profiler's and cuBLAS's first calls
    log, host, kernels = _session(x, 20)
    assert len(log) == len(host) == 20 and kernels
    mine = sorted((e.start_ns, e.end_ns) for e in log)
    gaps = np.asarray([[abs(s - ps), abs(pe - e)] for (s, e), (ps, pe) in zip(mine, host)]) / 1e3
    assert gaps.max() < 5000, gaps.max()
    assert (gaps <= 50).mean() >= 0.9, np.sort(gaps.ravel())[-10:]
    for s, e in mine:  # the stage's kernels start after its entry opens, end before it closes
        inside = [(ks, ke) for ks, ke in kernels if s <= ks and ke <= e]
        assert inside, (s, e, [k for k in kernels if k[1] > s - 10**6 and k[0] < e + 10**6])
    for ks, ke in kernels:
        assert any(s <= ks and ke <= e for s, e in mine), (ks, ke)
