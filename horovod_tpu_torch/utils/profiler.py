"""torch.profiler bridge for the collective spans.

Port of ``horovod_tpu/utils/profiler.py`` (reference analog: the
reference's NVTX hooks put its timeline's spans into the vendor
profiler, so one capture shows framework activity next to kernel
activity).  As in the JAX package, this module is a thin alias over the
:mod:`horovod_tpu_torch.trace` recorder: one instrumentation point (the
collectives' submission and completion, ``ops/collective_ops.py``)
produces both views —

  * the profiler range, named ``hvd_tpu::<name>::<activity>``
    (``torch.profiler.record_function``; the JAX package's lands in an
    XPlane capture under the same name), beside the NCCL kernels it
    launched, and
  * a ring-buffer record at the catalogued ``collective.enqueue`` /
    ``collective.exec`` site, which the ``/trace`` Chrome export and
    the flight recorder serve.

The activity string is derived from the trace site at one place below.
``HVD_TPU_PROFILER_BRIDGE=0`` drops the profiler half,
``HVD_TPU_TRACE=0`` the ring half.

Capture recipe (CPU or card)::

    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ... training steps / hvd.allreduce calls ...
    prof.export_chrome_trace("/tmp/hvd-trace.json")  # ui.perfetto.dev
"""

from __future__ import annotations

import os

from .. import trace as _trace

_BRIDGE = os.environ.get("HVD_TPU_PROFILER_BRIDGE", "1") != "0"


def span(name: str, activity: str):
    """Context manager for one framework span: the profiler gets
    ``hvd_tpu::<name>::<activity>``, the trace ring gets the catalogued
    site for the activity (ENQUEUE -> collective.enqueue, anything else
    -> collective.exec) with the collective's name as an arg."""
    xname = f"hvd_tpu::{name}::{activity}" if _BRIDGE else False
    if activity == "ENQUEUE":
        return _trace.span("collective.enqueue", _xname=xname, name=name)
    return _trace.span("collective.exec", _xname=xname, name=name)


def device_kernels(prof) -> list:
    """The device work of a ``torch.profiler`` capture: its CUDA events
    less the ranges the profiler mirrors onto the device timeline from
    host annotations (the spans above among them), which cover kernels
    rather than being any."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("hvd_tpu::")]
