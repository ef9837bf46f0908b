"""Profiler tracing — the observability the reference never had.

The reference's only instrumentation is an `indicatif` progress bar
(renderer/imager.rs:52-57); there are no traces, timelines, or
throughput counters anywhere (SURVEY.md §5). Here every render path is a
jitted XLA program, so the native tool is the JAX/XLA profiler: one
context manager wraps any region in a trace that captures the device
timeline (kernel launches, Pallas kernels, memory transfers, host gaps),
viewable with TensorBoard's profile plugin or Perfetto (the trace is a
standard `.xplane.pb` under `<dir>/plugins/profile/...`).

Usage (library):

    from tinyraytracer_tpu.utils.profiling import trace
    with trace("/tmp/rt_profile"):
        renderer.render(camera, world)

CLI: `python -m tinyraytracer_tpu --profile /tmp/rt_profile` traces the
whole render. `annotate(name)` adds named sub-regions (host-side spans)
to the timeline.
"""

from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a JAX profiler trace of the enclosed region into log_dir."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host-side span; nests inside an active trace()."""
    import jax

    return jax.profiler.TraceAnnotation(name)
