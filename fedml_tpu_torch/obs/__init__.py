"""fedtrace's host half, as far as the message plane needs it (port of
``fedml_tpu.obs``): the :class:`Tracer` with its spans and counters
(:mod:`.tracer`) and the fedscope trace-context propagation
(:mod:`.context`, a copy of the JAX module), both stdlib only.

Not ported, and absent here rather than stubbed: the device-carry metrics
(``carry``), federation health and its SLO rules (``health``), the
``/metrics`` endpoint (``metricsd``) and the tracer's Prometheus dump,
the serving histograms, SLO windows and canary judge, and the measured
device phases (``devicetime``).
``configure(jax_hooks=True)`` raises by name.
"""

from __future__ import annotations

from . import context  # noqa: F401  (fedscope trace-context propagation)
from .tracer import (  # noqa: F401
    Tracer,
    configure,
    get_tracer,
    trace_enabled,
    tree_nbytes,
)

__all__ = ["Tracer", "configure", "context", "get_tracer", "trace_enabled",
           "tree_nbytes"]
