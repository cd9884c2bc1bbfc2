"""Streaming rolling-window clustering service (DESIGN.md §10), the port
of ``repro.stream``.

Ticks arrive one (n,) observation at a time and the Pearson similarity
of the rolling window is kept incrementally in O(n²) per tick
(``window``); clustering requests are micro-batched into bucketed
``cluster_batch`` calls (``scheduler``) and results cached by content
hash with warm-start reuse across consecutive windows (``cache``).
``service`` ties the parts into the ``ClusterService`` façade, and
``admission`` is its front door (DESIGN.md §16): a bounded idempotent
queue, per-tenant token-bucket quotas and a circuit breaker with a
degraded lane.  The window's state and the clustering run on the card
unless ``device="cpu"`` is passed.
"""

from . import admission, cache, scheduler, service, window  # noqa: F401
from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        CircuitBreaker, Ticket, TokenBucket)
from .cache import ResultCache, WarmStart, content_key  # noqa: F401
from .scheduler import ClusterRequest, MicroBatcher, bucket_size  # noqa: F401
from .service import ClusterService  # noqa: F401
from .window import (WindowState, materialize, window_delta,  # noqa: F401
                     window_init, window_push, window_push_block,
                     window_similarity)
