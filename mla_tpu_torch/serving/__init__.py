"""The serving host: dynamic batching of MLAPolicy calls, led by rank 0 over
a serving mesh (lead, follow)."""

from mla_tpu_torch.serving.server import BatchingServer, QueueFull, ServeRequest, follow, lead  # noqa: F401
