"""The serving host: dynamic batching of MLAPolicy calls."""

from mla_tpu_torch.serving.server import BatchingServer, QueueFull, ServeRequest  # noqa: F401
