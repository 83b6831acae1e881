"""ray_tpu_torch.serve — the replica that hosts a deployment's callable,
with request batching (``batch``) and model multiplexing
(``multiplexed``) inside it.

The controller, router and HTTP proxy of ``ray_tpu.serve`` are not
ported yet (ROADMAP); a caller constructs a ``Replica`` and sends it
requests directly.
"""

from ray_tpu_torch.serve.batching import batch, batch_sizes_of
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.replica import Replica

__all__ = ["Replica", "batch", "batch_sizes_of", "get_multiplexed_model_id",
           "multiplexed"]
