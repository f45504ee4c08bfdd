"""Token input pipeline of the PyTorch port: memory-mapped token shards
(``tokens.py``) and the deterministic, prefetched step->batch loader
(``loader.py``).  Copies of the JAX package's jax-free modules, so that
the port imports nothing of that package."""

from container_engine_accelerators_tpu_torch.data.loader import (  # noqa: F401
    TokenBatchLoader,
)
from container_engine_accelerators_tpu_torch.data.tokens import (  # noqa: F401
    TokenShardReader,
    write_token_shards,
)
