"""Input pipeline of the PyTorch port: memory-mapped token shards
(``tokens.py``) and image/label array shards (``arrays.py``), and the
deterministic, prefetched step->batch loaders (``loader.py``).  Copies of
the JAX package's jax-free modules, so that the port imports nothing of
that package."""

from container_engine_accelerators_tpu_torch.data.arrays import (  # noqa: F401
    ArrayShardReader,
    write_array_shards,
)
from container_engine_accelerators_tpu_torch.data.loader import (  # noqa: F401
    ImageBatchLoader,
    TokenBatchLoader,
)
from container_engine_accelerators_tpu_torch.data.tokens import (  # noqa: F401
    TokenShardReader,
    write_token_shards,
)
