"""embedding_bag: in-bag row sums (CUDA kernel + plain version)."""

from repro_torch.kernels.embedding_bag.kernel import (embedding_bag_cuda,
                                                      launches)
from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                   embedding_lookup)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_cuda", "embedding_bag_ref",
           "embedding_lookup", "launches"]
