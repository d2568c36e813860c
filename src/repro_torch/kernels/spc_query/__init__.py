"""spc_query: batched SPC-Index pair queries (CUDA kernel + plain version)."""

from repro_torch.kernels.spc_query.kernel import (launches, plan,
                                                  spc_query_cuda,
                                                  spc_query_index_cuda)
from repro_torch.kernels.spc_query.ops import (exact_query_batch, prep_rows,
                                               spc_query, wrap_ids)
from repro_torch.kernels.spc_query.ref import spc_query_ref

__all__ = ["exact_query_batch", "launches", "plan", "prep_rows", "spc_query",
           "spc_query_cuda", "spc_query_index_cuda", "spc_query_ref",
           "wrap_ids"]
