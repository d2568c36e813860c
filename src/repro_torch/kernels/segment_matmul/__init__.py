"""segment_matmul: segment sums of edge values (CUDA kernel + plain
version)."""

from repro_torch.kernels.segment_matmul.kernel import (launches,
                                                       segment_matmul_cuda)
from repro_torch.kernels.segment_matmul.ops import gather_scatter, scatter_add
from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref

__all__ = ["gather_scatter", "launches", "scatter_add", "segment_matmul_cuda",
           "segment_matmul_ref"]
