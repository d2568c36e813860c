"""flash_decode: one-token GQA attention over a KV cache (CUDA kernel +
plain version)."""

from repro_torch.kernels.flash_decode.kernel import (flash_decode_cuda,
                                                     launches, plan)
from repro_torch.kernels.flash_decode.ops import decode_attention
from repro_torch.kernels.flash_decode.ref import (decode_attention_ref,
                                                  flash_decode_ref)

__all__ = ["decode_attention", "decode_attention_ref", "flash_decode_cuda",
           "flash_decode_ref", "launches", "plan"]
