"""Cache re-encoding across a ``kv_quant`` variant hot-swap: the paged branch
of the JAX package's ``serve/slots.convert_caches``."""
from __future__ import annotations

import torch

from repro_torch.models.attention import (PagedKVCache, dequantize_kv,
                                          quantize_kv)


def convert_caches(caches, kv_quant: bool, dtype=torch.float32):
    """int8 -> ``dtype`` when leaving a quantized variant, ``dtype`` -> int8
    when entering one (the shared static ``KV_SCALE``, the same rounding
    decode and chunked prefill apply). Every physical page converts, shared
    prefix pages included; positions and block tables carry over, so decode
    continues mid-request across the swap."""
    def one(c):
        if kv_quant and c.kp.dtype != torch.int8:
            return c._replace(kp=quantize_kv(c.kp), vp=quantize_kv(c.vp))
        if not kv_quant and c.kp.dtype == torch.int8:
            return c._replace(kp=dequantize_kv(c.kp, dtype),
                              vp=dequantize_kv(c.vp, dtype))
        return c

    return tuple(one(c) if isinstance(c, PagedKVCache) else c
                 for c in caches)
