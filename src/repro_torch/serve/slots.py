"""Slot insert for the dense engine's chunked admission, and cache
re-encoding across a ``kv_quant`` variant hot-swap. Counterpart of the JAX
package's ``serve/slots.py``: attention rings and Mamba state rows."""
from __future__ import annotations

import torch

from repro_torch.models.attention import (KVCache, PagedKVCache,
                                          dequantize_kv, quantize_kv)
from repro_torch.models.mamba2 import MambaCache


def insert_request(batched, single, slot: int):
    """Copy a prefilled one-request cache tree into batch row ``slot``.

    Both trees are in the ``lm.init_caches`` layout (leaves stacked over
    layer groups, batch at axis 1). Each ring is rotated by the difference
    of the cursors, so the request's entries sit in the slots a
    token-by-token warmup ending at the engine's cursor would have filled:
    later decode writes land after them and reach a prompt entry only when
    the ring wraps. The batched cursor, shared by every slot, is kept. The
    rotation index is made on the device (no host sync). A ``MambaCache``'s
    rows (conv histories and state) are copied into row ``slot`` as they
    are. Updates ``batched`` in place and returns it."""
    for bc, sc in zip(batched, single):
        if isinstance(bc, MambaCache):
            for b, s in zip(bc, sc):
                b[:, slot].copy_(s[:, 0])
            continue
        assert isinstance(bc, KVCache), type(bc)
        W = bc.k.shape[2]
        shift = (bc.cursor[0].long() - sc.cursor[0].long()) % W
        # rolled[w] = x[(w - shift) % W], as jnp.roll(x, shift)
        src = (torch.arange(W, device=bc.k.device) - shift) % W
        for b, s in ((bc.k, sc.k), (bc.v, sc.v), (bc.pos, sc.pos)):
            b[:, slot].copy_(s[:, 0].index_select(1, src))
    return batched


def convert_caches(caches, kv_quant: bool, dtype=torch.float32):
    """int8 -> ``dtype`` when leaving a quantized variant, ``dtype`` -> int8
    when entering one (the shared static ``KV_SCALE``, the same rounding
    decode and chunked prefill apply). Dense rings convert whole; in the
    page pool every physical page converts, shared prefix pages included.
    Positions, cursors, block tables and Mamba rows carry over unchanged,
    so decode continues mid-request across the swap."""
    def one(c):
        if isinstance(c, KVCache):
            k, v = c.k, c.v
        elif isinstance(c, PagedKVCache):
            k, v = c.kp, c.vp
        else:
            return c
        if kv_quant and k.dtype != torch.int8:
            k, v = quantize_kv(k), quantize_kv(v)
        elif not kv_quant and k.dtype == torch.int8:
            k, v = dequantize_kv(k, dtype), dequantize_kv(v, dtype)
        else:
            return c
        if isinstance(c, KVCache):
            return c._replace(k=k, v=v)
        return c._replace(kp=k, vp=v)

    return tuple(one(c) for c in caches)
