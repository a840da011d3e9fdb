"""Decode caches: full KV, ring (windowed) KV, MLA's compressed cache and
the recurrent mixers' states.

Cache layout is per segment (see ``config.segments``): every leaf carries a
leading ``L_seg`` axis, so layer ``l`` of a segment reads ``leaf[l]``.  One
integer ``length`` (tokens written so far) is carried beside the caches;
slot occupancy and absolute positions derive from it.

Ring semantics (windowed attention): slot s of a T-slot cache holds the
most recent position p < length with p % T == s.

The recurrent mixers keep a fixed-size state whatever ``cache_len`` is:
RWKV6 its (H, D, D) float32 state and the last token's inputs to the
time mix (``prev_mix``) and the channel mix (``prev_cm``); RG-LRU its
float32 carry ``h`` and the conv's last ``conv_width - 1`` inputs.

Unlike the JAX package's functional caches, the port writes tokens into
the cache in place: a decode step then moves one token's K/V per layer
instead of copying every layer's cache.

Under a mesh an attention cache's T slots may be split over the model
axis, ``T / tp`` a rank (JAX's layout): ``write_token`` and
``fill_cache`` take the whole cache's ``num_slots`` and this rank's
``rank`` on that axis and write only the slots the rank holds.
"""
from __future__ import annotations

import torch

__all__ = ["LocalCaches", "fill_cache", "init_segment_cache",
           "ring_positions", "write_token"]


class LocalCaches(list):
    """Decode caches, one dict per segment, with the whole cache's length
    (``cache_len``) and batch: under a mesh a rank's part, whose blocks
    need them to place slots and rows."""

    def __init__(self, segs, cache_len: int, batch: int):
        super().__init__(segs)
        self.cache_len, self.batch = cache_len, batch


def ring_positions(length: int, num_slots: int, device=None):
    """(num_slots,) int32 absolute position per cache slot (-1 if never
    written), ``length`` tokens written so far.  Works for full caches too
    (where length <= num_slots and slot s holds position s)."""
    s = torch.arange(num_slots, dtype=torch.int32, device=device)
    last = length - 1 - torch.remainder(length - 1 - s, num_slots)
    held = s if length <= num_slots else last
    return torch.where(s < min(length, num_slots), held,
                       torch.full_like(s, -1))


def init_segment_cache(kind, n_layers: int, batch: int, cache_len: int,
                       cfg, dtype, device=None):
    """Zero cache for one segment.  kind = (mixer_kind, ffn_kind)."""
    mixer = kind[0]
    if mixer in ("full", "swa", "local"):
        T = cache_len if mixer == "full" else min(cfg.window, cache_len)
        shape = (n_layers, batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mixer == "mla":  # the compressed latent and the shared rope key
        return {"ckv": torch.zeros((n_layers, batch, cache_len,
                                    cfg.mla_kv_lora), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((n_layers, batch, cache_len,
                                      cfg.mla_rope_dim), dtype=dtype,
                                     device=device)}
    if mixer == "rwkv6":
        H, D = cfg.num_heads, cfg.rwkv_head_dim
        return {"state": torch.zeros((n_layers, batch, H, D, D),
                                     dtype=torch.float32, device=device),
                "prev_mix": torch.zeros((n_layers, batch, cfg.d_model),
                                        dtype=dtype, device=device),
                "prev_cm": torch.zeros((n_layers, batch, cfg.d_model),
                                       dtype=dtype, device=device)}
    if mixer == "rglru":
        W = cfg.lru_width
        return {"h": torch.zeros((n_layers, batch, W), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, W),
                                    dtype=dtype, device=device)}
    raise ValueError(f"unknown mixer kind {mixer!r}")


def write_token(cache_kv, new_kv, length: int, num_slots: int | None = None,
                rank: int = 0):
    """Write one token's (B, 1, ...) entry at ring slot ``length % T`` of
    a cache of T = ``num_slots`` slots (default: all of ``cache_kv`` (B,
    T, ...)), in place, if this rank holds that slot; returns
    ``cache_kv``."""
    t_loc = cache_kv.shape[1]
    T = num_slots or t_loc
    slot = length % T
    if t_loc == T or slot // t_loc == rank:
        cache_kv[:, slot % t_loc] = new_kv[:, 0]
    return cache_kv


def fill_cache(cache_kv, new_kv, window: int, num_slots: int | None = None,
               rank: int = 0):
    """A prefill's write of a fresh (zero) cache from the whole (B, S, ...)
    K/V (or latents): with a ``window`` and S >= T the last T tokens rolled
    into ring order, else the S tokens from slot 0; this rank's slots of
    them (T and ``rank`` as in :func:`write_token`)."""
    t_loc = cache_kv.shape[1]
    T = num_slots or t_loc
    S = new_kv.shape[1]
    if window and S >= T:
        new_kv = torch.roll(new_kv[:, S - T:], S % T, dims=1)
    lo = rank * t_loc if t_loc != T else 0
    part = new_kv[:, lo:lo + t_loc]
    cache_kv[:, :part.shape[1]] = part
    return cache_kv
