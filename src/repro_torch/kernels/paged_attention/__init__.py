"""Paged-KV decode attention: block-table gather through a global page
pool (the serve engine's ``kv_backend="paged"`` decode)."""

from .ops import paged_attention, paged_attention_fwd, split_pages
from .ref import (gather_pages, paged_attention_ref,
                  paged_attention_split_ref, write_token_to_pages)

__all__ = ["paged_attention", "paged_attention_fwd", "paged_attention_ref",
           "paged_attention_split_ref", "split_pages", "gather_pages",
           "write_token_to_pages"]
